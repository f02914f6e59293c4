// covar_xtx: C[f, g] = sum over rows r of w[r] * x[r, f] * x[r, g], for a
// row-major (n, F) float32 x and an (n,) float32 w; C is (F, F) float32.
//
// Replaces the TPU kernel covar_xtx_pallas (src/repro/kernels/covar_xtx.py:41,
// body _covar_kernel at :24), which streams (bm, F) row tiles through VMEM
// and adds (w * x)^T x into an (F, F) accumulator pinned in VMEM across the
// whole row grid: one MXU product per row tile.
//
// Bound on the H100: the n (F + 1) * 4 bytes of x and w, read once (0.085 ms
// at F = 70 and 0.171 ms at F = 142 for 10^6 rows, at 3.35 TB/s); the
// products of the upper triangle, three TF32 products each, take less at
// 495 TFLOP/s.  The earlier kernel (32 x 32 tile pairs, float32 FMAs in
// 4 x 4 register tiles) lost to that bound on four counts: its tiles padded
// F = 70 to 96 (2.5x the FMAs of the triangle), two 16-byte shared loads
// fed 16 FMAs, every tile pair staged its own rows (each row requested 12
// times from L2 at F = 70), synchronously, and the tensor cores sat idle.
// This design:
//
//   * the triangle is cut into pieces of 64 rows (a warpgroup's wgmma M)
//     by 48 columns (N), starting on the diagonal of each 64-row band:
//     F = 70 is (0-63 x 0-95), (64-127 x 64-111), three pieces; F = 142 is
//     six.  Three warpgroups take a block's pieces in turn, at most two
//     each (a warpgroup short of a piece repeats one: 4 pieces at F = 99
//     cost 6).  Up to F = 144 (six pieces) one block owns the whole padded
//     triangle for its row chunk, so a row is staged once a block; past
//     it, the grid's second axis runs groups of at most six consecutive
//     pieces, each block staging its chunk's rows whole and splitting only
//     its group's columns (F = 173, TPC-DS's covar, is two groups);
//   * rows arrive a step of kRows at a time (48 where two ring stages of 48
//     rows fit, F up to 96; else 32, up to F = 192; else 16: the split's
//     task registers hold F columns in the longer steps) through a ring of up to four stages of 16-byte cp.async (4-byte
//     at a span's unaligned ends: x and w may start at any float, and a
//     280- or 568-byte row stride admits no 2-d TMA box), kStages - 1 steps
//     ahead of the products;
//   * all threads split a step into TF32 high and low parts,
//     a = hi + lo with hi = tf32(a) and lo = tf32(a - hi) (rounded to nearest),
//     for A = w * x and for B = x, and write them K-major (the row axis
//     contiguous, 8 x 16-byte core matrices, no swizzle): wgmma takes .tf32
//     operands K-major only, and the staged rows are MN-major, so the split
//     is where the transpose happens.  The split tiles are double-buffered:
//     a step is split while the tensor cores multiply the previous one;
//   * products on the tensor cores in 3xTF32: each piece accumulates
//     hi.lo + lo.hi + hi.hi with wgmma m64n48k8, A and B from shared memory,
//     which keeps float32-class accuracy (the dropped lo.lo is 2^-22 of a
//     product; 1xTF32 would round each product at 2^-11);
//   * two levels of sums: the wgmma accumulators take one step of rows and
//     are then added into float32 running sums in registers.  The tensor
//     cores' own sums lose more than float32 adds: left to take a whole
//     chunk they read 7.7e-5 of sum|terms| off the plain version at F = 70,
//     against 1.5e-6 promoted every 128 rows and 7.6e-7 every 32
//     (tools/scan_ablation.py on an H100), and the gathered features repeat
//     (a dimension row's value recurs in every fact row that joins it).
//     Promoting every step rather than every two cost 2% of the time there
//     and halved the error on repeated values;
//   * each block writes its pieces to scratch, and a second kernel sums the
//     chunks of every upper-triangle entry in double, in chunk order, rounds
//     once to float and writes C[i, j] and C[j, i].  There are no atomics:
//     two runs give the same bits, C is exactly symmetric, and an
//     integer-valued entry (the count C[0, 0] of a 0/1 column) is exact
//     while a chunk's partial stays below 2^24, which the wrapper's chunk
//     cap of 2^16 rows guarantees for 0/1 data.
//
// The geometry (pieces, groups, step rows, ring stages, shared memory,
// chunks) is mirrored in covar_xtx.py.  No output is allocated here: the caller passes
// scratch, output and the stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace xtx {

constexpr int kWarpgroups = 3;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kM = 64;                      // rows of a piece (wgmma M)
constexpr int kN = 48;                      // columns of a piece (wgmma N)
constexpr int kAcc = kN / 2;                // accumulator floats a thread
constexpr int kMaxPieces = 2;               // pieces a warpgroup
constexpr int kGroup = kWarpgroups * kMaxPieces;  // pieces a block
constexpr int kPromote = 1;                 // steps between promotions
constexpr int kMaxOperandRows = 368;        // A and B rows of F = 144's one group
constexpr int kLongStepFeatures = 96;       // the widest F of 48-row steps
constexpr int kStepFeatures = 192;          // the widest F of 32-row steps
constexpr uint32_t kLBO = 128;              // next core matrix along K

__host__ __device__ inline int band_pieces(int f, int band) {
  return (f - kM * band + kN - 1) / kN;
}

__host__ __device__ inline int n_pieces(int f) {
  int p = 0;
  for (int band = 0; kM * band < f; ++band) p += band_pieces(f, band);
  return p;
}

// Rows of the A operand (whole 64-row bands) and of the B operand (up to
// the last piece's last column) in shared memory, for the whole triangle.
__host__ __device__ inline int a_rows(int f) { return (f + kM - 1) / kM * kM; }

__host__ __device__ inline int b_rows(int f) {
  int rows = 0;
  for (int band = 0; kM * band < f; ++band) {
    const int end = kM * band + kN * band_pieces(f, band);
    rows = end > rows ? end : rows;
  }
  return rows;
}

// The pieces a block multiplies, first .. first + count - 1 in band order,
// and the columns of C its operands hold: A rows a_lo .. a_lo + a_n - 1
// (whole bands), B rows b_lo .. b_lo + b_n - 1.  Pieces join a group in
// order while it holds fewer than kGroup and its operands stay within
// kMaxOperandRows rows, so F <= 144 is one group.
struct Group {
  int first, count, a_lo, a_n, b_lo, b_n;
};

// Group y of the grid (none for y < 0); the number of groups goes to *n.
__host__ __device__ inline Group group_of(int f, int y, int* n = nullptr) {
  Group g{0, 0, 0, 0, 0, 0}, found{0, 0, 0, 0, 0, 0};
  int index = 0, groups = 0;
  for (int band = 0; kM * band < f; ++band)
    for (int j = 0; j < band_pieces(f, band); ++j, ++index) {
      const int m0 = kM * band, n0 = m0 + kN * j;
      const int b_lo = g.b_lo < n0 ? g.b_lo : n0;
      const int b_hi = g.b_lo + g.b_n > n0 + kN ? g.b_lo + g.b_n : n0 + kN;
      const int a_n = m0 + kM - g.a_lo;
      if (g.count > 0 && g.count < kGroup && a_n + b_hi - b_lo <= kMaxOperandRows) {
        g = Group{g.first, g.count + 1, g.a_lo, a_n, b_lo, b_hi - b_lo};
        continue;
      }
      if (g.count > 0 && groups++ == y) found = g;
      g = Group{index, 1, m0, kM, n0, kN};
    }
  if (groups++ == y) found = g;
  if (n) *n = groups;
  return found;
}

__host__ __device__ inline int n_groups(int f) {
  int n = 0;
  group_of(f, -1, &n);
  return n;
}

// The most operand rows (A and B) of a group of the grid.
__host__ __device__ inline int operand_rows(int f) {
  int rows = 0;
  for (int y = 0; y < n_groups(f); ++y) {
    const Group g = group_of(f, y);
    rows = g.a_n + g.b_n > rows ? g.a_n + g.b_n : rows;
  }
  return rows;
}

// Floats of a ring stage: `rows` rows of x behind up to 3 floats of
// alignment shift, rounded up to 4, then `rows` of w.
__host__ __device__ inline int raw_stage_floats(int f, int rows) {
  return (rows * f + 3 + 3) / 4 * 4 + rows;
}

// Two split buffers: A and B, high and low parts, a float a staged row.
__host__ __device__ inline int split_bytes(int f, int rows) {
  return 2 * 2 * operand_rows(f) * rows * 4;
}

__host__ __device__ inline int smem_bytes(int f, int stages, int rows) {
  return split_bytes(f, rows) + stages * raw_stage_floats(f, rows) * 4;
}

// Piece g: its first row m0 and first column n0.
__device__ __forceinline__ void piece_origin(int f, int g, int* m0, int* n0) {
  for (int band = 0; kM * band < f; ++band) {
    const int c = band_pieces(f, band);
    if (g < c) {
      *m0 = kM * band;
      *n0 = kM * band + kN * g;
      return;
    }
    g -= c;
  }
  *m0 = *n0 = 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shift (0-3 floats) that puts src's 16-byte alignment on a 16-byte
// aligned destination.
__device__ __forceinline__ int align_shift(const float* src) {
  return (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

// count floats from src to dst + align_shift(src) (dst 16-byte aligned):
// the ends 4 bytes at a time, the rest 16.
__device__ __forceinline__ void copy_span(float* dst, const float* src, int count) {
  dst += align_shift(src);
  int head = (4 - align_shift(src)) & 3;
  head = head < count ? head : count;
  const int body = (count - head) / 4;
  const int tail = head + 4 * body;
  for (int i = threadIdx.x; i < head; i += kThreads) cp_async4(dst + i, src + i);
  for (int i = threadIdx.x; i < body; i += kThreads)
    cp_async16(dst + head + 4 * i, src + head + 4 * i);
  for (int i = tail + threadIdx.x; i < count; i += kThreads) cp_async4(dst + i, src + i);
}

// v rounded to TF32 (10 explicit mantissa bits), to nearest, ties away
// from zero, as cvt.rna.tf32.f32 rounds: two integer operations, where the
// conversion cost about 7% of the kernel at F = 70 on an H100
__device__ __forceinline__ float tf32(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xFFFFE000u);
}

// A K-major operand in shared memory without swizzle: 8-row x 16-byte core
// matrices, the next one along K kLBO bytes on, along M or N sbo bytes on.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(kLBO >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of registers an in-flight wgmma
// reads or writes across this point.
__device__ __forceinline__ void fence_regs(float (&r)[kMaxPieces][kAcc]) {
#pragma unroll
  for (int p = 0; p < kMaxPieces; ++p)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(r[p][i])::"memory");
}

// d (+)= a b: m64n48k8, tf32 inputs, float32 accumulators, a and b K-major
// in shared memory
__device__ __forceinline__ void wgmma_n48(float (&d)[kAcc], uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Block (chunk, group): the group's pieces over the chunk's rows.  Shared
// memory: two split buffers (A hi, A lo, B hi, B lo, each its rows x kRows
// floats K-major), then the ring of kStages raw stages of kRows rows.
template <int kStages, int kRows>
__global__ void __launch_bounds__(kThreads, 1)
partial_kernel(const float* __restrict__ x, const float* __restrict__ w, int64_t n,
               int f, int64_t chunk_rows, float* __restrict__ scratch) {
  constexpr uint32_t kSBO = kRows / 4 * 128;  // next 8 rows along M or N
  constexpr uint32_t kOperandRowBytes = kRows * 4;
  // the most columns a block splits: F itself in 48- and 32-row steps,
  // else its operand rows at most
  constexpr int kMaxCols = kRows == 48   ? kLongStepFeatures
                           : kRows == 32 ? kStepFeatures
                                         : kMaxOperandRows;
  constexpr int kMaxTasks = (kMaxCols * (kRows / 4) + kThreads - 1) / kThreads;
  extern __shared__ __align__(128) float smem[];
  const int tid = threadIdx.x;
  const Group grp = group_of(f, blockIdx.y);
  const int ma = grp.a_n, mb = grp.b_n;
  const int buf_floats = 2 * (ma + mb) * kRows;
  float* ring = smem + 2 * buf_floats;
  const int raw_floats = raw_stage_floats(f, kRows);
  const int w_off = raw_floats - kRows;

  // padding rows of the operands stay zero: the split writes rows < f only
  for (int i = tid; i < 2 * buf_floats / 4; i += kThreads)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int64_t r0 = (int64_t)blockIdx.x * chunk_rows;
  const int64_t r1 = r0 + chunk_rows < n ? r0 + chunk_rows : n;
  const int n_stages = r1 > r0 ? (int)((r1 - r0 + kRows - 1) / kRows) : 0;

  auto stage_rows = [&](int k) {
    const int64_t left = r1 - (r0 + (int64_t)k * kRows);
    return (int)(left < kRows ? left : kRows);
  };
  auto issue = [&](int k) {
    if (k < n_stages) {
      const int64_t a = r0 + (int64_t)k * kRows;
      const int rows = stage_rows(k);
      float* st = ring + (k % kStages) * raw_floats;
      copy_span(st, x + a * f, rows * f);
      for (int r = tid; r < rows; r += kThreads) cp_async4(st + w_off + r, w + a + r);
    }
    cp_async_commit();  // an empty group past the last stage keeps the count
  };

  // Every warpgroup multiplies the same number of pieces, so no wgmma sits
  // on a path that differs between warpgroups (ptxas serializes those); a
  // warpgroup short of a piece repeats piece 0 and does not write it.
  const int wg = tid / 128;
  const int per_wg = (grp.count + kWarpgroups - 1) / kWarpgroups;  // uniform in a block
  uint32_t a_off[kMaxPieces], b_off[kMaxPieces];  // byte offsets in a buffer
#pragma unroll
  for (int p = 0; p < kMaxPieces; ++p) {
    const int g = wg + kWarpgroups * p;
    int m0 = 0, n0 = 0;
    piece_origin(f, grp.first + (g < grp.count ? g : 0), &m0, &n0);
    a_off[p] = (uint32_t)(m0 - grp.a_lo) * kOperandRowBytes;
    b_off[p] = 2u * ma * kOperandRowBytes + (uint32_t)(n0 - grp.b_lo) * kOperandRowBytes;
  }
  const uint32_t lo_a = (uint32_t)ma * kOperandRowBytes;  // A lo after A hi
  const uint32_t lo_b = (uint32_t)mb * kOperandRowBytes;  // B lo after B hi

  float part[kMaxPieces][kAcc], run[kMaxPieces][kAcc];
#pragma unroll
  for (int p = 0; p < kMaxPieces; ++p)
#pragma unroll
    for (int i = 0; i < kAcc; ++i) part[p][i] = run[p][i] = 0.f;

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) issue(k);

  // the columns the block splits: A's [a_lo, a_end) and B's [b_lo, b_end),
  // one run where they meet, else two
  const int a_end = grp.a_lo + grp.a_n < f ? grp.a_lo + grp.a_n : f;
  const int b_end = grp.b_lo + grp.b_n < f ? grp.b_lo + grp.b_n : f;
  const bool joined = grp.b_lo <= a_end;
  const int run1 = (joined && b_end > a_end ? b_end : a_end) - grp.a_lo;
  const int cols = run1 + (joined ? 0 : b_end - grp.b_lo);
  // this thread's split tasks (column c, rows 4q .. 4q + 3, packed as
  // q << 16 | c): the same every stage
  int task[kMaxTasks];
#pragma unroll
  for (int j = 0; j < kMaxTasks; ++j) {
    const int e = tid + j * kThreads;
    const int q = e / cols, t = e - q * cols;
    task[j] = q << 16 | (t < run1 ? grp.a_lo + t : grp.b_lo + t - run1);
  }
  const int n_tasks = cols * (kRows / 4);

  // groups of kPromote steps: the wgmma accumulators start afresh with each
  // group and are added into the running sums at its end
  for (int k = 0; k < n_stages;) {
    const int k_end = k + kPromote < n_stages ? k + kPromote : n_stages;
    for (int fresh = 1; k < k_end; ++k, fresh = 0) {
      // ring buffer (k - 1) % kStages was split before the last barrier
      issue(k + kStages - 1);
      cp_async_wait<kStages - 1>();  // this thread's copies of stage k landed
      wgmma_wait<1>();               // this warpgroup's products of stage k - 2 done
      __syncthreads();               // every thread's copies, every warpgroup's products

      // split stage k into buffer k % 2
      {
        const int64_t a = r0 + (int64_t)k * kRows;
        const int rows = stage_rows(k);
        const float* st = ring + (k % kStages) * raw_floats;
        const float* xs = st + align_shift(x + a * f);
        const float* ws = st + w_off;
        char* buf = reinterpret_cast<char*>(smem + (k & 1) * buf_floats);
#pragma unroll
        for (int j = 0; j < kMaxTasks; ++j) {
          if (tid + j * kThreads >= n_tasks) break;
          const int q = task[j] >> 16, c = task[j] & 0xFFFF;
          const float4 wv = *reinterpret_cast<const float4*>(ws + 4 * q);
          const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
          float ah[4], al[4], bh[4], bl[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 4 * q + i;
            const float xv = r < rows ? xs[r * f + c] : 0.f;
            const float av = r < rows ? wr[i] * xv : 0.f;
            ah[i] = tf32(av);
            al[i] = tf32(av - ah[i]);
            bh[i] = tf32(xv);
            bl[i] = tf32(xv - bh[i]);
          }
          // a_lo and b_lo are multiples of 8: c % 8 is the row in its core matrix
          const uint32_t in_core = q * 128 + (c % 8) * 16;
          if (c < a_end) {
            const uint32_t at = (uint32_t)((c - grp.a_lo) / 8) * kSBO + in_core;
            *reinterpret_cast<float4*>(buf + at) = make_float4(ah[0], ah[1], ah[2], ah[3]);
            *reinterpret_cast<float4*>(buf + lo_a + at) = make_float4(al[0], al[1], al[2], al[3]);
          }
          if (c >= grp.b_lo && c < b_end) {
            const uint32_t bt = 2u * ma * kOperandRowBytes +
                                (uint32_t)((c - grp.b_lo) / 8) * kSBO + in_core;
            *reinterpret_cast<float4*>(buf + bt) = make_float4(bh[0], bh[1], bh[2], bh[3]);
            *reinterpret_cast<float4*>(buf + lo_b + bt) = make_float4(bl[0], bl[1], bl[2], bl[3]);
          }
        }
      }
      fence_proxy_async();  // the split's stores, visible to the tensor cores
      __syncthreads();

      const uint32_t base = smem_addr(smem + (k & 1) * buf_floats);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < kMaxPieces; ++p) {
        if (p >= per_wg) break;
#pragma unroll
        for (int kk = 0; kk < kRows / 8; ++kk) {
          const uint32_t ah = base + a_off[p] + kk * 2 * kLBO;
          const uint32_t bh = base + b_off[p] + kk * 2 * kLBO;
          wgmma_n48(part[p], desc(ah, kSBO), desc(bh + lo_b, kSBO), kk > 0 || !fresh);
          wgmma_n48(part[p], desc(ah + lo_a, kSBO), desc(bh, kSBO), 1);
          wgmma_n48(part[p], desc(ah, kSBO), desc(bh, kSBO), 1);
        }
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int p = 0; p < kMaxPieces; ++p)
#pragma unroll
      for (int i = 0; i < kAcc; ++i) run[p][i] += part[p][i];
  }
  cp_async_wait<0>();

  const int lane = tid % 32, warp = (tid % 128) / 32;
  const int row0 = 16 * warp + lane / 4;
  float* dst = scratch + ((int64_t)blockIdx.x * n_pieces(f) + grp.first) * kM * kN;
#pragma unroll
  for (int p = 0; p < kMaxPieces; ++p) {
    if (wg + kWarpgroups * p >= grp.count) continue;
    float* t = dst + (int64_t)(wg + kWarpgroups * p) * kM * kN;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = run[p][4 * j + i];
      *reinterpret_cast<float2*>(t + row0 * kN + col) = make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(t + (row0 + 8) * kN + col) = make_float2(v[2], v[3]);
    }
  }
}

// One thread per entry (i, j) of C with i <= j: the chunks' partials summed
// in double in chunk order, rounded once, written to both halves of C.
__global__ void combine_kernel(const float* __restrict__ scratch, int f, int n_chunks,
                               float* __restrict__ out) {
  const int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (idx >= (int64_t)f * f) return;
  const int i = (int)(idx / f), j = (int)(idx % f);
  if (i > j) return;
  const int band = i / kM;
  int g = 0;
  for (int b = 0; b < band; ++b) g += band_pieces(f, b);
  g += (j - kM * band) / kN;
  const int64_t off = ((int64_t)g * kM + (i - kM * band)) * kN + (j - kM * band) % kN;
  const int64_t stride = (int64_t)n_pieces(f) * kM * kN;
  double s = 0.0;
  for (int c = 0; c < n_chunks; ++c) s += (double)scratch[off + c * stride];
  const float v = (float)s;
  out[(int64_t)i * f + j] = v;
  out[(int64_t)j * f + i] = v;
}

template <int kStages, int kRows>
int launch(const float* x, const float* w, int64_t n, int f, int64_t chunk_rows,
           int n_chunks, int smem, float* scratch, float* out, cudaStream_t s) {
  const auto kernel = partial_kernel<kStages, kRows>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)n_chunks, (unsigned)n_groups(f)), kThreads, smem, s>>>(
      x, w, n, f, chunk_rows, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t entries = (int64_t)f * f;
  const int threads = 256;
  combine_kernel<<<(unsigned)((entries + threads - 1) / threads), threads, 0, s>>>(
      scratch, f, n_chunks, out);
  return (int)cudaGetLastError();
}

template <int kStages, int kRows>
int blocks_per_sm(int smem) {
  const auto kernel = partial_kernel<kStages, kRows>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
      cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem) !=
      cudaSuccess)
    return 0;
  return blocks;
}

// Calls fn.template operator()<kStages, kRows>() for the runtime pair:
// 2-4 stages of 48, 32 or 16 rows, the pairs ring_stages and step_rows in
// covar_xtx.py choose (-1 for another pair).
template <typename Fn>
int dispatch(int stages, int rows, Fn fn) {
#define XTX_CASE(S, R) \
  if (stages == S && rows == R) return fn.template operator()<S, R>();
  XTX_CASE(2, 48) XTX_CASE(3, 48) XTX_CASE(4, 48)
  XTX_CASE(2, 32) XTX_CASE(3, 32) XTX_CASE(4, 32)
  XTX_CASE(2, 16) XTX_CASE(3, 16) XTX_CASE(4, 16)
#undef XTX_CASE
  return -1;
}

struct BlocksPerSm {
  int smem;
  template <int S, int R>
  int operator()() const { return blocks_per_sm<S, R>(smem); }
};

struct Launch {
  const float *x, *w;
  int64_t n;
  int f;
  int64_t chunk_rows;
  int n_chunks, smem;
  float *scratch, *out;
  cudaStream_t s;
  template <int S, int R>
  int operator()() const {
    return launch<S, R>(x, w, n, f, chunk_rows, n_chunks, smem, scratch, out, s);
  }
};

}  // namespace xtx

// Blocks of the partial pass with `stages` ring stages of `rows` rows and
// `smem` bytes of shared memory that fit on one SM at once (0 on error).
extern "C" int covar_xtx_blocks_per_sm(int stages, int rows, int smem) {
  const int blocks = xtx::dispatch(stages, rows, xtx::BlocksPerSm{smem});
  return blocks < 0 ? 0 : blocks;
}

// scratch holds n_chunks * n_pieces(f) * 64 * 48 floats; out holds f * f
// floats.  Takes 48 rows a step up to f = 96, 32 up to f = 192, else 16,
// and smem of xtx::smem_bytes(f, stages, rows).
extern "C" int covar_xtx(const float* x, const float* w, int64_t n, int f,
                         int64_t chunk_rows, int n_chunks, int stages, int rows,
                         int smem, float* scratch, float* out, void* stream) {
  using namespace xtx;
  if (f < 1 || (rows == 48 && f > kLongStepFeatures) || (rows == 32 && f > kStepFeatures) ||
      smem != smem_bytes(f, stages, rows))
    return (int)cudaErrorInvalidValue;
  const int err = dispatch(stages, rows, Launch{x, w, n, f, chunk_rows, n_chunks, smem,
                                                scratch, out, (cudaStream_t)stream});
  return err < 0 ? (int)cudaErrorInvalidValue : err;
}

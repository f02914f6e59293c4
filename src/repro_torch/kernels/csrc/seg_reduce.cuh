// Keyed segment reduction, the accumulator in shared memory:
//     out[s, c] = sum over rows n with code[n] == s of pay[n, c]
// where a code outside [0, S) contributes nothing.  seg_aggregate.cu runs
// it on one (n, A) payload; it is written so that fused_scan_block's SEG and
// HIST reductions can move onto it (an item names a segment range and a
// column tile, and the value of a (row, column) pair is formed where it is
// read).
//
// What bounds it on an H100: the bytes of codes and payload read from HBM,
// each once.  At the covar plan's widest fact bucket (1,000,003 rows, 4,960
// segments, 99 columns) that is 0.40 GB, 0.120 ms at 3.35 TB/s.  What held
// the shared scan_reduce.cuh kernel (and a first design of this file) back,
// measured with tools/scan_ablation.py and probes of single phases:
//
//   * the accumulator (4,960 x 99 floats, 1.96 MB) was cut into column
//     tiles of 6-11 columns, one block each, and every block read its few
//     columns of every row: 28-44 useful bytes of a 396-byte row cost 1-2
//     sectors, so the tiles of a row took 700-900 bytes of L2 traffic.  With
//     the adds taken out, that feed alone ran 0.56 ms;
//   * the adds are shared-memory atomics, which sm_90 runs as a compare-
//     and-swap loop (ATOMS.CAST.SPIN), one add after another in a thread:
//     each waits out the loop's latency, a few hundred cycles.
//
// Two modes, chosen on the host:
//
//   * one block (rows_kernel), where the whole (S, A) accumulator fits a
//     block beside its ring (every narrow reduction of the covar plan: 4,800
//     x 1, 480 x 20, ...): a ring of kStagesA stages of whole rows and their
//     codes (4-byte cp.async, kStagesA - 1 stages ahead), threads laid out
//     (row, column), each adding with a shared-memory atomic.  Many short
//     chunks, about two blocks an SM, keep a width-1 reduction spread;
//   * segment ranges (range_kernel), where it does not: a block owns a range
//     of segments with all columns (450 x 99 at the fact bucket) and reads
//     every code of its chunk, kStageRowsB at a time (cp.async, the next
//     stage's while this one is added), but the payload only of the rows
//     whose codes fall in its range.  It counting-sorts a stage's rows in
//     range by segment (a shared atomic a row on the buckets, a prefix
//     sum), and each warp walks a contiguous slice of that list:
//     kBatch rows' values loaded at once straight from global memory (a
//     row is read once, whole, in 128-byte passes), the rows of one segment
//     summed in registers, and each segment's sum added with compare-and-
//     swaps issued together, retrying only those another warp got to
//     first.  Sorting matters on skewed keys: Retailer's locn puts a
//     quarter of the fact rows on 124 of the 4,960 segments, and rows of
//     one segment in flight at once made each other retry (1.0 ms a launch
//     where uniform codes took 0.31; sorted, 0.30 and 0.28).  The grid is
//     one wave of independent blocks (thread-block clusters of 16, a chunk's
//     ranges walking it together on one GPC, held 112 of the 132 SMs and
//     ran the fact bucket in 0.33 ms against 0.29);
//   * in both, each block writes its partial tile to scratch, and a second
//     kernel sums the chunks in a fixed order, in double, and rounds each
//     output once to float.  The payload may start at any float: every copy
//     and load is of 4-byte words.
//
// Shared-memory atomics add in an order that varies from run to run, so two
// runs agree to float32 rounding, not bit for bit.  Integer-valued payloads
// (COUNT and its products) are the exception: while a chunk's partial stays
// below 2^24 every float add in it is exact, and the double combine makes
// the output the exact sum rounded once.  A segment that holds most rows
// puts most of the payload on one range-mode block.  The host-side geometry
// (mode, ranges, tiles, chunks, scratch) is seg_aggregate.py's.  No
// output is allocated here: the caller passes scratch and output buffers and
// the stream.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace seg_reduce {

// One work item (a block of a row chunk) is N_FIELDS int64 values.
enum Field {
  F_SEG0 = 0,     // first segment of the item's range
  F_NSEG,         // segments of the range
  F_COL0,         // first output (and payload) column of the tile
  F_TILE,         // columns of the tile
  F_SCRATCH_OFF,  // offset of the item's (n_chunks, F_NSEG * F_TILE) partials
  N_FIELDS
};

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kStagesA = 4;        // ring stages of whole rows (one-block mode)
constexpr int kStageRowsB = 4096;  // codes a stage (range mode)
constexpr int kRowsPerThread = kStageRowsB / kThreads;
constexpr int kBuckets = 2 * kThreads;  // of the counting sort: two a thread
constexpr int kPassesB = 4;        // 32-column passes of a row a warp loads at once
constexpr int kBatch = 8;          // listed rows a warp loads at once
constexpr int kCombineThreads = 256;

struct Params {
  const int* codes;      // (n,) int32
  const float* pay;      // (n, width) float32, row-major
  int64_t n;
  int64_t width;
  const int64_t* items;
  float* scratch;
  int64_t chunk_rows;
  int part_stride;       // floats between two chunks' partials of an item
  int stage_rows;        // one-block mode: rows a ring stage holds
};

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
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

struct Item {
  int S, tile;
  int64_t seg0, col0;
};

__device__ __forceinline__ Item item_of(const Params& p) {
  const int64_t* it = p.items + (int64_t)blockIdx.x * N_FIELDS;
  return Item{(int)it[F_NSEG], (int)it[F_TILE], it[F_SEG0], it[F_COL0]};
}

__device__ __forceinline__ void write_partial(const Params& p, const float* acc, int size) {
  const int64_t* it = p.items + (int64_t)blockIdx.x * N_FIELDS;
  float* dst = p.scratch + it[F_SCRATCH_OFF] + (int64_t)blockIdx.y * p.part_stride;
  for (int i = threadIdx.x; i < size; i += blockDim.x) dst[i] = acc[i];
}

// One-block mode: the whole (S, width) accumulator fits the block (tile =
// width <= kThreads), so every row is read whole.  Shared memory: the
// accumulator, rounded up to 4 floats, then kStagesA stages of stage_rows
// codes and stage_rows x tile values.  Threads are laid out (row slot,
// column); each adds its values with shared-memory atomics.
static __global__ void __launch_bounds__(kThreads)
rows_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const Item m = item_of(p);
  const int tile = m.tile, size = m.S * tile, R = p.stage_rows;
  float* acc = smem;
  float* ring = smem + ((size + 3) & ~3);
  const int stage_floats = R * (tile + 1);
  for (int i = threadIdx.x; i < size; i += kThreads) acc[i] = 0.f;

  const int64_t r0 = (int64_t)blockIdx.y * p.chunk_rows;
  const int64_t r1 = r0 + p.chunk_rows < p.n ? r0 + p.chunk_rows : p.n;
  const int n_stages = (int)((r1 - r0 + R - 1) / R);
  const int j = threadIdx.x % tile, slot = threadIdx.x / tile, slots = kThreads / tile;
  auto rows_of = [&](int k) {
    const int64_t left = r1 - (r0 + (int64_t)k * R);
    return (int)(left < R ? left : R);
  };
  auto issue = [&](int k) {
    if (k < n_stages) {
      const int64_t a = r0 + (int64_t)k * R;
      const int rows = rows_of(k);
      int* codes = reinterpret_cast<int*>(ring + (k % kStagesA) * stage_floats);
      float* vals = reinterpret_cast<float*>(codes + R);
      for (int r = threadIdx.x; r < rows; r += kThreads) cp_async4(codes + r, p.codes + a + r);
      if (slot < slots) {
        const float* src = p.pay + a * p.width + m.col0 + j;
        for (int r = slot; r < rows; r += slots)
          cp_async4(vals + r * tile + j, src + (int64_t)r * p.width);
      }
    }
    cp_async_commit();  // an empty group past the last stage keeps the count
  };

#pragma unroll
  for (int k = 0; k < kStagesA - 1; ++k) issue(k);
  __syncthreads();  // acc zeroed
  for (int k = 0; k < n_stages; ++k) {
    issue(k + kStagesA - 1);  // into the buffer of stage k - 1, read before the last barrier
    cp_async_wait<kStagesA - 1>();
    __syncthreads();
    const int rows = rows_of(k);
    const int* codes = reinterpret_cast<const int*>(ring + (k % kStagesA) * stage_floats);
    const float* vals = reinterpret_cast<const float*>(codes + R);
    if (slot < slots) {
      for (int r = slot; r < rows; r += slots) {
        const int64_t code = (int64_t)codes[r] - m.seg0;
        if ((uint64_t)code < (uint64_t)m.S) atomicAdd(&acc[code * tile + j], vals[r * tile + j]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  write_partial(p, acc, size);
}

// Range mode: the accumulator is cut into segment ranges (and, past
// MAX_TILE_B columns, column tiles); a block reads every code of its chunk
// but the payload only of its rows.  Shared memory: the accumulator,
// rounded up to 4 floats; one stage of kStageRowsB codes (the next stage's
// codes load while this stage's rows are added); the list of the stage's
// rows in range, (row, code - seg0) each; a count a warp; kBuckets counts.
static __global__ void __launch_bounds__(kThreads, 1)
range_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const Item m = item_of(p);
  const int tile = m.tile, size = m.S * tile;
  float* acc = smem;
  int* codes = reinterpret_cast<int*>(smem + ((size + 3) & ~3));
  int2* lst = reinterpret_cast<int2*>(codes + kStageRowsB);
  int* counts = reinterpret_cast<int*>(lst + kStageRowsB);
  int* hist = counts + kWarps;
  for (int i = threadIdx.x; i < size; i += kThreads) acc[i] = 0.f;
  for (int i = threadIdx.x; i < kBuckets; i += kThreads) hist[i] = 0;

  const int64_t r0 = (int64_t)blockIdx.y * p.chunk_rows;
  const int64_t r1 = r0 + p.chunk_rows < p.n ? r0 + p.chunk_rows : p.n;
  const int n_stages = (int)((r1 - r0 + kStageRowsB - 1) / kStageRowsB);
  auto rows_of = [&](int k) {
    const int64_t left = r1 - (r0 + (int64_t)k * kStageRowsB);
    return (int)(left < kStageRowsB ? left : kStageRowsB);
  };
  auto issue_codes = [&](int k) {
    if (k < n_stages) {
      const int64_t a = r0 + (int64_t)k * kStageRowsB;
      for (int r = threadIdx.x; r < rows_of(k); r += kThreads) cp_async4(codes + r, p.codes + a + r);
    }
    cp_async_commit();
  };
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  issue_codes(0);
  for (int k = 0; k < n_stages; ++k) {
    const int64_t a = r0 + (int64_t)k * kStageRowsB;
    const int rows = rows_of(k);
    cp_async_wait<0>();
    __syncthreads();  // the stage's codes; the last stage's list is added
    // The stage's rows in range, counting-sorted by bucket (segment mod
    // kBuckets: by segment where the range holds at most kBuckets), so the
    // rows of one segment lie together in the list.  A thread takes rows
    // tid + j kThreads, and each row's rank in its bucket (a shared integer
    // atomic, native on sm_90; aggregating a warp's equal buckets first with
    // __match_any_sync cost 0.09 ms more at the fact bucket) stays in a
    // register.
    int rank[kRowsPerThread], seg_of[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int r = threadIdx.x + j * kThreads;
      const int64_t code = r < rows ? (int64_t)codes[r] - m.seg0 : -1;
      const bool mine = (uint64_t)code < (uint64_t)m.S;
      seg_of[j] = mine ? (int)code : -1;
      rank[j] = mine ? atomicAdd(&hist[code % kBuckets], 1) : 0;
    }
    __syncthreads();
    // exclusive prefix sum of the buckets, two a thread
    int listed;
    {
      const int h0 = hist[2 * threadIdx.x], h1 = hist[2 * threadIdx.x + 1];
      int incl = h0 + h1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      if (lane == 31) counts[warp] = incl;
      __syncthreads();
      int before = 0;
      listed = 0;
      for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? counts[w] : 0;
        listed += counts[w];
      }
      const int excl = before + incl - h0 - h1;
      hist[2 * threadIdx.x] = excl;
      hist[2 * threadIdx.x + 1] = excl + h0;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j)
      if (seg_of[j] >= 0)
        lst[hist[seg_of[j] % kBuckets] + rank[j]] =
            make_int2(threadIdx.x + j * kThreads, seg_of[j]);
    __syncthreads();  // the list is complete; the codes and buckets are free
    issue_codes(k + 1);
    for (int i = threadIdx.x; i < kBuckets; i += kThreads) hist[i] = 0;

    // A warp takes a contiguous slice of the list and walks it kBatch rows
    // at a time: it loads all their values (kPassesB 32-column passes in
    // flight a row) straight from global memory, sums the rows of one
    // segment in registers, then adds each segment's sum a pass at a time:
    // it reads the accumulator words, issues the compare-and-swaps at once,
    // and retries only those another add got to first.  (sm_90 has no
    // native float add in shared memory: atomicAdd is a compare-and-swap
    // loop whose latency, paid once an add, bounded the earlier kernels;
    // and rows of one segment in flight at once make each other retry.)
    const int lo = (int)((int64_t)listed * warp / kWarps);
    const int hi = (int)((int64_t)listed * (warp + 1) / kWarps);
    for (int i0 = lo; i0 < hi; i0 += kBatch) {
      for (int c0 = 0; c0 < tile; c0 += 32 * kPassesB) {
        float v[kBatch][kPassesB];
        float* dst[kBatch];
        int sg[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const bool in = i0 + u < hi;
          const int2 e = lst[in ? i0 + u : i0];
          sg[u] = in ? e.y : -1 - u;
          dst[u] = in ? acc + (int64_t)e.y * tile : nullptr;
          const float* src = p.pay + (a + e.x) * p.width + m.col0;
#pragma unroll
          for (int q = 0; q < kPassesB; ++q) {
            const int c = c0 + 32 * q + lane;
            v[u][q] = in && c < tile ? __ldg(src + c) : 0.f;
          }
        }
        // a run of one segment adds into its last row's registers
#pragma unroll
        for (int u = 1; u < kBatch; ++u)
          if (sg[u] == sg[u - 1]) {
#pragma unroll
            for (int q = 0; q < kPassesB; ++q) v[u][q] += v[u - 1][q];
            dst[u - 1] = nullptr;
          }
#pragma unroll
        for (int q = 0; q < kPassesB; ++q) {
          const int c = c0 + 32 * q + lane;
          if (c >= tile) break;
          unsigned seen[kBatch], got[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            if (dst[u]) seen[u] = __float_as_uint(dst[u][c]);
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            if (dst[u])
              got[u] = atomicCAS(reinterpret_cast<unsigned*>(dst[u] + c), seen[u],
                                 __float_as_uint(__uint_as_float(seen[u]) + v[u][q]));
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            if (dst[u])
              while (got[u] != seen[u]) {
                seen[u] = got[u];
                got[u] = atomicCAS(reinterpret_cast<unsigned*>(dst[u] + c), seen[u],
                                   __float_as_uint(__uint_as_float(seen[u]) + v[u][q]));
              }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  write_partial(p, acc, size);
}

static __global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const int64_t* __restrict__ items, const float* __restrict__ scratch,
               int64_t n_chunks, int part_stride, int64_t width,
               float* __restrict__ out) {
  const int64_t* d = items + (int64_t)blockIdx.x * N_FIELDS;
  const int tile = (int)d[F_TILE];
  const int64_t size = d[F_NSEG] * tile;
  const int64_t col0 = d[F_COL0];
  const int64_t seg0 = d[F_SEG0];
  const float* src = scratch + d[F_SCRATCH_OFF];
  for (int64_t i = (int64_t)blockIdx.y * blockDim.x + threadIdx.x; i < size;
       i += (int64_t)gridDim.y * blockDim.x) {
    double s = 0.0;
    for (int64_t ch = 0; ch < n_chunks; ++ch) s += src[ch * part_stride + i];
    const int64_t seg = i / tile;
    out[(seg0 + seg) * width + col0 + (i - seg * tile)] = (float)s;
  }
}

typedef void (*PartialKernel)(const Params);

static PartialKernel partial_kernel(int mode) { return mode ? range_kernel : rows_kernel; }

static cudaError_t set_smem(PartialKernel kernel, int smem_bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

// Blocks of `smem_bytes` each that one SM holds at once (0 when the shape
// does not schedule, -1 on an error); mode 0 is the one-block kernel, 1 the
// range kernel.
static int blocks_per_sm(int mode, int smem_bytes) {
  const PartialKernel kernel = partial_kernel(mode);
  int blocks = 0;
  if (set_smem(kernel, smem_bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem_bytes) !=
          cudaSuccess)
    return -1;
  return blocks;
}

// Launches both passes on `stream` over a grid of (n_items, n_chunks)
// blocks; returns the first CUDA error, or 0.
static cudaError_t launch(const Params& p, int mode, int n_items, int n_chunks,
                          int smem_bytes, int64_t max_size, float* out, cudaStream_t stream) {
  const PartialKernel kernel = partial_kernel(mode);
  cudaError_t err = set_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)n_items, (unsigned)n_chunks), kThreads, smem_bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int64_t gy = (max_size + kCombineThreads - 1) / kCombineThreads;
  if (gy > 64) gy = 64;
  combine_kernel<<<dim3((unsigned)n_items, (unsigned)gy), kCombineThreads, 0, stream>>>(
      p.items, p.scratch, n_chunks, p.part_stride, p.width, out);
  return cudaGetLastError();
}

}  // namespace seg_reduce

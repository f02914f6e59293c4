// Keyed segment reduction, the accumulator in shared memory.  Every keyed
// segment sum and histogram of the port runs through this header
// (seg_aggregate.cu, fused_scan.cu, tree_hist.cu, tree_hist_batched.cu).  A
// launch computes, for one or more reductions r,
//     out_r[s, c] = sum over rows n with code_r[n] == s of val_r[n, c]
// where a code outside [0, S_r) contributes nothing, and val_r is
//   * SEG: the columns of the reduction's payload parts, one after another;
//   * HIST: cond_r[n, j] * [1, y, y^2][k] at column c = 3j + k, formed in
//     registers from a cond part of N columns and either a y column or the
//     three columns of a packed [1, y, y^2] (the reference's form, which may
//     hold any three floats).
// Each code, payload part, cond and y is a source that the launch reads
// where it lies: a pointer with a row stride and a column stride in 4-byte
// words (a row stride of 0 repeats one row, as an expanded column does; a
// transposed (N, n) mask is read with a row stride of 1).  A payload part
// also names the output column of its first element and the output column
// stride of the next ones, so one aggregate column of a view (its pulled
// values at a stride of the view's aggregates) is a part of its own: the
// (n, A) payload of a view is never stacked.  The accumulator holds the
// parts' columns one after another; the combine kernel puts each where it
// belongs, and an output column that no part names stays 0.  The sources
// are a small device table that the wrapper keeps by content.
//
// What bounds it on an H100: the bytes of codes and values read from HBM,
// each once.  At the covar plan's widest fact bucket (1,000,003 rows, 4,960
// segments, 99 columns) that is 0.40 GB, 0.120 ms at 3.35 TB/s.  What held
// the column-tile kernel this header replaces back, measured with
// tools/scan_ablation.py and probes of single phases:
//
//   * an accumulator wider than one block (4,960 x 99 floats, 1.96 MB) was
//     cut into column tiles of 6-11 columns, one block each, and every block
//     read its few columns of every row: 28-44 useful bytes of a 396-byte
//     row cost 1-2 sectors, so the tiles of a row took 700-900 bytes of L2
//     traffic.  With the adds taken out, that feed alone ran 0.56 ms;
//   * the adds were shared-memory atomics, which sm_90 runs as a compare-
//     and-swap loop (ATOMS.CAST.SPIN): a block of few segments made its
//     threads retry on the same words;
//   * a histogram value cond * [1, y, y^2][k] was formed by three threads,
//     each loading the same cond float and adding one of the three.
//
// Per reduction the host (seg_aggregate.py) picks one of four partial
// kernels and cuts its items:
//
//   * one block, SEG (rows_kernel), where the whole (S, width) accumulator
//     fits a block beside its ring (every narrow reduction of the covar
//     plan: 4,800 x 1, 480 x 20, 40 x 4): a ring of kStagesA stages of
//     whole staged rows and their codes (4-byte cp.async, kStagesA - 1
//     stages ahead).  A part whose rows lie next to each other (row stride
//     1) is staged by a warp a column, its lanes on neighbouring rows; any
//     other by threads laid out (row, column).  Threads add laid out (row
//     slot, column) with atomicAdd, into a copy of the accumulator a warp,
//     or, where a copy a row slot fits half an SM (40 x 4: 128 copies),
//     with plain adds into their own copy;
//   * one block, HIST (hist_kernel), where the (S, 3N) accumulator fits
//     (480 x 48 at a 16-node frontier): no ring; a thread loads its rows'
//     codes, conds and ys straight from global memory, kBatchH rows at
//     once, forms the three values of its cond and adds with atomicAdd;
//   * segment ranges (range_kernel, SEG or HIST), where the accumulator
//     does not fit: a block owns a range of segments with all columns (450
//     x 99 at the fact bucket) and reads every code of its chunk,
//     kStageRowsB at a time (cp.async, the next stage's while this one is
//     added), but the values only of the rows whose codes fall in its
//     range.  It counting-sorts a stage's rows in range by segment (a
//     shared atomic a row on the buckets, a prefix sum), and each warp
//     walks a contiguous slice of that list: kBatch rows' values loaded at
//     once straight from global memory (a row is read once, whole, in
//     128-byte passes; a HIST lane loads one cond and forms its three
//     values), the rows of one segment summed in registers, and each
//     segment's sum added with atomicAdd.  Sorting matters on skewed
//     keys: Retailer's locn puts a quarter of the fact rows on 124 of the
//     4,960 segments, and rows of one segment in flight at once made each
//     other retry.  A row is whole only where its values lie together: the
//     lowering passes each aggregate column as a part of its own, and a
//     listed row then costs a 32-byte sector a column (the covar fact
//     bucket 0.80 ms against 0.29 packed).  Column tiles of the one-block
//     kernel, which read such columns coalesced, were slower still: their
//     shared-memory atomics (tools/scan_ablation.py, column_tiles).
//
// A launch runs one grid for each partial kernel its reductions need, one
// after another on one stream, then one combine grid.  The reductions of a
// kernel share its grid, each with its share of the wave of blocks (the
// host weighs a row's cost to each), so that their latencies hide each
// other.  A grid is (item, row chunk), the items of one chunk next to each
// other, so that they run in the same wave and the ranges' repeated reads
// of a chunk's codes come from L2.  Each block writes its partial tile to
// scratch, and the combine kernel sums an item's chunks in a fixed order,
// in double, and rounds each output once to float.  Every copy and load is
// of 4-byte words, so a source may start at any float.
//
// Shared-memory atomics add in an order that varies from run to run, so
// two runs agree to float32 rounding, not bit for bit.  Integer-valued
// payloads (COUNT and its products) are the exception: while a chunk's
// partial stays below 2^24 every float add in it is exact, and the double
// combine makes the output the exact sum rounded once.  Every mode adds
// every value of its rows, zeros too, as the reference does (0 * y is NaN
// where y is not finite), so one input gives one answer whatever mode its
// shape picks.  No output is allocated here: the caller passes scratch and
// output buffers and the stream.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace seg_reduce {

enum Kind : int { SEG = 0, HIST = 1 };

// One source of a launch, N_SRC_FIELDS int64 values in a device table the
// wrapper writes: element (r, i) lies at ptr[r * rs + i * cs] (in floats,
// or int32 codes), for i < width.  A payload part's elements are the
// accumulator's columns col0 .. col0 + width and the output's columns ocol
// + i * ostride; a HIST reduction's cond part and y part are its staged
// columns 0 .. N and N .. N + 1 (y) or N + 3 (yk), and the cond part's ocol
// and ostride are the output strides of a segment and of a cond.
enum SrcField { S_PTR = 0, S_RS, S_CS, S_COL0, S_WIDTH, S_OCOL, S_OSTRIDE, N_SRC_FIELDS };

struct Src {
  const float* ptr;
  int64_t rs, cs;
  int col0, width;
};

// One work item (a block of a row chunk) is N_FIELDS int64 values.
enum Field {
  F_SEG0 = 0,     // first segment of the item's range
  F_NSEG,         // segments of the range
  F_COL0,         // first accumulator column of the tile
  F_TILE,         // columns of the tile
  F_SCRATCH_OFF,  // offset of the item's (n_chunks, part_stride) partials
  F_KIND,         // SEG or HIST
  F_WIDTH,        // output columns of the reduction
  F_OUT_OFF,      // offset of the reduction's (S, width) output
  F_CODE,         // source of the codes
  F_SRC0,         // first part (HIST: the cond part, then the y part)
  F_NSRC,         // parts
  F_NCOND,        // HIST: cond columns
  F_STAGE_ROWS,   // one-block SEG: rows a ring stage holds
  F_NCHUNKS,      // row chunks of the item (blocks of the grid past them exit)
  F_CHUNK_ROWS,   // rows a chunk
  F_PART_STRIDE,  // floats between two chunks' partials of the item
  F_COPIES,       // one-block mode: copies of the accumulator (warp w adds into w mod copies)
  N_FIELDS
};

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kStagesA = 4;        // ring stages of whole rows (one-block mode)
constexpr int kBatchA = 1;         // rows a thread adds at once (one-block SEG)
constexpr int kBatchH = 4;         // rows a thread adds at once (one-block HIST)
constexpr int kStageRowsB = 4096;  // codes a stage (range mode)
constexpr int kRowsPerThread = kStageRowsB / kThreads;
constexpr int kBuckets = 2 * kThreads;  // of the counting sort: two a thread
constexpr int kPassesB = 4;        // 32-column passes of a row a warp loads at once (SEG)
constexpr int kPassesH = 1;        // 32-cond passes of a row a warp loads at once (HIST)
constexpr int kBatch = 8;          // listed rows a warp loads at once
constexpr int kCombineThreads = 256;
constexpr int kCombineGroups = 8;     // groups of chunks a combine block sums apart ...
constexpr int kCombineSplit = 64;     // ... for an item of this many chunks or more

struct Params {
  const int64_t* items;  // (n_items, N_FIELDS)
  const int64_t* srcs;   // (n_srcs, N_SRC_FIELDS)
  float* scratch;
  int64_t n;             // rows
  int item0;             // the grid's first item
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

__device__ __forceinline__ Src src_of(const int64_t* srcs, int i) {
  const int64_t* s = srcs + (int64_t)i * N_SRC_FIELDS;
  return Src{reinterpret_cast<const float*>(__ldg(s + S_PTR)), __ldg(s + S_RS), __ldg(s + S_CS),
             (int)__ldg(s + S_COL0), (int)__ldg(s + S_WIDTH)};
}

struct Item {
  int S, tile, src0, nsrc, ncond, stage_rows, part_stride, copies;
  int64_t seg0, col0, chunk_rows, scratch_off, n_chunks;
  Src code;
};

__device__ __forceinline__ Item item_of(const Params& p) {
  const int64_t* it = p.items + (int64_t)(p.item0 + blockIdx.x) * N_FIELDS;
  return Item{(int)it[F_NSEG],        (int)it[F_TILE],        (int)it[F_SRC0],
              (int)it[F_NSRC],        (int)it[F_NCOND],       (int)it[F_STAGE_ROWS],
              (int)it[F_PART_STRIDE], (int)it[F_COPIES],      it[F_SEG0],
              it[F_COL0],             it[F_CHUNK_ROWS],       it[F_SCRATCH_OFF],
              it[F_NCHUNKS],          src_of(p.srcs, (int)it[F_CODE])};
}

// A column of a source: element r at base[r * rs].
struct Col {
  const float* base;
  int rs;
};

// The part of parts [src0, src0 + nsrc) that holds accumulator column c:
// the last that starts at or before it.
__device__ __forceinline__ int part_index(const int64_t* srcs, int src0, int nsrc, int c) {
  int lo = src0, hi = src0 + nsrc - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (srcs[(int64_t)mid * N_SRC_FIELDS + S_COL0] <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ Col column(const Src& s, int c) {
  return Col{s.ptr + (c - s.col0) * s.cs, (int)s.rs};
}

// Adds v[i] into *dst[i] for every dst[i] that is set, each with the
// compiler's shared-memory atomicAdd (a spin on a compare-and-swap, one add
// after another): the one-block modes.
template <int M>
__device__ __forceinline__ void add_each(float* (&dst)[M], const float (&v)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
    if (dst[i]) atomicAdd(dst[i], v[i]);
}

// Writes the block's partial: the accumulator's copies (each `stride`
// floats after the last) summed in a fixed order.
__device__ __forceinline__ void write_partial(const Params& p, const Item& m, const float* smem,
                                              int size, int stride) {
  __syncthreads();
  float* dst = p.scratch + m.scratch_off + (int64_t)blockIdx.y * m.part_stride;
  for (int i = threadIdx.x; i < size; i += blockDim.x) {
    float t = smem[i];
    for (int k = 1; k < m.copies; ++k) t += smem[k * stride + i];
    dst[i] = t;
  }
}

// One-block mode, SEG: the whole (S, tile) accumulator fits the block (tile
// = every accumulator column = vals <= kThreads staged floats a row), so
// every row is read whole.  Shared memory: `copies` copies of the
// accumulator, each rounded up to 4 floats (a copy a row slot where they
// fit, so that each word has one writer and adds need no atomic: few
// segments, 40 at Retailer's locn, would make the threads retry on the same
// words; else warp w adds into copy w mod copies), then kStagesA stages of
// stage_rows codes and stage_rows x vals values.  Threads add laid out (row slot, column),
// kBatchA rows at once.
static __global__ void __launch_bounds__(kThreads, 3) rows_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const Item m = item_of(p);
  if ((int64_t)blockIdx.y >= m.n_chunks) return;  // the item has fewer chunks than the grid
  const int W = m.tile, size = m.S * W, R = m.stage_rows, stride = (size + 3) & ~3;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int j = threadIdx.x % W, slot = threadIdx.x / W, slots = kThreads / W;
  // a copy for every row slot: each word has one writer, and adds need no
  // atomic; fewer: warp w adds into copy w mod copies
  const bool own = m.copies >= slots;
  float* acc = smem + (own ? slot : warp % m.copies) * stride;
  float* ring = smem + m.copies * stride;
  const int stage_floats = R * (W + 1);
  for (int i = threadIdx.x; i < m.copies * stride; i += kThreads) smem[i] = 0.f;

  const int64_t r0 = (int64_t)blockIdx.y * m.chunk_rows;
  const int64_t r1 = r0 + m.chunk_rows < p.n ? r0 + m.chunk_rows : p.n;
  const int n_stages = (int)((r1 - r0 + R - 1) / R);
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
      const int* code = reinterpret_cast<const int*>(m.code.ptr);
      for (int r = threadIdx.x; r < rows; r += kThreads)
        cp_async4(codes + r, code + (a + r) * m.code.rs);
      for (int i = m.src0; i < m.src0 + m.nsrc; ++i) {
        const Src s = src_of(p.srcs, i);
        const float* base = s.ptr + a * s.rs;
        if (s.rs == 1 && s.width > 1) {  // rows lie together: a warp a column
          for (int c = (warp - s.col0 % kWarps + kWarps) % kWarps; c < s.width; c += kWarps)
            for (int r = lane; r < rows; r += 32)
              cp_async4(vals + r * W + s.col0 + c, base + r + c * s.cs);
        } else {  // threads laid out (row, column): a single column, every thread
          const int sl = threadIdx.x / s.width, c = threadIdx.x % s.width;
          const int sls = kThreads / s.width;
          if (sl < sls)
            for (int r = sl; r < rows; r += sls)
              cp_async4(vals + r * W + s.col0 + c, base + r * s.rs + c * s.cs);
        }
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
    if (slot < slots)
      for (int r = slot; r < rows; r += kBatchA * slots) {
        float* dst[kBatchA];
        float v[kBatchA];
#pragma unroll
        for (int u = 0; u < kBatchA; ++u) {
          const int rr = r + u * slots;
          const bool in = rr < rows;
          const int64_t c = in ? (int64_t)codes[rr] - m.seg0 : -1;
          v[u] = in ? vals[rr * W + j] : 0.f;
          dst[u] = (uint64_t)c < (uint64_t)m.S ? acc + c * W + j : nullptr;
        }
        if (own) {
#pragma unroll
          for (int u = 0; u < kBatchA; ++u)
            if (dst[u]) *dst[u] += v[u];
        } else {
          add_each(dst, v);
        }
      }
    __syncthreads();
  }
  cp_async_wait<0>();
  write_partial(p, m, smem, size, stride);
}

// One-block mode, HIST: the (S, 3N) accumulator in shared memory, in
// `copies` copies (warp w adds into copy w mod copies).  No ring: each
// thread loads its rows' codes, conds and ys straight from global memory,
// kBatchH rows at once, forms the three values of each of its conds and
// adds them with the shared-memory atomicAdd.  Threads lie (row slot, cond),
// whatever the mask's strides: lanes on neighbouring rows of one cond (the
// coalesced way to read a transposed mask) would add into one column of
// random segments, and at a row of 3N = 48 floats those words fall on two
// banks (16-way conflicts: the tree fact step as the lowering passes it
// took 2.76 ms, not 0.67, in tools/scan_ablation.py).  A transposed mask's
// lanes then read a sector each, which the neighbouring row slots read
// again from L1.
static __global__ void __launch_bounds__(kThreads, 2) hist_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const Item m = item_of(p);
  if ((int64_t)blockIdx.y >= m.n_chunks) return;  // the item has fewer chunks than the grid
  const int W = m.tile, size = m.S * W, stride = (size + 3) & ~3, N = m.ncond;
  for (int i = threadIdx.x; i < m.copies * stride; i += kThreads) smem[i] = 0.f;
  __syncthreads();
  float* acc = smem + (threadIdx.x / 32 % m.copies) * stride;
  const Src cs = src_of(p.srcs, m.src0), ys = src_of(p.srcs, m.src0 + 1);
  const bool formed = ys.width == 1;
  const int* code = reinterpret_cast<const int*>(m.code.ptr);
  const int64_t r0 = (int64_t)blockIdx.y * m.chunk_rows;
  const int64_t r1 = r0 + m.chunk_rows < p.n ? r0 + m.chunk_rows : p.n;
  auto load_yk = [&](int64_t r, float (&yk)[3]) {
    if (formed) {
      const float y = __ldg(ys.ptr + r * ys.rs);
      yk[0] = 1.f, yk[1] = y, yk[2] = y * y;
    } else {
#pragma unroll
      for (int q = 0; q < 3; ++q) yk[q] = __ldg(ys.ptr + r * ys.rs + q * ys.cs);
    }
  };
  // the three values of cond j of a row with code c
  auto add3 = [&](int c, float cnd, const float (&yk)[3], int j) {
    const int64_t sg = (int64_t)c - m.seg0;
    if ((uint64_t)sg < (uint64_t)m.S) {
      float* d = acc + sg * W + 3 * j;
#pragma unroll
      for (int q = 0; q < 3; ++q) atomicAdd(d + q, cnd * yk[q]);
    }
  };
  const int j = threadIdx.x % N, slot = threadIdx.x / N, slots = kThreads / N;
  if (slot < slots)
    for (int64_t r = r0 + slot; r < r1; r += (int64_t)slots * kBatchH) {
      int c[kBatchH];
      float cnd[kBatchH], yk[kBatchH][3];
#pragma unroll
      for (int b = 0; b < kBatchH; ++b) {
        const int64_t rr = r + (int64_t)b * slots;
        const bool in = rr < r1;
        c[b] = in ? __ldg(code + rr * m.code.rs) : -1;
        cnd[b] = in ? __ldg(cs.ptr + rr * cs.rs + j * cs.cs) : 0.f;
        load_yk(in ? rr : r0, yk[b]);
      }
#pragma unroll
      for (int b = 0; b < kBatchH; ++b) add3(c[b], cnd[b], yk[b], j);
    }
  write_partial(p, m, smem, size, stride);
}

// The columns of a lane's P passes from accumulator column c0 of the tile
// on (a null base past the tile): a SEG payload column, a HIST cond.
template <int U, int P>
__device__ __forceinline__ void columns(const Params& p, const Item& m, int c0, int lane,
                                        Col (&col)[P]) {
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int c = (int)m.col0 + c0 + U * (32 * q + lane);
    if (c0 + U * (32 * q + lane) >= m.tile)
      col[q] = Col{nullptr, 0};
    else if (U == 1)
      col[q] = column(src_of(p.srcs, part_index(p.srcs, m.src0, m.nsrc, c)), c);
    else
      col[q] = column(src_of(p.srcs, m.src0), c / 3);
  }
}

// What a warp's walks of the stages share, set once a block: the y part
// (HIST), and for a SEG reduction of one part whose columns lie next to
// each other (the packed form, seg_aggregate) the lane's first column, from
// which every load of a row is an offset.
template <int U>
struct Walk {
  Src ys;
  const float* base;
  int rs;
  bool fast;

  __device__ __forceinline__ Walk(const Params& p, const Item& m, int lane) {
    ys = src_of(p.srcs, m.src0 + (U == 3));
    const Src only = src_of(p.srcs, m.src0);
    fast = U == 1 && m.nsrc == 1 && only.cs == 1;
    base = only.ptr + ((int)m.col0 + lane - only.col0);
    rs = (int)only.rs;
  }
};

// Range mode, a warp's walk of its slice [lo, hi) of the stage's list: U
// values a lane forms per listed row and pass (1: SEG, an accumulator
// column; 3: HIST, the three values of one cond), P passes of 32 lanes in
// flight.  Accumulator column of (pass q, lane, value k): c0 + U (32 q +
// lane) + k within the tile.  It loads kBatch rows' values at once
// straight from global memory, sums the rows of one segment in registers,
// then adds each segment's sums with atomicAdd.  (Compare-and-swaps issued
// together, retrying only those another add got to first, ran about as
// fast on the covar plan's reductions of random values, but slowed down
// many times on values whose sums repeat, as small integers do: a
// maintained covar's one-hot columns times +-1 row weights.)
template <int U, int P>
__device__ __forceinline__ void walk(const Params& p, const Item& m, const Walk<U>& w,
                                     float* acc, const int2* lst, int lo, int hi, int64_t a,
                                     int lane) {
  const int tile = m.tile;
  const Src& ys = w.ys;
  const bool fast = w.fast;
  for (int c0 = 0; c0 < tile; c0 += 32 * P * U) {
    const float* base = w.base + c0;
    const int fast_rs = w.rs;
    Col col[P];
    if (fast) {
#pragma unroll
      for (int q = 0; q < P; ++q)
        col[q] = Col{c0 + 32 * q + lane < tile ? base + 32 * q : nullptr, fast_rs};
    } else {
      columns<U, P>(p, m, c0, lane, col);
    }
    for (int i0 = lo; i0 < hi; i0 += kBatch) {
      float v[kBatch][P][U];
      float* dst[kBatch];
      int sg[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const bool in = i0 + u < hi;
        const int2 e = lst[in ? i0 + u : i0];
        sg[u] = in ? e.y : -1 - u;
        dst[u] = in ? acc + (int64_t)e.y * tile : nullptr;
        const int64_t row = a + e.x;
        float yk[3] = {1.f, 1.f, 1.f};
        if (U == 3 && in) {
          const float* y = ys.ptr + row * ys.rs;
          if (ys.width == 1) {
            yk[1] = __ldg(y), yk[2] = yk[1] * yk[1];
          } else {
#pragma unroll
            for (int k = 0; k < 3; ++k) yk[k] = __ldg(y + k * ys.cs);
          }
        }
        if (fast) {  // one part, columns next to each other: offsets from one row pointer
          const float* src = base + row * fast_rs;
#pragma unroll
          for (int q = 0; q < P; ++q) v[u][q][0] = in && col[q].base ? __ldg(src + 32 * q) : 0.f;
        } else {
#pragma unroll
          for (int q = 0; q < P; ++q) {
            const float x = in && col[q].base ? __ldg(col[q].base + row * col[q].rs) : 0.f;
#pragma unroll
            for (int k = 0; k < U; ++k) v[u][q][k] = U == 1 ? x : x * yk[k];
          }
        }
      }
      // a run of one segment adds into its last row's registers
#pragma unroll
      for (int u = 1; u < kBatch; ++u)
        if (sg[u] == sg[u - 1]) {
#pragma unroll
          for (int q = 0; q < P; ++q)
#pragma unroll
            for (int k = 0; k < U; ++k) v[u][q][k] += v[u - 1][q][k];
          dst[u - 1] = nullptr;
        }
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (!col[q].base) break;
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const int c = c0 + U * (32 * q + lane) + k;
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            if (dst[u]) atomicAdd(dst[u] + c, v[u][q][k]);
        }
      }
    }
  }
}

// Range mode: the accumulator is cut into segment ranges (and, past
// MAX_TILE_B columns, column tiles); a block reads every code of its chunk
// but the values only of its rows.  Shared memory: the accumulator,
// rounded up to 4 floats; one stage of kStageRowsB codes (the next stage's
// codes load while this stage's rows are added); the list of the stage's
// rows in range, (row, code - seg0) each; a count a warp; kBuckets counts.
template <int KIND>
static __global__ void __launch_bounds__(kThreads, 1) range_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const Item m = item_of(p);
  if ((int64_t)blockIdx.y >= m.n_chunks) return;  // the item has fewer chunks than the grid
  const int tile = m.tile, size = m.S * tile;
  float* acc = smem;
  int* codes = reinterpret_cast<int*>(smem + ((size + 3) & ~3));
  int2* lst = reinterpret_cast<int2*>(codes + kStageRowsB);
  int* counts = reinterpret_cast<int*>(lst + kStageRowsB);
  int* hist = counts + kWarps;
  for (int i = threadIdx.x; i < size; i += kThreads) acc[i] = 0.f;
  for (int i = threadIdx.x; i < kBuckets; i += kThreads) hist[i] = 0;

  const int64_t r0 = (int64_t)blockIdx.y * m.chunk_rows;
  const int64_t r1 = r0 + m.chunk_rows < p.n ? r0 + m.chunk_rows : p.n;
  const int n_stages = (int)((r1 - r0 + kStageRowsB - 1) / kStageRowsB);
  const int* code = reinterpret_cast<const int*>(m.code.ptr);
  auto rows_of = [&](int k) {
    const int64_t left = r1 - (r0 + (int64_t)k * kStageRowsB);
    return (int)(left < kStageRowsB ? left : kStageRowsB);
  };
  auto issue_codes = [&](int k) {
    if (k < n_stages) {
      const int64_t a = r0 + (int64_t)k * kStageRowsB;
      for (int r = threadIdx.x; r < rows_of(k); r += kThreads)
        cp_async4(codes + r, code + (a + r) * m.code.rs);
    }
    cp_async_commit();
  };
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const Walk<KIND == SEG ? 1 : 3> w(p, m, lane);

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
      const int64_t c = r < rows ? (int64_t)codes[r] - m.seg0 : -1;
      const bool mine = (uint64_t)c < (uint64_t)m.S;
      seg_of[j] = mine ? (int)c : -1;
      rank[j] = mine ? atomicAdd(&hist[c % kBuckets], 1) : 0;
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

    // a warp takes a contiguous slice of the list
    const int lo = (int)((int64_t)listed * warp / kWarps);
    const int hi = (int)((int64_t)listed * (warp + 1) / kWarps);
    walk<KIND == SEG ? 1 : 3, KIND == SEG ? kPassesB : kPassesH>(p, m, w, acc, lst, lo, hi, a,
                                                                 lane);
  }
  cp_async_wait<0>();
  write_partial(p, m, acc, size, size);
}

// Sums an item's chunks in a fixed order, in double, and writes each sum
// once to its output word: a SEG accumulator column to the column its part
// names; HIST column 3j + k of segment s to s * ocol + j * ostride + k,
// ocol and ostride the cond part's (3N and 3: (S, 3N) rows; 3 and 3S: (N,
// S, 3)).  A block takes kCombineThreads / G neighbouring partial words,
// and its G rows of threads the chunks g, g + G, ... each, summed in that
// order; the first row then adds the rows' sums in order.  G is
// kCombineGroups for an item of kCombineSplit chunks or more, else 1.
static __global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const int64_t* __restrict__ items, const int64_t* __restrict__ srcs,
               const float* __restrict__ scratch, float* __restrict__ out) {
  __shared__ double part[kCombineThreads];
  const int64_t* d = items + (int64_t)blockIdx.x * N_FIELDS;
  const int tile = (int)d[F_TILE];
  const int64_t size = d[F_NSEG] * tile;
  const int64_t col0 = d[F_COL0], seg0 = d[F_SEG0], width = d[F_WIDTH];
  const int64_t n_chunks = d[F_NCHUNKS], part_stride = d[F_PART_STRIDE];
  const bool seg = d[F_KIND] == SEG;
  const int src0 = (int)d[F_SRC0], nsrc = (int)d[F_NSRC];
  const float* src = scratch + d[F_SCRATCH_OFF];
  float* dst = out + d[F_OUT_OFF];
  const int G = n_chunks >= kCombineSplit ? kCombineGroups : 1, cols = kCombineThreads / G;
  const int x = threadIdx.x % cols, g = threadIdx.x / cols;
  for (int64_t i0 = (int64_t)blockIdx.y * cols; i0 < size; i0 += (int64_t)gridDim.y * cols) {
    const int64_t i = i0 + x;
    double s = 0.0;
    if (i < size)
      for (int64_t ch = g; ch < n_chunks; ch += G) s += src[ch * part_stride + i];
    if (G > 1) {
      part[threadIdx.x] = s;
      __syncthreads();
      if (g == 0)
        for (int k = 1; k < G; ++k) s += part[k * cols + x];
    }
    if (g == 0 && i < size) {
      const int64_t sg = i / tile, c = col0 + (i - sg * tile);
      const int64_t* pt = srcs + (int64_t)(seg ? part_index(srcs, src0, nsrc, (int)c) : src0) *
                                     N_SRC_FIELDS;
      const int64_t at = seg ? (seg0 + sg) * width + pt[S_OCOL] + (c - pt[S_COL0]) * pt[S_OSTRIDE]
                             : (seg0 + sg) * pt[S_OCOL] + (c / 3) * pt[S_OSTRIDE] + c % 3;
      dst[at] = (float)s;
    }
    if (G > 1) __syncthreads();
  }
}

typedef void (*PartialKernel)(const Params);

// The partial kernels: 0 one-block SEG, 1 segment-range SEG, 2 one-block
// HIST, 3 segment-range HIST.
constexpr int kKernels = 4;

static PartialKernel partial_kernel(int k) {
  switch (k) {
    case 0: return rows_kernel;
    case 1: return range_kernel<SEG>;
    case 2: return hist_kernel;
    default: return range_kernel<HIST>;
  }
}

// Raises partial kernel k's limit of dynamic shared memory on the current
// device to smem_bytes where it is lower: a driver call only when a launch
// needs more than every earlier one.
static cudaError_t allow_smem(int k, int smem_bytes) {
  constexpr int kDevices = 64;
  static int allowed[kDevices][kKernels];
  static std::mutex lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices)
    return cudaFuncSetAttribute(partial_kernel(k), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem_bytes);
  std::lock_guard<std::mutex> hold(lock);
  if (allowed[dev][k] >= smem_bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(partial_kernel(k), cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err == cudaSuccess) allowed[dev][k] = smem_bytes;
  return err;
}

// Blocks of `smem_bytes` each that one SM holds at once (0 when the shape
// does not schedule, -1 on an error) of partial kernel k.
static int blocks_per_sm(int k, int smem_bytes) {
  if (k < 0 || k >= kKernels) return -1;
  int blocks = 0;
  if (allow_smem(k, smem_bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, partial_kernel(k), kThreads,
                                                    smem_bytes) != cudaSuccess)
    return -1;
  return blocks;
}

// One launch on `stream`: the partial grids, one after another (grid[4 g ..
// 4 g + 3]: kernel, items, chunks, shared memory; a grid's items follow the
// previous grids'), then the combine grid over all items, combine_blocks
// blocks an item.  items and srcs are device tables.  Returns the first
// CUDA error, or 0.
static int run(const int64_t* items, const int64_t* srcs, int64_t n, const int* grid,
               int n_grids, int64_t combine_blocks, float* scratch, float* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  Params p{items, srcs, scratch, n, 0};
  int n_items = 0;
  for (int g = 0; g < n_grids; ++g) {
    const int* gr = grid + 4 * g;
    if (gr[0] < 0 || gr[0] >= kKernels) return (int)cudaErrorInvalidValue;
    cudaError_t err = allow_smem(gr[0], gr[3]);
    if (err != cudaSuccess) return (int)err;
    p.item0 = n_items;
    partial_kernel(gr[0])<<<dim3((unsigned)gr[1], (unsigned)gr[2]), kThreads, gr[3], st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    n_items += gr[1];
  }
  combine_kernel<<<dim3((unsigned)n_items, (unsigned)combine_blocks), kCombineThreads, 0, st>>>(
      items, srcs, scratch, out);
  return (int)cudaGetLastError();
}

}  // namespace seg_reduce

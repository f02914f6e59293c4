// Keyed segment reduction shared by the three scan kernels of the port
// (fused_scan.cu, seg_aggregate.cu, tree_hist.cu).
//
// Every kernel computes, for one or more reductions r,
//     out_r[s, c] = sum over rows n with code_r[n] == s of pay_r[n, c]
// where a code outside [0, S_r) contributes nothing.  pay_r is a slice of a
// packed float payload (SEG), the outer product cond (x) [1, y, y^2] formed
// from payload columns (HIST), or the same product from separate y and cond
// vectors (VEC_HIST).
//
// What bounds it on an H100: the bytes of codes and payload read from HBM
// (each row is read once per column tile) and the shared-memory atomic adds
// (one per payload element).  The TPU kernels keep every accumulator in VMEM
// across the whole row grid; here a block holds at most 227 KB of shared
// memory while the widest accumulator on the main path is 1.96 MB
// (4960 x 99 floats), so the design is:
//
//   * a work item is one (reduction, column tile) pair, the tile sized so
//     that S_r * tile floats fit the shared-memory budget;
//   * grid = (work item, row chunk).  Each item has its own chunk count:
//     few for wide accumulators, whose partial tiles are costly to write,
//     and up to one per 4096 rows for narrow ones, which keeps the rows
//     added into one shared-memory word in sequence (skewed keys send a
//     quarter of all rows to one segment) few, for both contention and
//     rounding.  Short scans (a dimension relation of a few thousand rows)
//     are cut into chunks of as few as 32 rows, so that they spread over
//     the SMs.  A block zeroes its tile in shared
//     memory, walks its row chunk with threads laid out (row, column) so
//     that neighbouring threads read neighbouring payload columns, and adds
//     each value into acc[code, column] with a shared-memory atomic;
//   * each block writes its partial tile to a (n_chunks, S_r, tile) scratch,
//     and a second kernel sums the chunks in a fixed order, in double
//     precision, and rounds each output once to float.
//
// Shared-memory atomics add in an order that varies from run to run, so two
// runs agree to float32 rounding, not bit for bit.  Integer-valued payloads
// (COUNT and its products) are the exception: while a chunk's partial stays
// below 2^24 every float add in it is exact, and the double combine makes
// the output the exact sum rounded once, the same in every run.  No output
// is allocated here: the caller passes scratch and output buffers and the
// stream.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace scan_reduce {

enum Kind : int64_t { SEG = 0, HIST = 1, VEC_HIST = 2 };

// One work item is N_FIELDS int64 values, written by the Python wrapper.
enum Field {
  F_KIND = 0,     // Kind
  F_CODE_COL,     // column of the codes matrix holding this reduction's code
  F_NSEG,         // S_r
  F_WIDTH,        // output width of the reduction
  F_PAY_OFF,      // SEG: first payload column; HIST: first cond column
  F_YK_OFF,       // HIST: first of the three [1, y, y^2] columns
  F_COL0,         // first output column of this tile
  F_TILE,         // columns in this tile
  F_OUT_OFF,      // offset of the reduction's (S_r, width) output
  F_SCRATCH_OFF,  // offset of this item's (n_chunks, S_r, tile) partials
  F_NCHUNKS,      // row chunks of this item (blocks past it exit at once)
  F_CHUNK_ROWS,   // rows per chunk of this item
  N_FIELDS
};

struct Inputs {
  const int* codes;       // (n, code_stride) int32, row-major
  int64_t code_stride;
  const float* fpay;      // (n, pay_stride) float32, row-major (SEG, HIST)
  int64_t pay_stride;
  const float* y;         // (n,) VEC_HIST only
  const float* cond;      // (n,) VEC_HIST only
  int64_t n;
};

constexpr int kThreads = 1024;
constexpr int kCombineThreads = 256;

static __global__ void __launch_bounds__(kThreads)
partial_kernel(Inputs in, const int64_t* __restrict__ items,
               float* __restrict__ scratch) {
  extern __shared__ float acc[];
  const int64_t* d = items + (int64_t)blockIdx.x * N_FIELDS;
  if (blockIdx.y >= d[F_NCHUNKS]) return;  // uniform over the block
  const int64_t rows_per_chunk = d[F_CHUNK_ROWS];
  const int64_t kind = d[F_KIND];
  const int S = (int)d[F_NSEG];
  const int tile = (int)d[F_TILE];
  const int64_t size = (int64_t)S * tile;

  for (int64_t i = threadIdx.x; i < size; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  // thread -> (row slot, tile column); the few threads past the last full
  // row slot stay idle
  const int j = threadIdx.x % tile;
  const int slot = threadIdx.x / tile;
  const int slots = blockDim.x / tile;
  const int c = (int)d[F_COL0] + j;
  const int code_col = (int)d[F_CODE_COL];
  int64_t a_off = 0, b_off = 0;
  if (kind == SEG) {
    a_off = d[F_PAY_OFF] + c;
  } else if (kind == HIST) {
    a_off = d[F_PAY_OFF] + c / 3;
    b_off = d[F_YK_OFF] + c % 3;
  }
  const int k = c % 3;

  const int64_t r0 = (int64_t)blockIdx.y * rows_per_chunk;
  const int64_t r1 = r0 + rows_per_chunk < in.n ? r0 + rows_per_chunk : in.n;
  if (slot < slots) {
    for (int64_t r = r0 + slot; r < r1; r += slots) {
      const int code = in.codes[r * in.code_stride + code_col];
      if ((unsigned)code >= (unsigned)S) continue;
      float v;
      if (kind == SEG) {
        v = in.fpay[r * in.pay_stride + a_off];
      } else if (kind == HIST) {
        const float* row = in.fpay + r * in.pay_stride;
        v = row[a_off] * row[b_off];
      } else {
        const float cnd = in.cond[r];
        const float y = in.y[r];
        v = k == 0 ? cnd : (k == 1 ? cnd * y : cnd * y * y);
      }
      atomicAdd(&acc[(int64_t)code * tile + j], v);
    }
  }
  __syncthreads();

  float* dst = scratch + d[F_SCRATCH_OFF] + (int64_t)blockIdx.y * size;
  for (int64_t i = threadIdx.x; i < size; i += blockDim.x) dst[i] = acc[i];
}

static __global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const int64_t* __restrict__ items,
               const float* __restrict__ scratch, float* __restrict__ out) {
  const int64_t* d = items + (int64_t)blockIdx.x * N_FIELDS;
  const int64_t n_chunks = d[F_NCHUNKS];
  const int tile = (int)d[F_TILE];
  const int64_t size = d[F_NSEG] * tile;
  const int64_t width = d[F_WIDTH];
  const int64_t col0 = d[F_COL0];
  const float* src = scratch + d[F_SCRATCH_OFF];
  float* dst = out + d[F_OUT_OFF];
  for (int64_t i = (int64_t)blockIdx.y * blockDim.x + threadIdx.x; i < size;
       i += (int64_t)gridDim.y * blockDim.x) {
    double s = 0.0;
    for (int64_t ch = 0; ch < n_chunks; ++ch) s += src[ch * size + i];
    const int64_t seg = i / tile;
    dst[seg * width + col0 + (i - seg * tile)] = (float)s;
  }
}

// Launches both passes on `stream`; returns the first CUDA error, or 0.
// n_chunks is the largest chunk count over the items.
static cudaError_t launch(const Inputs& in, const int64_t* items, int n_items,
                          int n_chunks, int64_t max_size, int smem_bytes,
                          float* scratch, float* out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  partial_kernel<<<dim3(n_items, n_chunks), kThreads, smem_bytes, stream>>>(
      in, items, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int64_t gy = (max_size + kCombineThreads - 1) / kCombineThreads;
  if (gy > 64) gy = 64;
  combine_kernel<<<dim3(n_items, (unsigned)gy), kCombineThreads, 0, stream>>>(
      items, scratch, out);
  return cudaGetLastError();
}

}  // namespace scan_reduce

// covar_xtx: C[f, g] = sum over rows r of w[r] * x[r, f] * x[r, g], for a
// row-major (n, F) float32 x and an (n,) float32 w; C is (F, F) float32.
//
// Replaces the TPU kernel covar_xtx_pallas (src/repro/kernels/covar_xtx.py:41,
// body _covar_kernel at :24), which streams (bm, F) row tiles through VMEM
// and adds (w * x)^T x into an (F, F) accumulator pinned in VMEM across the
// whole row grid: one MXU product per row tile.
//
// Bound on the H100: n (F + 1) * 4 bytes read once against n F (F + 1) flops
// for the upper triangle with its diagonal.  At F = 70 the two are close
// (0.085 ms of HBM against 0.074 ms of float32 FMA at n = 10^6); at F = 142
// the FMAs bound it.  The design, a simple one kept in float32 outside the
// tensor cores:
//
//   * C is cut into 32 x 32 tiles and only the pairs (ti <= tj) of the upper
//     triangle are computed: 32-wide tiles pad F = 70 to 96 columns (6 pairs)
//     where 64-wide ones pad it to 128 (3 pairs of twice the work each);
//   * grid = (tile pair, row chunk), one full wave of resident blocks.  A
//     block of 64 threads walks its chunk in steps of 32 rows: it stages
//     w[r] * x[r, ti columns] and x[r, tj columns] in shared memory
//     (neighbouring threads read neighbouring floats of a row), then each
//     thread forms a 4 x 4 micro-tile of the step's outer products in
//     float32 registers, reading two float4 per row, and adds it to its
//     running sums.  Rows past n and columns past F are staged as zeros.
//     The two levels matter for accuracy: the gathered features repeat
//     (a dimension row's value recurs in every fact row that joins it), and
//     float32 sums of thousands of equal terms round the same way each
//     time; summing 32 rows at a time keeps each running sum's adds few;
//   * each block writes its 32 x 32 partial tile to scratch, and a second
//     kernel sums the chunks of every upper-triangle entry in double, in
//     chunk order, rounds once to float and writes C[i, j] and C[j, i].
//     There are no atomics: two runs give the same bits, C is exactly
//     symmetric, and an integer-valued entry (the count C[0, 0] of a 0/1
//     column) is exact while a chunk's partial stays below 2^24, which the
//     wrapper's chunk cap of 2^16 rows guarantees for 0/1 data.
//
// Left for later: wgmma with 3xTF32 and TMA-fed stages.  No output is
// allocated here: the caller passes scratch, output and the stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace xtx {

constexpr int kTile = 32;                  // output tile side
constexpr int kRows = 32;                  // rows staged per step
constexpr int kMicro = 4;                  // micro-tile side per thread
constexpr int kSide = kTile / kMicro;      // threads per tile side
constexpr int kThreads = kSide * kSide;    // 64

// The (ti, tj) tile pair of pair index p, pairs enumerated row by row of
// the upper triangle: (0,0), (0,1), ..., (0,nt-1), (1,1), ...
__device__ __forceinline__ void pair_tiles(int p, int nt, int* ti, int* tj) {
  int i = 0;
  while (p >= nt - i) {
    p -= nt - i;
    ++i;
  }
  *ti = i;
  *tj = i + p;
}

__device__ __forceinline__ int pair_index(int ti, int tj, int nt) {
  return ti * nt - ti * (ti - 1) / 2 + (tj - ti);
}

__global__ void __launch_bounds__(kThreads)
partial_kernel(const float* __restrict__ x, const float* __restrict__ w,
               int64_t n, int f, int nt, int64_t chunk_rows,
               float* __restrict__ scratch) {
  __shared__ __align__(16) float as[kRows][kTile];   // w * x[:, ti cols]
  __shared__ __align__(16) float bs[kRows][kTile];   // x[:, tj cols]
  const int pair = blockIdx.x;
  const int n_pairs = gridDim.x;
  const int64_t chunk = blockIdx.y;
  int ti, tj;
  pair_tiles(pair, nt, &ti, &tj);
  const int c0a = ti * kTile, c0b = tj * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % kSide, ty = tid / kSide;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;

  const int64_t begin = chunk * chunk_rows;
  const int64_t end = begin + chunk_rows < n ? begin + chunk_rows : n;
  for (int64_t r0 = begin; r0 < end; r0 += kRows) {
    // stage kRows x kTile of each operand: thread t loads column t % 32 of
    // rows t / 32, t / 32 + 2, ...
#pragma unroll 4
    for (int k = tid; k < kRows * kTile; k += kThreads) {
      const int r = k / kTile, c = k % kTile;
      const int64_t row = r0 + r;
      float a = 0.f, b = 0.f;
      if (row < end) {
        const float* xr = x + row * (int64_t)f;
        if (c0a + c < f) a = xr[c0a + c] * w[row];
        if (c0b + c < f) b = xr[c0b + c];
      }
      as[r][c] = a;
      bs[r][c] = b;
    }
    __syncthreads();
    float part[kMicro][kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j) part[i][j] = 0.f;
#pragma unroll 8
    for (int r = 0; r < kRows; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&as[r][ty * kMicro]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[r][tx * kMicro]);
      const float av[kMicro] = {a.x, a.y, a.z, a.w};
      const float bv[kMicro] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }

  float* out = scratch + (chunk * n_pairs + pair) * (int64_t)(kTile * kTile);
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(&out[(ty * kMicro + i) * kTile + tx * kMicro]) = v;
  }
}

// One thread per entry (i, j) of C with i <= j: the chunks' partials summed
// in double in chunk order, rounded once, written to both halves of C.
__global__ void combine_kernel(const float* __restrict__ scratch, int f, int nt,
                               int n_pairs, int n_chunks,
                               float* __restrict__ out) {
  const int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (idx >= (int64_t)f * f) return;
  const int i = (int)(idx / f), j = (int)(idx % f);
  if (i > j) return;
  const int p = pair_index(i / kTile, j / kTile, nt);
  const int64_t off = (int64_t)p * kTile * kTile + (i % kTile) * kTile + j % kTile;
  const int64_t stride = (int64_t)n_pairs * kTile * kTile;
  double s = 0.0;
  for (int c = 0; c < n_chunks; ++c) s += (double)scratch[off + c * stride];
  const float v = (float)s;
  out[(int64_t)i * f + j] = v;
  out[(int64_t)j * f + i] = v;
}

}  // namespace xtx

// Blocks of the partial pass that fit on one SM at once: the wrapper sizes
// the grid to one full wave of them (0 on error).
extern "C" int covar_xtx_blocks_per_sm() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, xtx::partial_kernel, xtx::kThreads, 0) != cudaSuccess)
    return 0;
  return blocks;
}

// scratch holds n_chunks * n_pairs * 32 * 32 floats, with
// n_pairs = nt (nt + 1) / 2 and nt = ceil(f / 32); out holds f * f floats.
extern "C" int covar_xtx(const float* x, const float* w, int64_t n, int f,
                         int64_t chunk_rows, int n_chunks, float* scratch,
                         float* out, void* stream) {
  using namespace xtx;
  cudaStream_t s = (cudaStream_t)stream;
  const int nt = (f + kTile - 1) / kTile;
  const int n_pairs = nt * (nt + 1) / 2;
  partial_kernel<<<dim3(n_pairs, n_chunks), kThreads, 0, s>>>(
      x, w, n, f, nt, chunk_rows, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t entries = (int64_t)f * f;
  const int threads = 256;
  combine_kernel<<<(unsigned)((entries + threads - 1) / threads), threads, 0, s>>>(
      scratch, f, nt, n_pairs, n_chunks, out);
  return (int)cudaGetLastError();
}

// tree_hist_batched: out[b, 3j + k] = sum over rows with code b of
// cond[r, j] * [1, y, y^2][k], for every frontier node j of a (n, N) cond.
//
// Replaces the TPU kernel tree_hist_batched_pallas
// (src/repro/kernels/tree_hist.py:99, body _hist_batched_kernel at :77),
// which forms the (bm, N*3) payload in VMEM and contracts it with a one-hot
// matrix on the MXU into a (D, N*3) accumulator kept across the row grid.
//
// Bound on the H100: HBM bytes, n * (8 + 4N) (a code, a y and N cond floats
// per row, each read once) against 2 * 3N flops per row; the payload is
// never written.  The design: the MAT_HIST kind of scan_reduce.cuh.  The
// payload cond[r, c / 3] * [1, y, y^2][c % 3] is formed in registers, one
// thread per output column, so neighbouring threads read neighbouring cond
// floats of a row; the (D, 3N) accumulator lives in shared memory (at D =
// 480, N = 16: 92 KB, one column tile) and takes one shared-memory atomic
// add per payload element.  Codes outside [0, D) contribute nowhere.  The
// wrapper returns (N, D, 3).  Tolerance: see scan_reduce.cuh.

#include "scan_reduce.cuh"

extern "C" int tree_hist_batched(const int* codes, const float* y,
                                 const float* cond, int64_t n, int64_t n_cond,
                                 const int64_t* items, int n_items,
                                 int n_chunks, int64_t max_size,
                                 int smem_bytes, float* scratch, float* out,
                                 void* stream) {
  scan_reduce::Inputs in{codes, 1, nullptr, 0, y, cond, n_cond, n};
  return (int)scan_reduce::launch(in, items, n_items, n_chunks, max_size,
                                  smem_bytes, scratch, out,
                                  (cudaStream_t)stream);
}

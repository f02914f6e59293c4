// tree_hist: out[b] = [sum cond, sum cond*y, sum cond*y^2] over rows with
// code b.
//
// Replaces the TPU kernel tree_hist_pallas
// (src/repro/kernels/tree_hist.py:51, body _hist_kernel at :31).  The
// payload cond (x) [1, y, y^2] is formed in registers from the y and cond
// vectors and scattered into a shared-memory histogram (the VEC_HIST kind
// of scan_reduce.cuh); codes outside [0, D) contribute nowhere.
//
// Bound on the H100: HBM bytes (12 per row).  Tolerance: see
// scan_reduce.cuh.

#include "scan_reduce.cuh"

extern "C" int tree_hist(const int* codes, const float* y, const float* cond,
                         int64_t n, const int64_t* items, int n_items,
                         int n_chunks, int64_t max_size, int smem_bytes,
                         float* scratch, float* out, void* stream) {
  scan_reduce::Inputs in{codes, 1, nullptr, 0, y, cond, 1, n};
  return (int)scan_reduce::launch(in, items, n_items, n_chunks, max_size,
                                  smem_bytes, scratch, out,
                                  (cudaStream_t)stream);
}

// tree_hist: out[b] = [sum cond, sum cond*y, sum cond*y^2] over rows with
// code b.
//
// Replaces the TPU kernel tree_hist_pallas
// (src/repro/kernels/tree_hist.py:51, body _hist_kernel at :31).  It is the
// one-node case of tree_hist_batched's launch (seg_reduce.cuh, a HIST
// reduction with one cond column and y): the payload cond (x) [1, y, y^2]
// is formed in registers and never written to device memory; codes outside
// [0, D) contribute nowhere.
//
// Bound on the H100: HBM bytes (12 per row).  Tolerance: see
// seg_reduce.cuh.

#include "seg_reduce.cuh"

extern "C" int tree_hist(const int64_t* items, const int64_t* srcs, int64_t n,
                         const int64_t* grid, int n_grids, int64_t combine_blocks,
                         float* scratch, float* out, void* stream) {
  return seg_reduce::run(items, srcs, n, grid, n_grids, combine_blocks, scratch, out, stream);
}

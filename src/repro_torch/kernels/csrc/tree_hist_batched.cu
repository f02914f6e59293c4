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
// never written.  The design: a HIST reduction of seg_reduce.cuh.  Where
// the (D, 3N) accumulator fits one block (D = 480, N = 16: 92 KB, two
// blocks an SM), each thread loads a few rows' codes, ys and the conds of
// its node straight from global memory, forms the three values in
// registers and adds them with the shared-memory atomicAdd, zeros too (as
// the reference, so a non-finite y reads the same in every mode); those
// adds run at the SM's atomic rate.  A wider accumulator (N =
// 200) is cut into segment ranges.  Codes outside [0, D) contribute
// nowhere.  The kernel writes (N, D, 3) itself.  Tolerance: see
// seg_reduce.cuh.

#include "seg_reduce.cuh"

extern "C" int tree_hist_batched(const int64_t* items, const int64_t* srcs, int64_t n,
                                 const int64_t* grid, int n_grids, int64_t combine_blocks,
                                 float* scratch, float* out, void* stream) {
  return seg_reduce::run(items, srcs, n, grid, n_grids, combine_blocks, scratch, out, stream);
}

// fused_scan_block: every reduction of one scan step in one launch.
//
// Replaces the TPU kernel fused_scan_block_pallas
// (src/repro/kernels/fused_scan.py:168, body _reduce_block at :74): for each
// reduction r, out_r[s, :] = sum of val_r[n, :] over rows whose code_r[n]
// == s, where val_r is a segment sum's payload ("seg") or cond (x) [1, y,
// y^2] formed on chip ("hist"), never written to HBM.  The TPU kernel takes
// one packed (n, C) codes matrix and one packed (n, W) payload; here each
// reduction's codes and payload parts are read where they lie (the packed
// form is the case whose parts point into one matrix), so the caller
// stacks nothing.
//
// Bound on the H100: HBM bytes.  The covar plan's fact step reads about
// 500 bytes of codes and payload a row and does one add per payload float.
// The design (seg_reduce.cuh): a reduction whose accumulator fits one block
// is summed there from a ring of whole rows; a wider one is cut into
// segment ranges that read only their own rows, whole, summed by segment in
// registers (a few ranges find them in every code of their chunk, many in a
// list counting-sorted by range once a launch); the reductions' grids run
// one after the other on one stream.

#include "seg_reduce.cuh"

extern "C" int fused_scan_block(const int64_t* items, const int64_t* srcs, int64_t n,
                                const int64_t* grid, int n_grids, int64_t combine_blocks,
                                float* scratch, float* out, void* stream) {
  return seg_reduce::run(items, srcs, n, grid, n_grids, combine_blocks, scratch, out, stream);
}

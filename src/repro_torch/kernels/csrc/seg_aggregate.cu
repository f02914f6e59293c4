// seg_aggregate: out[s, a] = sum of payload[n, a] over rows with seg[n] == s.
//
// Replaces the TPU kernel seg_aggregate_pallas
// (src/repro/kernels/seg_aggregate.py:39, body _seg_kernel at :21), which
// does the scatter as a one-hot matmul with the accumulator in VMEM across
// the whole row grid.  Here the accumulator lives in shared memory, whole in
// one block or cut into segment ranges, a block each, and the scatter is a
// shared-memory add; out-of-range ids contribute nowhere.
//
// Bound on the H100: HBM bytes, 4 per id and per payload float, read once.
// The design that comes near it (a block a segment range, each payload row
// read once by the block whose range holds its code, many ranges finding
// their rows in a list counting-sorted by range) is seg_reduce.cuh's:
// this is its launch of one reduction with one payload part.

#include "seg_reduce.cuh"

// Blocks with `smem_bytes` of shared memory each that one SM holds at once
// of a partial kernel (0 one-block SEG, 1 segment-range SEG, 2 one-block
// HIST, 3 segment-range HIST): 0 when the shape does not schedule, -1 on
// error.  Every entry point of the scan kernels launches the same partial
// kernels.
extern "C" int seg_reduce_blocks_per_sm(int kernel, int smem_bytes) {
  return seg_reduce::blocks_per_sm(kernel, smem_bytes);
}

// items, srcs: the launch's work items and sources on the device (see
// seg_reduce.cuh); grid: n_grids (kernel, items, blocks along x and y,
// shared memory, sort area);
// scratch: the chunks' partials; out: (S, width).
extern "C" int seg_aggregate(const int64_t* items, const int64_t* srcs, int64_t n,
                             const int64_t* grid, int n_grids, int64_t combine_blocks,
                             float* scratch, float* out, void* stream) {
  return seg_reduce::run(items, srcs, n, grid, n_grids, combine_blocks, scratch, out, stream);
}

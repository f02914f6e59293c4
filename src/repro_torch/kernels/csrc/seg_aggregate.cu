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
// read once by the block whose range holds its code) is seg_reduce.cuh's.

#include "seg_reduce.cuh"

// Blocks with `smem_bytes` of shared memory each that one SM holds at once:
// 0 when the shape does not schedule, -1 on error.  mode 0: the whole
// accumulator in one block; 1: segment ranges.
extern "C" int seg_aggregate_blocks_per_sm(int mode, int smem_bytes) {
  return seg_reduce::blocks_per_sm(mode, smem_bytes);
}

// items: (n_items, N_FIELDS) int64 on the device; scratch: n_items *
// n_chunks * part_stride floats; out: (S, width).
extern "C" int seg_aggregate(const int* seg, int64_t n, const float* payload,
                             int64_t width, const int64_t* items, int mode,
                             int n_items, int n_chunks, int64_t chunk_rows,
                             int part_stride, int stage_rows, int64_t max_size,
                             int smem_bytes, float* scratch, float* out, void* stream) {
  seg_reduce::Params p{seg, payload, n, width, items, scratch, chunk_rows,
                       part_stride, stage_rows};
  return (int)seg_reduce::launch(p, mode, n_items, n_chunks, smem_bytes, max_size, out,
                                 (cudaStream_t)stream);
}

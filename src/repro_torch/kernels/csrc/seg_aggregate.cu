// seg_aggregate: out[s, a] = sum of payload[n, a] over rows with seg[n] == s.
//
// Replaces the TPU kernel seg_aggregate_pallas
// (src/repro/kernels/seg_aggregate.py:39, body _seg_kernel at :21), which
// does the scatter as a one-hot matmul with the accumulator in VMEM.  Here
// it is one "seg" reduction of the shared scan_reduce.cuh kernel: a scatter
// into shared-memory tiles; out-of-range ids contribute nowhere.
//
// Bound on the H100: HBM bytes (4 per id and per payload float, read once
// per column tile).  Tolerance: see scan_reduce.cuh.

#include "scan_reduce.cuh"

extern "C" int seg_aggregate(const int* seg, int64_t n, const float* payload,
                             int64_t width, const int64_t* items, int n_items,
                             int n_chunks, int64_t max_size, int smem_bytes,
                             float* scratch, float* out, void* stream) {
  scan_reduce::Inputs in{seg, 1, payload, width, nullptr, nullptr, 0, n};
  return (int)scan_reduce::launch(in, items, n_items, n_chunks, max_size,
                                  smem_bytes, scratch, out,
                                  (cudaStream_t)stream);
}

// fused_scan_block: every reduction of one scan step in one launch.
//
// Replaces the TPU kernel fused_scan_block_pallas
// (src/repro/kernels/fused_scan.py:168, body _reduce_block at :74): for each
// ReduceSpec r, out_r[s, :] = sum of pay_r[n, :] over rows with
// codes[n, code_col_r] == s, where pay_r is a slice of the packed payload
// ("seg") or cond (x) [1, y, y^2] formed on chip from payload columns
// ("hist"), never written to HBM.
//
// Bound on the H100: HBM bytes.  The main path's fact step reads about 500
// bytes of codes and payload per row and does one add per payload float.
// The row block is read once per column tile of each reduction; the design
// and its tolerance are described in scan_reduce.cuh.

#include "scan_reduce.cuh"

extern "C" int fused_scan_block(const int* codes, int64_t n,
                                int64_t code_stride, const float* fpay,
                                int64_t pay_stride, const int64_t* items,
                                int n_items, int n_chunks, int64_t max_size,
                                int smem_bytes, float* scratch, float* out,
                                void* stream) {
  scan_reduce::Inputs in{codes, code_stride, fpay, pay_stride, nullptr,
                         nullptr, n};
  return (int)scan_reduce::launch(in, items, n_items, n_chunks, max_size,
                                  smem_bytes, scratch, out,
                                  (cudaStream_t)stream);
}

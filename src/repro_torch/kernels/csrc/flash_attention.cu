// flash_attention: blockwise attention with an online softmax,
//   o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h / g, j] / sqrt(D_q)) v[b, h / g, j]
// over the keys j the mask allows: j < S_k; j <= i when causal; j > i - window
// when window > 0.  q is (B, H, S_q, D_q), k (B, H_kv, S_k, D_q), v
// (B, H_kv, S_k, D_v) and o (B, H, S_q, D_v), each with its own element
// strides for the batch, head and sequence axes (the last axis is
// contiguous), in bf16 or float32; g = H / H_kv; D_v <= D_q <= 192, both
// multiples of 8 (MLA's prefill: D_q = 128 + 64 of rope, D_v = 128).
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:68, body _flash_kernel at :25), whose
// grid walks (batch, head, query block, key block) in order and keeps the
// running max, normaliser and accumulator in VMEM scratch across the key
// blocks; its BlockSpec index map reads K/V head h // g, so K and V are
// never replicated.  Scores, max, normaliser and accumulator are float32;
// the running max starts at -1e30 (the reference's NEG_INF, not -inf) and
// never falls below it, so a tile masked wholly for a row gives alpha = 1,
// not NaN, and a masked score probability 0; a row with no valid key
// outputs 0 (denominator clamped at 1e-30).
//
// Bound on the H100: at prefill lengths the operations.  Each unmasked
// (q, k) pair costs 2 (D_q + D_v) flops (D_q multiply-adds for the score,
// D_v for P.V) against the bytes of q, k, v and o read and written once; at
// B = 4, H = 16, H_kv = 8, S = 4096, D = 128 in bf16 that is 275 GFLOP at
// 989 TFLOP/s (0.278 ms) against 0.20 GB (0.06 ms).  Both loops visit only
// the key tiles that meet a query tile's causal / window band (the others
// add exactly zero in the reference too, and skipping them halves causal
// work), launch the heaviest query tiles first (the last tile of a causal
// sequence sees the most keys), and mask only the tiles that cross the
// band's edge.  Two kernels, one a dtype:
//
//   * bf16 (flash_kernel_wgmma) is built for the tensor cores' rate, which
//     only wgmma reaches.  One block per (128 query rows, head, batch):
//     two consumer warpgroups of 64 rows and one producer warpgroup.
//     - Loads: one producer thread issues TMA loads (cp.async.bulk.tensor)
//       of Q once and of each 128-key K and V tile into a ring of kStages
//       stages in shared memory, with a full and an empty mbarrier per
//       stage and operand (K is released as soon as Q K^T is done, V after
//       P V); the consumers spend no registers or instructions on
//       addresses, and the next tiles load while the current one is
//       multiplied.  The tensor maps are built on the host, 4-d (D, S, H,
//       B) with the tensors' own strides, so the model's strided views are
//       read without a copy; a box is 64 columns x 128 rows with the
//       128-byte swizzle, so D = 128 is two boxes; TMA's out-of-bounds fill
//       gives zeros past S and past D (8 ... 120).  Q and K take D_q / 64
//       boxes a tile and V and O D_v / 64, rounded up: the instances are
//       <D_q, D_v> = <64, 64>, <128, 128> and <192, 128> (MLA), the last
//       Q 48 KB + 2 x (K 48 KB + V 32 KB) = 208 KB of shared memory; a
//       <192, 192> tile would need 240 KB, over the 227 KB a block may
//       use, and is not built (the wrapper raises).
//     - Products: S = Q K^T is wgmma m64n128k16 with Q and K read from
//       shared memory as they lie (D contiguous: K-major); O += P V is
//       m64n{64,128}k16 with P from registers (the S accumulator's layout
//       repacked pair by pair into bf16 A fragments, as FlashAttention-2
//       rounds P) and V read from shared memory MN-major (the transpose-B
//       bit), never transposed in memory.  A tile is read from shared
//       memory once a warpgroup, by the tensor cores, not once a warp.
//     - Softmax beside the products: each consumer issues tile i's Q K^T
//       before tile i - 1's P V and runs tile i's softmax while P V is on
//       the tensor cores; exp2 is the bare ex2.approx, the scale folded
//       into its argument's FMA, and only an edge tile is masked.
//     - Registers: setmaxnreg drops the producer to 24 and lifts the
//       consumers to 240 a thread, so the 64 score, up to 64 output and 32
//       probability registers and the online softmax stay in registers
//       (D_q only adds k-steps to Q K^T); one block of 160 KB (208 KB at
//       <192, 128>) fills an SM.  A row's max and sum reduce over the 4
//       lanes that share it.
//   * float32 (flash_kernel_tf32) runs on the tensor cores in 3xTF32, as
//     covar_xtx.cu does: an operand x is split into hi = tf32(x) and
//     lo = tf32(x - hi) (round to nearest), and each product is hi.lo +
//     lo.hi + hi.hi, wgmma m64nNk8 .tf32 with float32 accumulators; the
//     dropped lo.lo is 2^-22 of a term, where 1xTF32 would round each
//     product at 2^-11.  It replaces a CUDA-core kernel (4 x 4 register
//     blocks of float FMAs, tiles staged between two __syncthreads) that
//     was capped near the cores' 67 TFLOP/s and reached 31-40% of it.
//     Bound: three TF32 products a term at 495 TFLOP/s, 165 TFLOP/s
//     effective (275 GFLOP at internlm2-1.8b's prefill, B 4, 16:8,
//     S 4,096, D 128: 1.67 ms, against 0.40 GB of bytes, 0.12 ms).  One
//     block per (64 query rows, head, batch), 256 threads:
//     - Loads: one thread of warpgroup 1 (the producer) has TMA load each
//       K and V tile as it lies into a raw buffer in shared memory (4-d
//       float32 maps with the tensors' own strides, boxes of 32 columns,
//       the 128-byte swizzle, zeros past S and D), so no load passes
//       through registers; Q is read once with plain loads.  Plain loads
//       of every tile through the producer's registers, a first design,
//       could not keep up: a tile's 64 KB took longer to arrive than its
//       products took.
//     - Splits: .tf32 operands are K-major only.  The producer's 128
//       threads split the raw tile into high and low parts, K-major in
//       8-row x 16-byte core matrices (no swizzle): K as it lies (D
//       contiguous), V transposed on the way, its keys along K.  V trails
//       K by a tile: K i is split once Q K^T of tile i - 1 is done, then V
//       i - 1 takes the raw buffer while the consumer's P V of tile i - 2
//       finishes; each buffer has a full and an empty mbarrier, and the
//       stores reach the tensor cores through fence.proxy.async.
//     - Products: S = Q K^T with Q and K from shared memory, the small
//       products of every k-step before the hi.hi ones (the tensor cores'
//       adds lose most on a large accumulator: at D_q = 192 this halves
//       the error); O += P V with P split in registers as the A fragments
//       and V^T from shared memory.  A tf32 A fragment gives a lane
//       columns t and t + 4 of an 8-key step where the S accumulator holds
//       keys 2 t and 2 t + 1, so the producer stores each step's keys in
//       the order 0, 2, 4, 6, 1, 3, 5, 7 and no value moves between lanes.
//     - Sums: each tile's P V goes into fresh accumulators, added to the
//       float32 output sums with the online softmax's rescale (the tensor
//       cores' own sums over a long run lose more than float32 adds:
//       covar_xtx.cu); tile i's Q K^T is issued with tile i - 1's P V,
//       and tile i's softmax runs while P V is on the tensor cores.
//     - Shared memory: Q, K and V^T each twice (high and low parts), 8
//       bytes an element, beside the raw buffer.  Tiles are 64 keys up to
//       D_q = 128 (<64, 64> 113 KB, <128, 128> 225 KB); past it 64-key
//       tiles would not fit the 227 KB a block may use beside Q's 96 KB,
//       so <192, 128> and <192, 192> take 32-key tiles (201 and 217 KB).
//       One block an SM; 256 threads leave each up to 255 registers.
//     What bounds it now is shared memory, not the tensor cores: a 64-key
//     tile at <128, 128> moves about 544 KB through it (TMA's raw tile, the
//     split's reads and writes, the wgmma operands), some 4,350 clocks at
//     128 bytes a clock against 3,072 of products at the TF32 rate.
//
// Left for later: persistent blocks, a GQA group packed into one block,
// and a split over keys for short query counts; in float32, fewer bytes
// through shared memory a tile (two consumer warpgroups sharing each split
// tile, which Q's parts leave no room for at D_q > 64 with 64-key tiles).
// No output is allocated here: the caller passes the output and the
// stream.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fa {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  int64_t b, h, s;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides q_st, k_st, v_st, o_st;
  int64_t sq, sk, window;
  int group, dq, dv, causal;
  float scale_log2;              // log2(e) / sqrt(D_q): scores in base 2
};

// The key tiles [*t_begin, *t_end) of BK keys that meet the band of the
// query tile of BQ rows starting at row q0.
template <int BQ, int BK>
__device__ __forceinline__ void key_tiles(const Params& p, int64_t q0,
                                          int64_t* t_begin, int64_t* t_end) {
  int64_t k_begin = 0, k_end = p.sk;
  if (p.causal && q0 + BQ < k_end) k_end = q0 + BQ;
  if (p.window > 0 && q0 - p.window + 1 > 0) k_begin = q0 - p.window + 1;
  *t_begin = k_begin / BK;
  *t_end = k_end > k_begin ? (k_end + BK - 1) / BK : *t_begin;
}

// ---------------------------------------------------------------- bf16

constexpr int kTileQ = 128;              // query rows per block
constexpr int kTileK = 128;              // keys per stage of the ring
constexpr int kStages = 2;               // stages of the K/V ring
constexpr int kConsumers = 2;            // warpgroups of 64 query rows
constexpr int kWgThreads = 128 * (kConsumers + 1);
constexpr int kBoxCols = 64;             // columns of a TMA box: 128 bytes
constexpr uint32_t kBoxBytes = kTileK * kBoxCols * 2;
constexpr uint32_t kAtomBytes = 8 * 128; // one 8-row swizzle atom

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box (64 columns x 128 rows, 128-byte swizzle) of a 4-d tensor map at
// (column, row, head, batch) into dst; completes on bar's transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head), "r"(batch)
      : "memory");
}

// A wgmma operand in shared memory with the 128-byte swizzle: start
// address, leading and stride byte offsets.  K-major (Q, K): the stride
// offset steps 8 rows; the leading one is unused.  MN-major (V): the
// stride offset steps 8 keys, the leading one the next 64 columns (box).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead,
                                              uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lead >> 4) << 16 |
         (uint64_t)(stride >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from touching registers that an in-flight wgmma reads
// or writes: after this the values count as rewritten here.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (+)= a b: m64n128k16, a and b from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += a b: m64n128k16, a from registers, b from shared memory MN-major
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a b: m64n64k16, a from registers, b from shared memory MN-major
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// Shared memory, from a 1024-byte aligned base: Q, then the ring's stages
// of K and V, Q and K each DQ / 64 boxes of 128 rows x 64 columns and V
// DV / 64; then the barriers: Q's, and each stage's K full, V full, K
// empty, V empty.
template <int DQ, int DV>
struct Layout {
  static constexpr uint32_t kQTile = DQ / kBoxCols * kBoxBytes;   // Q and K
  static constexpr uint32_t kVTile = DV / kBoxCols * kBoxBytes;
  static constexpr uint32_t kBars = kQTile + kStages * (kQTile + kVTile);
  static constexpr int kSmem = 1024 + kBars + 8 * (1 + 4 * kStages);
  static_assert(kSmem <= 232448, "over the 227 KB of shared memory a block may use");
  uint32_t base;
  __device__ uint32_t q() const { return base; }
  __device__ uint32_t k(int s) const { return base + kQTile + s * (kQTile + kVTile); }
  __device__ uint32_t v(int s) const { return k(s) + kQTile; }
  __device__ uint32_t q_full() const { return base + kBars; }
  __device__ uint32_t k_full(int s) const { return q_full() + 8 * (1 + s); }
  __device__ uint32_t v_full(int s) const { return k_full(s) + 8 * kStages; }
  __device__ uint32_t k_empty(int s) const { return v_full(s) + 8 * kStages; }
  __device__ uint32_t v_empty(int s) const { return k_empty(s) + 8 * kStages; }
};

// S = Q K^T for a warpgroup's 64 rows: k-steps of 16 columns of D, 32 bytes
// apart inside a box's swizzled 128-byte rows, the second box past 64.
template <int DQ>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_rows,
                                         uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < DQ / 16; ++kk) {
    const uint32_t col = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_ss_n128(sc, smem_desc(q_rows + col, 16, kAtomBytes),
                  smem_desc(k_tile + col, 16, kAtomBytes), kk > 0);
  }
}

// O += P V: k-steps of 16 keys, two swizzle atoms of V's rows apart.
template <int DV>
__device__ __forceinline__ void issue_pv(float (&o)[DV / 2],
                                         const uint32_t (&pa)[kTileK / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kTileK / 16; ++kk) {
    const uint64_t dv = smem_desc(v_tile + kk * 2 * kAtomBytes, kBoxBytes, kAtomBytes);
    if constexpr (DV == 128)
      wgmma_rs_n128(o, pa[kk], dv);
    else
      wgmma_rs_n64(o, pa[kk], dv);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A consumer thread's two rows, row0 and row1 = row0 + 8 of its warpgroup's
// 64 (element 4 j + e of an accumulator is row e < 2 ? row0 : row1, column
// 8 j + 2 t + (e & 1)): the keys [lo, hi] each may see, its running max in
// units of the raw score, and this lane's share of its sum.
struct Rows {
  int lo0, hi0, lo1, hi1;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
};

// Turns the scores of the key tile at k0 into probabilities in place and
// updates the rows' max and sum; returns in alpha the factors that rescale
// the rows' accumulators.  On a tile that crosses the band's edge (EDGE) a
// masked score enters as -inf: the max still starts from the reference's
// -1e30, and exp2 gives a masked score exactly 0, also in a row that has
// seen no valid key yet (then alpha = 1 and the sum stays 0).
template <bool EDGE, int N>
__device__ __forceinline__ void softmax_tile(float (&sc)[N], float scale_log2,
                                             Rows& r, int k0, int t,
                                             float& alpha0, float& alpha1) {
  const int lo0 = r.lo0 - k0 - 2 * t, hi0 = r.hi0 - k0 - 2 * t;
  const int lo1 = r.lo1 - k0 - 2 * t, hi1 = r.hi1 - k0 - 2 * t;
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    if constexpr (EDGE) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + (e & 1);
        const bool ok = e < 2 ? c >= lo0 && c <= hi0 : c >= lo1 && c <= hi1;
        sc[4 * j + e] = ok ? sc[4 * j + e] : -INFINITY;
      }
    }
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(r.m0, mx0), mn1 = fmaxf(r.m1, mx1);
  alpha0 = ex2((r.m0 - mn0) * scale_log2);
  alpha1 = ex2((r.m1 - mn1) * scale_log2);
  r.m0 = mn0;
  r.m1 = mn1;
  const float ms0 = mn0 * scale_log2, ms1 = mn1 * scale_log2;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], scale_log2, e < 2 ? -ms0 : -ms1));
    sum0 += sc[4 * j] + sc[4 * j + 1];
    sum1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  r.l0 = r.l0 * alpha0 + sum0;
  r.l1 = r.l1 * alpha1 + sum1;
}

// P in bf16 as the A fragments of the P.V k-steps: the scores of keys
// 16 kk .. 16 kk + 15 are accumulator elements 8 kk .. 8 kk + 7.
__device__ __forceinline__ void pack_p(const float (&sc)[64],
                                       uint32_t (&pa)[kTileK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kTileK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float alpha0, float alpha1) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= alpha0;
    o[4 * j + 1] *= alpha0;
    o[4 * j + 2] *= alpha1;
    o[4 * j + 3] *= alpha1;
  }
}

template <int DQ, int DV>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const Params p) {
  using L_t = Layout<DQ, DV>;
  constexpr int QK_BOXES = DQ / kBoxCols, V_BOXES = DV / kBoxCols;
  extern __shared__ unsigned char smem_raw[];
  const L_t L{(smem_addr(smem_raw) + 1023u) & ~1023u};

  // S_q, S_k < 2^31 (the entry point checks): rows and keys fit an int
  const int q0 = (int)(gridDim.x - 1 - blockIdx.x) * kTileQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  int64_t t_begin, t_end;
  key_tiles<kTileQ, kTileK>(p, q0, &t_begin, &t_end);
  const int k_first = (int)t_begin * kTileK, n_tiles = (int)(t_end - t_begin);

  if (threadIdx.x == 0) {
    mbar_init(L.q_full(), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(L.k_full(s), 1);
      mbar_init(L.v_full(s), 1);
      mbar_init(L.k_empty(s), 4 * kConsumers);   // one arrival a warp
      mbar_init(L.v_empty(s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer: one thread keeps the ring full; tile i goes to stage
    // i % kStages once both consumers have released the tile before it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(L.q_full(), L_t::kQTile);
      for (int c = 0; c < QK_BOXES; ++c)
        tma_load(L.q() + c * kBoxBytes, &tq, L.q_full(), c * kBoxCols, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages, k0 = k_first + i * kTileK;
        const uint32_t parity = ((i / kStages) & 1) ^ 1;   // round 0 passes
        mbar_wait(L.k_empty(s), parity);
        mbar_expect_tx(L.k_full(s), L_t::kQTile);
        for (int c = 0; c < QK_BOXES; ++c)
          tma_load(L.k(s) + c * kBoxBytes, &tk, L.k_full(s), c * kBoxCols, k0, hk, b);
        mbar_wait(L.v_empty(s), parity);
        mbar_expect_tx(L.v_full(s), L_t::kVTile);
        for (int c = 0; c < V_BOXES; ++c)
          tma_load(L.v(s) + c * kBoxBytes, &tv, L.v_full(s), c * kBoxCols, k0, hk, b);
      }
    }
  } else {
    // consumer warpgroup wg: query rows q0 + 64 wg .. + 63, 16 a warp.
    // Tile i's Q K^T is issued before tile i - 1's P V, so tile i's softmax
    // runs while the tensor cores work on P V.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int lane = threadIdx.x % 32, t = lane % 4;
    const int r_lo = q0 + 64 * wg;
    const int row0 = r_lo + 16 * (threadIdx.x / 32 % 4) + lane / 4, row1 = row0 + 8;
    const int sk = (int)p.sk, window = (int)p.window;
    Rows r;
    r.hi0 = p.causal ? min(row0, sk - 1) : sk - 1;
    r.hi1 = p.causal ? min(row1, sk - 1) : sk - 1;
    r.lo0 = window > 0 ? row0 - window + 1 : 0;
    r.lo1 = window > 0 ? row1 - window + 1 : 0;
    // a tile needs the mask only where it crosses the band's edge for one
    // of the warpgroup's rows
    auto softmax = [&](float(&sc)[64], int k0, float& alpha0, float& alpha1) {
      if (k0 + kTileK > sk || (p.causal && k0 + kTileK - 1 > r_lo) ||
          (window > 0 && k0 <= r_lo + 63 - window))
        softmax_tile<true>(sc, p.scale_log2, r, k0, t, alpha0, alpha1);
      else
        softmax_tile<false>(sc, p.scale_log2, r, k0, t, alpha0, alpha1);
    };
    const uint32_t q_rows = L.q() + wg * 64 * 128;
    float o[DV / 2], sc[64], alpha0, alpha1;
    uint32_t pa[kTileK / 16][4];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;

    mbar_wait(L.q_full(), 0);
    if (n_tiles > 0) {
      mbar_wait(L.k_full(0), 0);
      wgmma_fence();
      issue_qk<DQ>(sc, q_rows, L.k(0));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(L.k_empty(0));
      softmax(sc, k_first, alpha0, alpha1);
      pack_p(sc, pa);
    }
    for (int i = 1; i < n_tiles; ++i) {
      const int s = i % kStages, sp = (i - 1) % kStages;
      mbar_wait(L.k_full(s), (i / kStages) & 1);
      mbar_wait(L.v_full(sp), ((i - 1) / kStages) & 1);
      wgmma_fence();
      issue_qk<DQ>(sc, q_rows, L.k(s));
      wgmma_commit();
      issue_pv<DV>(o, pa, L.v(sp));
      wgmma_commit();
      wgmma_wait<1>();                     // Q K^T done, P V in flight
      fence_regs(sc);
      if (lane == 0) mbar_arrive(L.k_empty(s));
      softmax(sc, k_first + i * kTileK, alpha0, alpha1);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(L.v_empty(sp));
      rescale(o, alpha0, alpha1);
      pack_p(sc, pa);
    }
    if (n_tiles > 0) {
      const int sp = (n_tiles - 1) % kStages;
      mbar_wait(L.v_full(sp), ((n_tiles - 1) / kStages) & 1);
      wgmma_fence();
      issue_pv<DV>(o, pa, L.v(sp));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(L.v_empty(sp));
    }

    float l0 = r.l0, l1 = r.l1;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + b * p.o_st.b + h * p.o_st.h;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col >= p.dv) continue;
      if (row0 < p.sq)
        *reinterpret_cast<uint32_t*>(ob + row0 * p.o_st.s + col) =
            pack_bf16(o[4 * j] / d0, o[4 * j + 1] / d0);
      if (row1 < p.sq)
        *reinterpret_cast<uint32_t*>(ob + row1 * p.o_st.s + col) =
            pack_bf16(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
    }
  }
}

// ---------------------------------------------------------------- float32

constexpr int kF32Rows = 64;             // query rows a block: one consumer warpgroup
constexpr int kF32Threads = 256;         // the consumer warpgroup, then the producer's

// v rounded to TF32 (10 explicit mantissa bits), to nearest, ties away from
// zero, as covar_xtx.cu rounds its 3xTF32 operands
__device__ __forceinline__ float tf32(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xFFFFE000u);
}

// A K-major operand in shared memory without swizzle: 8-row x 16-byte core
// matrices, the next one along K 128 bytes on, along M or N sbo bytes on.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(128 >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32;
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (+)= a b: m64n32k8, tf32, a and b K-major in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= a b: m64n64k8, tf32, a and b K-major in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= a b: m64n64k8, tf32, a from registers, b K-major in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (+)= a b: m64n128k8, tf32, a from registers, b K-major in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (+)= a b: m64n192k8, tf32, a from registers, b K-major in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[96], const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Shared memory, from a 1024-byte aligned base: the raw buffer into which
// TMA loads a K or a V tile as it lies (boxes of 32 columns x BK keys, the
// 128-byte swizzle); the high and low TF32 parts of Q (64 rows x DQ), of
// one K tile (BK keys x DQ) and of one V tile transposed (DV x BK keys),
// each part K-major in core matrices (8 rows x 16 bytes for every 4
// columns of K in turn, then the next 8 rows), the low part right after
// the high; then the barriers Q full, K full, K empty, V full, V empty and
// raw full.  BK is 64 keys up to D_q = 128 and 32 past it, where 64-key
// tiles would not fit.
template <int DQ, int DV>
struct F32Layout {
  static constexpr int kKeys = DQ > 128 ? 32 : 64;
  static constexpr uint32_t kRaw = kKeys * DQ * 4;      // K's raw tile, V's fits
  static constexpr uint32_t kQ = kF32Rows * DQ * 4;     // bytes of one part
  static constexpr uint32_t kK = kKeys * DQ * 4;
  static constexpr uint32_t kV = kKeys * DV * 4;
  static constexpr uint32_t kBars = kRaw + 2 * (kQ + kK + kV);
  static constexpr int kSmem = 1024 + kBars + 8 * 6;
  static_assert(kSmem <= 232448, "over the 227 KB of shared memory a block may use");
  unsigned char* base;
  __device__ unsigned char* raw() const { return base; }
  __device__ unsigned char* q() const { return base + kRaw; }
  __device__ unsigned char* k() const { return q() + 2 * kQ; }
  __device__ unsigned char* v() const { return k() + 2 * kK; }
  __device__ uint32_t bar(int i) const { return smem_addr(base + kBars + 8 * i); }
  __device__ uint32_t q_full() const { return bar(0); }
  __device__ uint32_t k_full() const { return bar(1); }
  __device__ uint32_t k_empty() const { return bar(2); }
  __device__ uint32_t v_full() const { return bar(3); }
  __device__ uint32_t v_empty() const { return bar(4); }
  __device__ uint32_t raw_full() const { return bar(5); }
};

// A producer thread's share of the rows r0 .. r0 + R - 1 of a (rows, d)
// float operand, C columns (zeros past n_rows and past d): task
// e = tid + 128 j is row e % 8 + 8 ((e / 8) / (C / 4)) and columns
// 4 ((e / 8) % (C / 4)) .. + 3.  A warp reads 8 rows x 64 bytes a load,
// and the task's four values are row e % 8 of core matrix e / 8 of the
// K-major layout: they go to byte 16 e (split_rows).
template <int R, int C>
__device__ __forceinline__ void load_rows(float4 (&x)[R * C / 512], const float* base,
                                          int64_t stride, int64_t r0, int64_t n_rows,
                                          int d, int tid) {
#pragma unroll
  for (int j = 0; j < R * C / 512; ++j) {
    const int e = tid + 128 * j;
    const int cg = (e >> 3) % (C / 4);
    const int64_t row = r0 + (e & 7) + 8 * ((e >> 3) / (C / 4));
    x[j] = row < n_rows && 4 * cg < d
               ? __ldg(reinterpret_cast<const float4*>(base + row * stride + 4 * cg))
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ void split_store(unsigned char* hi, uint32_t lo_off,
                                            uint32_t at, const float (&x)[4]) {
  float h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = tf32(x[i]);
    l[i] = tf32(x[i] - h[i]);
  }
  *reinterpret_cast<float4*>(hi + at) = make_float4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<float4*>(hi + lo_off + at) = make_float4(l[0], l[1], l[2], l[3]);
}

template <int N>
__device__ __forceinline__ void split_rows(unsigned char* hi, uint32_t lo_off,
                                           const float4 (&x)[N], int tid) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float v[4] = {x[j].x, x[j].y, x[j].z, x[j].w};
    split_store(hi, lo_off, 16u * (tid + 128 * j), v);
  }
}

// The float at (row, column) of a tile in the raw buffer: box column / 32,
// 16-byte chunk (column % 32) / 4 of the row at chunk ^ (row % 8).
template <int BK>
__device__ __forceinline__ const float* raw_at(const unsigned char* raw, int row, int col) {
  return reinterpret_cast<const float*>(raw + (col >> 5) * BK * 128 + row * 128 +
                                        ((((col >> 2) & 7) ^ (row & 7)) << 4) + (col & 3) * 4);
}

// K's tile from the raw buffer, split K-major as split_rows stores it:
// task e = tid + 128 j is row e % 8 + 8 ((e / 8) / (DQ / 4)), columns
// 4 ((e / 8) % (DQ / 4)) .. + 3, row e % 8 of core matrix e / 8, byte 16 e.
// The 8 lanes of a quarter warp read 8 rows' chunks, 8 distinct chunks
// after the swizzle.
template <int BK, int DQ>
__device__ __forceinline__ void split_k(const unsigned char* raw, unsigned char* hi,
                                        uint32_t lo_off, int tid) {
#pragma unroll
  for (int j = 0; j < BK * DQ / 512; ++j) {
    const int e = tid + 128 * j;
    const int row = (e & 7) + 8 * ((e >> 3) / (DQ / 4)), col = 4 * ((e >> 3) % (DQ / 4));
    const float4 x = *reinterpret_cast<const float4*>(raw_at<BK>(raw, row, col));
    const float v[4] = {x.x, x.y, x.z, x.w};
    split_store(hi, lo_off, 16u * e, v);
  }
}

// V's tile from the raw buffer, split and stored transposed (Vᵀ K-major:
// the keys along K).  Task e = tid + 128 j is column d = e % DV and core
// c = e / DV along K; a core holds keys 8 (c / 2) + c % 2 + {0, 2, 4, 6}:
// the keys of a k-step in the order 0, 2, 4, 6, 1, 3, 5, 7, the order in
// which a thread holds P's columns (see split_p).  A warp reads 32
// consecutive columns of one key (one swizzled 128-byte row); 8
// consecutive columns store to 8 rows of one core matrix.
template <int BK, int DV>
__device__ __forceinline__ void split_v(const unsigned char* raw, unsigned char* hi,
                                        uint32_t lo_off, int tid) {
#pragma unroll
  for (int j = 0; j < BK * DV / 512; ++j) {
    const int e = tid + 128 * j, d = e % DV, c = e / DV;
    const int key = 8 * (c >> 1) + (c & 1);
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = *raw_at<BK>(raw, key + 2 * i, d);
    split_store(hi, lo_off, (uint32_t)((d >> 3) * BK * 32 + c * 128 + (d & 7) * 16), x);
  }
}

// P's probabilities as the A fragments of the P.V k-steps, high and low
// TF32 parts.  A tf32 A fragment gives lane (g, t) columns t and t + 4 of
// rows g and g + 8; the thread holds keys 2 t and 2 t + 1 of each 8 (the
// S accumulator's layout), so column t stands for key 2 t and column t + 4
// for key 2 t + 1, and split_v stores V's keys in that order.
template <int BK>
__device__ __forceinline__ void split_p(const float (&sc)[BK / 2],
                                        uint32_t (&ph)[BK / 8][4],
                                        uint32_t (&pl)[BK / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    const float v[4] = {sc[4 * kk], sc[4 * kk + 2], sc[4 * kk + 1], sc[4 * kk + 3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float h = tf32(v[i]);
      ph[kk][i] = __float_as_uint(h);
      pl[kk][i] = __float_as_uint(tf32(v[i] - h));
    }
  }
}

// S = Q K^T for the tile in shared memory, three products a k-step of 8
// columns of D: hi.lo + lo.hi + hi.hi (the low parts' product, 2^-22 of a
// term, is dropped).  The small products of every k-step go first, while
// the accumulators are small, and the hi.hi products last: the tensor
// cores' adds lose most on a large accumulator.
template <int DQ, int DV>
__device__ __forceinline__ void issue_qk_tf32(float (&sc)[F32Layout<DQ, DV>::kKeys / 2],
                                              uint32_t q, uint32_t k) {
  using L_t = F32Layout<DQ, DV>;
#pragma unroll
  for (int kk = 0; kk < DQ / 8; ++kk) {
    const uint32_t qa = q + kk * 256, ka = k + kk * 256;
    wgmma_tf32(sc, desc_k_major(qa, DQ * 32), desc_k_major(ka + L_t::kK, DQ * 32), kk > 0);
    wgmma_tf32(sc, desc_k_major(qa + L_t::kQ, DQ * 32), desc_k_major(ka, DQ * 32), 1);
  }
#pragma unroll
  for (int kk = 0; kk < DQ / 8; ++kk)
    wgmma_tf32(sc, desc_k_major(q + kk * 256, DQ * 32), desc_k_major(k + kk * 256, DQ * 32), 1);
}

// The tile's P.V into fresh accumulators, three products a k-step of 8 keys.
template <int DQ, int DV>
__device__ __forceinline__ void issue_pv_tf32(
    float (&acc)[DV / 2], const uint32_t (&ph)[F32Layout<DQ, DV>::kKeys / 8][4],
    const uint32_t (&pl)[F32Layout<DQ, DV>::kKeys / 8][4], uint32_t v) {
  using L_t = F32Layout<DQ, DV>;
  constexpr uint32_t kSbo = L_t::kKeys * 32;
#pragma unroll
  for (int kk = 0; kk < L_t::kKeys / 8; ++kk) {
    const uint32_t va = v + kk * 256;
    wgmma_tf32(acc, ph[kk], desc_k_major(va + L_t::kV, kSbo), kk > 0);
    wgmma_tf32(acc, pl[kk], desc_k_major(va, kSbo), 1);
    wgmma_tf32(acc, ph[kk], desc_k_major(va, kSbo), 1);
  }
}

// One block per (64 query rows, head, batch): warpgroup 0 multiplies and
// runs the softmax, warpgroup 1 loads and splits, each split tile into its
// buffer as soon as the consumer releases that: K once Q K^T is done, V
// once P V is done.
template <int DQ, int DV>
__global__ void __launch_bounds__(kF32Threads, 1)
    flash_kernel_tf32(const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const Params p) {
  using L_t = F32Layout<DQ, DV>;
  constexpr int BK = L_t::kKeys;
  extern __shared__ unsigned char smem_raw[];
  const L_t L{smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u)};

  // S_q, S_k < 2^30 (launch_f32 checks): rows and keys fit an int
  const int q0 = (int)(gridDim.x - 1 - blockIdx.x) * kF32Rows;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  int64_t t_begin, t_end;
  key_tiles<kF32Rows, BK>(p, q0, &t_begin, &t_end);
  const int k_first = (int)t_begin * BK, n_tiles = (int)(t_end - t_begin);

  if (threadIdx.x == 0) {
    mbar_init(L.q_full(), 128);
    mbar_init(L.k_full(), 128);
    mbar_init(L.v_full(), 128);
    mbar_init(L.k_empty(), 4);   // one arrival a consumer warp
    mbar_init(L.v_empty(), 4);
    mbar_init(L.raw_full(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer: one thread has TMA load each tile into the raw buffer, all
    // 128 split it into its buffer once the consumer frees that.  V trails
    // K by a tile: K i is split as soon as Q K^T of tile i - 1 is done,
    // then V i - 1's load takes the raw buffer while the consumer's P V of
    // tile i - 2 finishes, and K i + 1's load follows V i - 1's split.
    const int tid = threadIdx.x - 128;
    uint32_t raw_loads = 0;
    auto load_raw = [&](const CUtensorMap* map, int boxes, int k0) {
      fence_proxy_async();   // this thread's reads of the raw buffer, before TMA's writes
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      if (tid == 0) {
        mbar_expect_tx(L.raw_full(), boxes * BK * 128);
        for (int c = 0; c < boxes; ++c)
          tma_load(smem_addr(L.raw()) + c * BK * 128, map, L.raw_full(), 32 * c, k0, hk, b);
      }
    };
    auto wait_raw = [&] { mbar_wait(L.raw_full(), raw_loads++ & 1); };
    if (n_tiles > 0) load_raw(&tk, DQ / 32, k_first);
    {
      float4 qx[kF32Rows * DQ / 512];
      load_rows<kF32Rows, DQ>(qx, static_cast<const float*>(p.q) + b * p.q_st.b + h * p.q_st.h,
                              p.q_st.s, q0, p.sq, p.dq, tid);
      split_rows(L.q(), L_t::kQ, qx, tid);
      fence_proxy_async();   // the stores, visible to the tensor cores
      mbar_arrive(L.q_full());
    }
    for (int i = 0; i <= n_tiles; ++i) {
      if (i < n_tiles) {
        wait_raw();
        mbar_wait(L.k_empty(), (i & 1) ^ 1);   // the first round passes
        split_k<BK, DQ>(L.raw(), L.k(), L_t::kK, tid);
        fence_proxy_async();
        mbar_arrive(L.k_full());
      }
      if (i > 0) {
        load_raw(&tv, DV / 32, k_first + (i - 1) * BK);
        wait_raw();
        mbar_wait(L.v_empty(), i & 1);          // V i - 2's P V done; the first round passes
        split_v<BK, DV>(L.raw(), L.v(), L_t::kV, tid);
        fence_proxy_async();
        mbar_arrive(L.v_full());
      }
      if (i + 1 < n_tiles) load_raw(&tk, DQ / 32, k_first + (i + 1) * BK);
    }
  } else {
    // consumer: rows q0 .. q0 + 63, 16 a warp.  Tile i's Q K^T is issued
    // with tile i - 1's P V, and tile i's softmax runs while P V is on the
    // tensor cores.  Each tile's P V goes into fresh accumulators, added to
    // the float32 output sums afterwards.
    const int lane = threadIdx.x % 32, t = lane % 4;
    const int row0 = q0 + 16 * (threadIdx.x / 32) + lane / 4, row1 = row0 + 8;
    const int sk = (int)p.sk, window = (int)p.window;
    Rows r;
    r.hi0 = p.causal ? min(row0, sk - 1) : sk - 1;
    r.hi1 = p.causal ? min(row1, sk - 1) : sk - 1;
    r.lo0 = window > 0 ? row0 - window + 1 : 0;
    r.lo1 = window > 0 ? row1 - window + 1 : 0;
    auto softmax = [&](float(&sc)[BK / 2], int k0, float& alpha0, float& alpha1) {
      if (k0 + BK > sk || (p.causal && k0 + BK - 1 > q0) ||
          (window > 0 && k0 <= q0 + kF32Rows - 1 - window))
        softmax_tile<true>(sc, p.scale_log2, r, k0, t, alpha0, alpha1);
      else
        softmax_tile<false>(sc, p.scale_log2, r, k0, t, alpha0, alpha1);
    };
    const uint32_t q = smem_addr(L.q()), k = smem_addr(L.k()), v = smem_addr(L.v());
    float o[DV / 2], acc[DV / 2], sc[BK / 2], alpha0, alpha1;
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;

    mbar_wait(L.q_full(), 0);
    if (n_tiles > 0) {
      mbar_wait(L.k_full(), 0);
      wgmma_fence();
      issue_qk_tf32<DQ, DV>(sc, q, k);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(L.k_empty());
      softmax(sc, k_first, alpha0, alpha1);
      split_p<BK>(sc, ph, pl);
    }
    for (int i = 1; i < n_tiles; ++i) {
      mbar_wait(L.k_full(), i & 1);
      wgmma_fence();
      issue_qk_tf32<DQ, DV>(sc, q, k);
      wgmma_commit();
      mbar_wait(L.v_full(), (i - 1) & 1);
      issue_pv_tf32<DQ, DV>(acc, ph, pl, v);
      wgmma_commit();
      wgmma_wait<1>();                     // Q K^T done, P V in flight
      fence_regs(sc);
      if (lane == 0) mbar_arrive(L.k_empty());
      softmax(sc, k_first + i * BK, alpha0, alpha1);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      if (lane == 0) mbar_arrive(L.v_empty());
      // o holds the sums up to tile i - 2 at tile i - 1's max: add tile
      // i - 1's, then move to tile i's max
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        o[4 * j] = (o[4 * j] + acc[4 * j]) * alpha0;
        o[4 * j + 1] = (o[4 * j + 1] + acc[4 * j + 1]) * alpha0;
        o[4 * j + 2] = (o[4 * j + 2] + acc[4 * j + 2]) * alpha1;
        o[4 * j + 3] = (o[4 * j + 3] + acc[4 * j + 3]) * alpha1;
      }
      split_p<BK>(sc, ph, pl);
    }
    if (n_tiles > 0) {
      mbar_wait(L.v_full(), (n_tiles - 1) & 1);
      wgmma_fence();
      issue_pv_tf32<DQ, DV>(acc, ph, pl, v);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      if (lane == 0) mbar_arrive(L.v_empty());
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] += acc[i];
    }

    float l0 = r.l0, l1 = r.l1;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    float* ob = static_cast<float*>(p.o) + b * p.o_st.b + h * p.o_st.h;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col >= p.dv) continue;
      if (row0 < p.sq)
        *reinterpret_cast<float2*>(ob + row0 * p.o_st.s + col) =
            make_float2(o[4 * j] / d0, o[4 * j + 1] / d0);
      if (row1 < p.sq)
        *reinterpret_cast<float2*>(ob + row1 * p.o_st.s + col) =
            make_float2(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
    }
  }
}

// cuTensorMapEncodeTiled looked up at run time through the CUDA runtime,
// so the library links against the runtime alone (no -lcuda)
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                         cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// The 4-d map (D, rows, heads, batch) of a bf16 or float32 operand with its
// own strides: boxes of 128 bytes of columns (64 or 32) x box_rows rows,
// 128-byte swizzle, zeros out of bounds.
// A dimension of size 1 with a stride of 0 gets the packed one: TMA wants
// each stride a positive multiple of 16 bytes.
inline bool encode_map(CUtensorMap* map, const void* ptr, int d, int64_t rows,
                       int heads, int batch, const Strides& st, bool bf16 = true,
                       int box_rows = kTileK) {
  const cuuint64_t size = bf16 ? 2 : 4;   // bytes an element
  auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const int64_t sizes[3] = {rows, heads, batch};
  const int64_t steps[3] = {st.s, st.h, st.b};
  cuuint64_t dims[4] = {(cuuint64_t)d, 0, 0, 0};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = (cuuint64_t)sizes[i];
    const cuuint64_t packed = i == 0 ? size * (cuuint64_t)d : strides[i - 1] * dims[i];
    strides[i] = sizes[i] == 1 && steps[i] == 0 ? packed : size * (cuuint64_t)steps[i];
  }
  cuuint32_t box[4] = {(cuuint32_t)(128 / size), (cuuint32_t)box_rows, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                4, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQ, int DV>
int launch_bf16(const Params& p, int batch, int heads, int kv_heads,
                cudaStream_t stream) {
  if (p.sq >= (int64_t)1 << 30 || p.sk >= (int64_t)1 << 30)
    return (int)cudaErrorInvalidValue;   // rows and keys are ints in the kernel
  CUtensorMap tq, tk, tv;
  // with no keys no K/V tile is loaded: Q's map stands in for theirs
  const bool keys = p.sk > 0;
  if (!encode_map(&tq, p.q, p.dq, p.sq, heads, batch, p.q_st) ||
      !encode_map(&tk, keys ? p.k : p.q, p.dq, keys ? p.sk : p.sq,
                  keys ? kv_heads : heads, batch, keys ? p.k_st : p.q_st) ||
      !encode_map(&tv, keys ? p.v : p.q, p.dv, keys ? p.sk : p.sq,
                  keys ? kv_heads : heads, batch, keys ? p.v_st : p.q_st))
    return (int)cudaErrorInvalidValue;
  const auto kernel = flash_kernel_wgmma<DQ, DV>;
  const int smem = Layout<DQ, DV>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((p.sq + kTileQ - 1) / kTileQ), (unsigned)heads,
                  (unsigned)batch);
  kernel<<<grid, kWgThreads, smem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

template <int DQ, int DV>
int launch_f32(const Params& p, int batch, int heads, int kv_heads, cudaStream_t stream) {
  if (p.sq >= (int64_t)1 << 30 || p.sk >= (int64_t)1 << 30)
    return (int)cudaErrorInvalidValue;   // rows and keys are ints in the kernel
  constexpr int BK = F32Layout<DQ, DV>::kKeys;
  CUtensorMap tk, tv;
  // with no keys no tile is loaded: Q's map stands in for theirs
  const bool keys = p.sk > 0;
  if (!encode_map(&tk, keys ? p.k : p.q, p.dq, keys ? p.sk : p.sq,
                  keys ? kv_heads : heads, batch, keys ? p.k_st : p.q_st, false, BK) ||
      !encode_map(&tv, keys ? p.v : p.q, p.dv, keys ? p.sk : p.sq,
                  keys ? kv_heads : heads, batch, keys ? p.v_st : p.q_st, false, BK))
    return (int)cudaErrorInvalidValue;
  const auto kernel = flash_kernel_tf32<DQ, DV>;
  const int smem = F32Layout<DQ, DV>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((p.sq + kF32Rows - 1) / kF32Rows), (unsigned)heads,
                  (unsigned)batch);
  kernel<<<grid, kF32Threads, smem, stream>>>(tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace fa

// strides: 12 element strides, (batch, head, sequence) of q, k, v and o in
// that order.  The wrapper checks what the kernel assumes: D_q and D_v
// multiples of 8 with D_v <= D_q <= 192 (bf16: D_v <= 128 where D_q > 128),
// H a multiple of H_kv, 16-byte aligned rows, S_q > 0.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, const int64_t* strides, int bf16,
                               int batch, int heads, int kv_heads, int64_t sq,
                               int64_t sk, int dq, int dv, int causal,
                               int64_t window, void* stream) {
  using namespace fa;
  if (dv <= 0 || dv > dq || dq > 192 || dq % 8 != 0 || dv % 8 != 0 ||
      (bf16 && dq > 128 && dv > 128) || kv_heads <= 0 || heads % kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  Strides* st[4] = {&p.q_st, &p.k_st, &p.v_st, &p.o_st};
  for (int i = 0; i < 4; ++i) {
    st[i]->b = strides[3 * i];
    st[i]->h = strides[3 * i + 1];
    st[i]->s = strides[3 * i + 2];
  }
  p.sq = sq;
  p.sk = sk;
  p.window = window;
  p.group = heads / kv_heads;
  p.dq = dq;
  p.dv = dv;
  p.causal = causal;
  p.scale_log2 = kLog2e / sqrtf((float)dq);
  cudaStream_t s = (cudaStream_t)stream;
  // the narrowest instance that holds both widths: TMA fills zeros past
  // D_q and D_v, and only D_v columns are written
  if (bf16) {
    if (dq <= 64) return launch_bf16<64, 64>(p, batch, heads, kv_heads, s);
    if (dq <= 128) return launch_bf16<128, 128>(p, batch, heads, kv_heads, s);
    return launch_bf16<192, 128>(p, batch, heads, kv_heads, s);
  }
  if (dq <= 64) return launch_f32<64, 64>(p, batch, heads, kv_heads, s);
  if (dq <= 128) return launch_f32<128, 128>(p, batch, heads, kv_heads, s);
  return dv <= 128 ? launch_f32<192, 128>(p, batch, heads, kv_heads, s)
                   : launch_f32<192, 192>(p, batch, heads, kv_heads, s);
}

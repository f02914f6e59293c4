// flash_attention: blockwise attention with an online softmax,
//   o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h / g, j] / sqrt(D)) v[b, h / g, j]
// over the keys j the mask allows: j < S_k; j <= i when causal; j > i - window
// when window > 0.  q, o are (B, H, S_q, D) and k, v (B, H_kv, S_k, D), each
// with its own element strides for the batch, head and sequence axes (the
// last axis is contiguous), in bf16 or float32; g = H / H_kv.
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
// (q, k) pair costs 4 D flops (D multiply-adds for the score, D for P.V)
// against itemsize B S D (2 H + 2 H_kv) bytes read and written once; at
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
//       gives zeros past S and past D (8 ... 120).
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
//       consumers to 240 a thread, so the 64 score, 64 output and 32
//       probability registers and the online softmax stay in registers;
//       one block of 160 KB fills an SM.  A row's max and sum reduce over
//       the 4 lanes that share it.
//   * float32 runs on the CUDA cores (flash_kernel_f32): 256 threads, the
//     query tile and each K tile staged transposed, V row-major; each
//     thread forms a 4 x 4 block of the 64 x 64 score tile with float4
//     reads, 16 FMAs per pair of reads, and the probabilities go through
//     shared memory to the P.V product.  float32 has no tensor-core path
//     of its own precision (TF32 keeps 10 bits), so the bound is the CUDA
//     cores' 67 TFLOP/s.
//
// Left for later: persistent blocks, a GQA group packed into one block,
// and a split over keys for short query counts.  No output is allocated
// here: the caller passes the output and the stream.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fa {

constexpr int kBQ = 64;          // query rows per block (float32)
constexpr int kBK = 64;          // keys per staged tile (float32)
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
  int group, d, causal;
  float scale_log2;              // log2(e) / sqrt(D): scores in base 2
};

// The key tiles [*t_begin, *t_end) of BK keys that meet the band of the
// query tile of BQ rows starting at row q0.
template <int BQ = kBQ, int BK = kBK>
__device__ __forceinline__ void key_tiles(const Params& p, int64_t q0,
                                          int64_t* t_begin, int64_t* t_end) {
  int64_t k_begin = 0, k_end = p.sk;
  if (p.causal && q0 + BQ < k_end) k_end = q0 + BQ;
  if (p.window > 0 && q0 - p.window + 1 > 0) k_begin = q0 - p.window + 1;
  *t_begin = k_begin / BK;
  *t_end = k_end > k_begin ? (k_end + BK - 1) / BK : *t_begin;
}

__device__ __forceinline__ bool allowed(const Params& p, int64_t row,
                                        int64_t col) {
  return col < p.sk && (!p.causal || col <= row) &&
         (p.window <= 0 || col > row - p.window);
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
// of K and V, each DMAX / 64 boxes of 128 rows x 64 columns; then the
// barriers: Q's, and each stage's K full, V full, K empty, V empty.
template <int DMAX>
struct Layout {
  static constexpr uint32_t kTile = DMAX / kBoxCols * kBoxBytes;
  static constexpr uint32_t kBars = (1 + 2 * kStages) * kTile;
  static constexpr int kSmem = 1024 + kBars + 8 * (1 + 4 * kStages);
  uint32_t base;
  __device__ uint32_t q() const { return base; }
  __device__ uint32_t k(int s) const { return base + (1 + 2 * s) * kTile; }
  __device__ uint32_t v(int s) const { return k(s) + kTile; }
  __device__ uint32_t q_full() const { return base + kBars; }
  __device__ uint32_t k_full(int s) const { return q_full() + 8 * (1 + s); }
  __device__ uint32_t v_full(int s) const { return k_full(s) + 8 * kStages; }
  __device__ uint32_t k_empty(int s) const { return v_full(s) + 8 * kStages; }
  __device__ uint32_t v_empty(int s) const { return k_empty(s) + 8 * kStages; }
};

// S = Q K^T for a warpgroup's 64 rows: k-steps of 16 columns of D, 32 bytes
// apart inside a box's swizzled 128-byte rows, the second box past 64.
template <int DMAX>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_rows,
                                         uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
    const uint32_t col = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_ss_n128(sc, smem_desc(q_rows + col, 16, kAtomBytes),
                  smem_desc(k_tile + col, 16, kAtomBytes), kk > 0);
  }
}

// O += P V: k-steps of 16 keys, two swizzle atoms of V's rows apart.
template <int DMAX>
__device__ __forceinline__ void issue_pv(float (&o)[DMAX / 2],
                                         const uint32_t (&pa)[kTileK / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kTileK / 16; ++kk) {
    const uint64_t dv = smem_desc(v_tile + kk * 2 * kAtomBytes, kBoxBytes, kAtomBytes);
    if constexpr (DMAX == 128)
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
template <bool EDGE>
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float scale_log2,
                                             Rows& r, int k0, int t,
                                             float& alpha0, float& alpha1) {
  const int lo0 = r.lo0 - k0 - 2 * t, hi0 = r.hi0 - k0 - 2 * t;
  const int lo1 = r.lo1 - k0 - 2 * t, hi1 = r.hi1 - k0 - 2 * t;
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
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
  for (int j = 0; j < 16; ++j) {
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

template <int DMAX>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int BOXES = DMAX / kBoxCols;
  extern __shared__ unsigned char smem_raw[];
  const Layout<DMAX> L{(smem_addr(smem_raw) + 1023u) & ~1023u};

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
      mbar_expect_tx(L.q_full(), Layout<DMAX>::kTile);
      for (int c = 0; c < BOXES; ++c)
        tma_load(L.q() + c * kBoxBytes, &tq, L.q_full(), c * kBoxCols, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages, k0 = k_first + i * kTileK;
        const uint32_t parity = ((i / kStages) & 1) ^ 1;   // round 0 passes
        mbar_wait(L.k_empty(s), parity);
        mbar_expect_tx(L.k_full(s), Layout<DMAX>::kTile);
        for (int c = 0; c < BOXES; ++c)
          tma_load(L.k(s) + c * kBoxBytes, &tk, L.k_full(s), c * kBoxCols, k0, hk, b);
        mbar_wait(L.v_empty(s), parity);
        mbar_expect_tx(L.v_full(s), Layout<DMAX>::kTile);
        for (int c = 0; c < BOXES; ++c)
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
    float o[DMAX / 2], sc[64], alpha0, alpha1;
    uint32_t pa[kTileK / 16][4];
#pragma unroll
    for (int i = 0; i < DMAX / 2; ++i) o[i] = 0.f;

    mbar_wait(L.q_full(), 0);
    if (n_tiles > 0) {
      mbar_wait(L.k_full(0), 0);
      wgmma_fence();
      issue_qk<DMAX>(sc, q_rows, L.k(0));
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
      issue_qk<DMAX>(sc, q_rows, L.k(s));
      wgmma_commit();
      issue_pv<DMAX>(o, pa, L.v(sp));
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
      issue_pv<DMAX>(o, pa, L.v(sp));
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
    for (int j = 0; j < DMAX / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col >= p.d) continue;
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

constexpr int kF32Threads = 256; // 16 x 16: ty picks 4 rows, tx 4 keys / columns

// Rows row0 .. row0 + 63 of a float (rows, D) operand into dst[c * 64 + r]
// (transposed), rows past n_rows as zeros.  Consecutive threads take
// consecutive rows, so the shared-memory stores do not conflict.
__device__ __forceinline__ void stage_transposed(float* dst, const float* base,
                                                 int64_t row_stride, int64_t row0,
                                                 int64_t n_rows, int d) {
  const int n_vec = d / 4;
  for (int idx = threadIdx.x; idx < 64 * n_vec; idx += kF32Threads) {
    const int r = idx % 64, c = (idx / 64) * 4;
    const int64_t row = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n_rows) x = __ldg(reinterpret_cast<const float4*>(base + row * row_stride + c));
    dst[c * 64 + r] = x.x;
    dst[(c + 1) * 64 + r] = x.y;
    dst[(c + 2) * 64 + r] = x.z;
    dst[(c + 3) * 64 + r] = x.w;
  }
}

// Rows row0 .. row0 + 63 of a float (rows, D) operand into
// dst[r * DMAX + c] (row-major), rows past n_rows as zeros; columns
// d .. DMAX - 1 untouched.
template <int DMAX>
__device__ __forceinline__ void stage_rows(float* dst, const float* base,
                                           int64_t row_stride, int64_t row0,
                                           int64_t n_rows, int d) {
  const int n_vec = d / 4;
  for (int idx = threadIdx.x; idx < 64 * n_vec; idx += kF32Threads) {
    const int r = idx / n_vec, c = (idx % n_vec) * 4;
    const int64_t row = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n_rows) x = __ldg(reinterpret_cast<const float4*>(base + row * row_stride + c));
    *reinterpret_cast<float4*>(&dst[r * DMAX + c]) = x;
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kF32Threads, 2) flash_kernel_f32(const Params p) {
  constexpr int NH = DMAX / 64;            // float4 column groups per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                        // [DMAX][kBQ]
  float* kt = qt + DMAX * kBQ;             // [DMAX][kBK]
  float* vs = kt + DMAX * kBK;             // [kBK][DMAX]
  float* pt = vs + kBK * DMAX;             // [kBK][kBQ]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t q0 = (int64_t)(gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  const float* qb = static_cast<const float*>(p.q) + b * p.q_st.b + h * p.q_st.h;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_st.b + hk * p.k_st.h;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_st.b + hk * p.v_st.h;
  float* ob = static_cast<float*>(p.o) + b * p.o_st.b + h * p.o_st.h;

  // V's columns past D are read by the P.V loop and never staged: zero them
  for (int i = tid; i < kBK * DMAX; i += kF32Threads) vs[i] = 0.f;
  stage_transposed(qt, qb, p.q_st.s, q0, p.sq, p.d);

  int64_t t_begin, t_end;
  key_tiles(p, q0, &t_begin, &t_end);
  float m[4], l[4], acc[4][4 * NH];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NH; ++j) acc[i][j] = 0.f;
  }

  for (int64_t tile = t_begin; tile < t_end; ++tile) {
    const int64_t k0 = tile * kBK;
    __syncthreads();                       // the last tile's readers are done
    stage_transposed(kt, kb, p.k_st.s, k0, p.sk, p.d);
    stage_rows<DMAX>(vs, vb, p.v_st.s, k0, p.sk, p.d);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < p.d; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&qt[c * kBQ + ty * 4]);
      const float4 kk = *reinterpret_cast<const float4*>(&kt[c * kBK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], kv[j], s[i][j]);
    }

    // mask, then the online softmax of each of the thread's 4 rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = q0 + ty * 4 + i;
      bool ok[4];
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = allowed(p, row, k0 + tx * 4 + j);
        s[i][j] = ok[j] ? s[i][j] * p.scale_log2 : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = exp2f(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = ok[j] ? exp2f(s[i][j] - m_new) : 0.f;
        row_sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * NH; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&pt[(tx * 4 + j) * kBQ + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pp = *reinterpret_cast<const float4*>(&pt[c * kBQ + ty * 4]);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int g = 0; g < NH; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&vs[c * DMAX + g * 64 + tx * 4]);
        const float vv4[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][g * 4 + j] = fmaf(pv[i], vv4[j], acc[i][g * 4 + j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty * 4 + i;
    if (row >= p.sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NH; ++g) {
      const int col = g * 64 + tx * 4;
      if (col >= p.d) continue;
      *reinterpret_cast<float4*>(ob + row * p.o_st.s + col) =
          make_float4(acc[i][g * 4] / denom, acc[i][g * 4 + 1] / denom,
                      acc[i][g * 4 + 2] / denom, acc[i][g * 4 + 3] / denom);
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, int threads, int smem, const Params& p, int batch,
           int heads, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((p.sq + kBQ - 1) / kBQ), (unsigned)heads,
                  (unsigned)batch);
  kernel<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
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

// The 4-d map (D, rows, heads, batch) of a bf16 operand with its own strides:
// boxes of 64 columns x 128 rows, 128-byte swizzle, zeros out of bounds.
// A dimension of size 1 with a stride of 0 gets the packed one: TMA wants
// each stride a positive multiple of 16 bytes.
inline bool encode_map(CUtensorMap* map, const void* ptr, int d, int64_t rows,
                       int heads, int batch, const Strides& st) {
  auto encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const int64_t sizes[3] = {rows, heads, batch};
  const int64_t steps[3] = {st.s, st.h, st.b};
  cuuint64_t dims[4] = {(cuuint64_t)d, 0, 0, 0};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = (cuuint64_t)sizes[i];
    const cuuint64_t packed = i == 0 ? 2 * (cuuint64_t)d : strides[i - 1] * dims[i];
    strides[i] = sizes[i] == 1 && steps[i] == 0 ? packed : 2 * (cuuint64_t)steps[i];
  }
  cuuint32_t box[4] = {(cuuint32_t)kBoxCols, (cuuint32_t)kTileK, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DMAX>
int launch_bf16(const Params& p, int batch, int heads, int kv_heads,
                cudaStream_t stream) {
  if (p.sq >= (int64_t)1 << 30 || p.sk >= (int64_t)1 << 30)
    return (int)cudaErrorInvalidValue;   // rows and keys are ints in the kernel
  CUtensorMap tq, tk, tv;
  // with no keys no K/V tile is loaded: Q's map stands in for theirs
  const bool keys = p.sk > 0;
  if (!encode_map(&tq, p.q, p.d, p.sq, heads, batch, p.q_st) ||
      !encode_map(&tk, keys ? p.k : p.q, p.d, keys ? p.sk : p.sq,
                  keys ? kv_heads : heads, batch, keys ? p.k_st : p.q_st) ||
      !encode_map(&tv, keys ? p.v : p.q, p.d, keys ? p.sk : p.sq,
                  keys ? kv_heads : heads, batch, keys ? p.v_st : p.q_st))
    return (int)cudaErrorInvalidValue;
  const auto kernel = flash_kernel_wgmma<DMAX>;
  const int smem = Layout<DMAX>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((p.sq + kTileQ - 1) / kTileQ), (unsigned)heads,
                  (unsigned)batch);
  kernel<<<grid, kWgThreads, smem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

template <int DMAX>
int launch_f32(const Params& p, int batch, int heads, cudaStream_t stream) {
  const int smem = (3 * DMAX * 64 + kBK * kBQ) * (int)sizeof(float);
  return launch(flash_kernel_f32<DMAX>, kF32Threads, smem, p, batch, heads,
                stream);
}

}  // namespace fa

// strides: 12 element strides, (batch, head, sequence) of q, k, v and o in
// that order.  The wrapper checks what the kernel assumes: D a multiple of
// 8 up to 128, H a multiple of H_kv, 16-byte aligned rows, S_q > 0.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, const int64_t* strides, int bf16,
                               int batch, int heads, int kv_heads, int64_t sq,
                               int64_t sk, int d, int causal, int64_t window,
                               void* stream) {
  using namespace fa;
  if (d <= 0 || d > 128 || d % 8 != 0 || kv_heads <= 0 || heads % kv_heads != 0)
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
  p.d = d;
  p.causal = causal;
  p.scale_log2 = kLog2e / sqrtf((float)d);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return d <= 64 ? launch_bf16<64>(p, batch, heads, kv_heads, s)
                   : launch_bf16<128>(p, batch, heads, kv_heads, s);
  return d <= 64 ? launch_f32<64>(p, batch, heads, s)
                 : launch_f32<128>(p, batch, heads, s);
}

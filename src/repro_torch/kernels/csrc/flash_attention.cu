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
// never replicated.  Scores, max, normaliser and accumulator are float32; a
// masked score is -1e30 (the reference's NEG_INF, not -inf), so a tile
// masked wholly for a row gives alpha = 1, not NaN; a row with no valid key
// outputs 0 (denominator clamped at 1e-30).
//
// Bound on the H100: at prefill lengths the operations.  Each unmasked
// (q, k) pair costs 4 D flops (D multiply-adds for the score, D for P.V)
// against itemsize B S D (2 H + 2 H_kv) bytes read and written once; at
// B = 4, H = 16, H_kv = 8, S = 4096, D = 128 in bf16 that is 275 GFLOP
// against 0.20 GB.  The design, a simple one in two kernels, one a dtype:
//
//   * one block per (query tile of 64 rows, head, batch); the query tiles
//     are launched heaviest first (the last tile of a causal sequence sees
//     the most keys); only the key tiles of 64 that meet the tile's causal /
//     window band are visited: the others add exactly zero in the reference
//     too, and skipping them halves causal work;
//   * bf16 runs on the tensor cores (flash_kernel_mma): 4 warps of 16 query
//     rows; the K/V tiles are staged in shared memory as bf16 by cp.async,
//     double-buffered (the next tile loads while the current one is
//     multiplied), rows padded by 16 bytes so that ldmatrix reads do not
//     conflict, D padded with zeros to 64 or 128; the mask is applied only
//     to the tiles that cross the band's edge; S = Q K^T and O += P V are
//     mma.sync m16n8k16 products with float32 accumulators, Q's fragments
//     held in registers for the whole block, P rounded to bf16 for the P.V
//     product as FlashAttention-2 does (the normaliser sums P in float32);
//     the row max and sum reduce over the 4 lanes that share a row;
//   * float32 runs on the CUDA cores (flash_kernel_f32): 256 threads, the
//     query tile and each K tile staged transposed, V row-major; each
//     thread forms a 4 x 4 block of the 64 x 64 score tile with float4
//     reads, 16 FMAs per pair of reads, and the probabilities go through
//     shared memory to the P.V product.  float32 has no tensor-core path
//     of its own precision (TF32 keeps 10 bits), so the bound is the CUDA
//     cores' 67 TFLOP/s.
//
// Left for later: wgmma with TMA-fed stages, and a split over keys for short
// query counts.  No output is allocated here: the caller passes the output
// and the stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fa {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per staged tile
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

// The key tiles [*t_begin, *t_end) that meet the band of the query tile
// starting at row q0.
__device__ __forceinline__ void key_tiles(const Params& p, int64_t q0,
                                          int64_t* t_begin, int64_t* t_end) {
  int64_t k_begin = 0, k_end = p.sk;
  if (p.causal && q0 + kBQ < k_end) k_end = q0 + kBQ;
  if (p.window > 0 && q0 - p.window + 1 > 0) k_begin = q0 - p.window + 1;
  *t_begin = k_begin / kBK;
  *t_end = k_end > k_begin ? (k_end + kBK - 1) / kBK : *t_begin;
}

__device__ __forceinline__ bool allowed(const Params& p, int64_t row,
                                        int64_t col) {
  return col < p.sk && (!p.causal || col <= row) &&
         (p.window <= 0 || col > row - p.window);
}

// ---------------------------------------------------------------- bf16

constexpr int kMmaThreads = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row-major fragments) * b (16 x 8, column fragments)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Starts copying rows row0 .. row0 + 63, columns 0 .. d - 1 of a bf16
// (rows, D) operand into dst[r * LD + c] with cp.async (16 bytes a copy,
// rows past n_rows zero-filled); columns d .. LD - 1 untouched.  The caller
// commits and waits.
template <int LD>
__device__ __forceinline__ void stage_bf16_async(__nv_bfloat16* dst,
                                                 const __nv_bfloat16* base,
                                                 int64_t row_stride, int64_t row0,
                                                 int64_t n_rows, int d) {
  const int n_vec = d / 8;
  for (int idx = threadIdx.x; idx < 64 * n_vec; idx += kMmaThreads) {
    const int r = idx / n_vec, c = (idx % n_vec) * 8;
    const int64_t row = row0 + r;
    const bool in = row < n_rows;
    const __nv_bfloat16* src = base + (in ? row * row_stride : 0) + c;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst + r * LD + c)),
                 "l"(src), "r"(in ? 16 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int DMAX>
__global__ void __launch_bounds__(kMmaThreads) flash_kernel_mma(const Params p) {
  constexpr int LD = DMAX + 8;             // bf16 row stride of the tiles
  constexpr int TILE = 64 * LD;            // elements of one staged tile
  constexpr int KS = DMAX / 16;            // k-steps of S = Q K^T
  constexpr int NT = DMAX / 8;             // n-tiles of O
  // two K/V buffers [K0 V0 K1 V1]; Q is staged in K1 before the loop
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* const tiles = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;    // fragment row group, column pair
  const int64_t q0 = (int64_t)(gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.group;
  using bf16 = __nv_bfloat16;
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_st.b + h * p.q_st.h;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_st.b + hk * p.k_st.h;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_st.b + hk * p.v_st.h;
  bf16* ob = static_cast<bf16*>(p.o) + b * p.o_st.b + h * p.o_st.h;

  // the columns past D are read by the products and never staged: zero all
  for (int i = tid * 8; i < 4 * TILE; i += kMmaThreads * 8)
    *reinterpret_cast<uint4*>(tiles + i) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  int64_t t_begin, t_end;
  key_tiles(p, q0, &t_begin, &t_end);
  stage_bf16_async<LD>(tiles + 2 * TILE, qb, p.q_st.s, q0, p.sq, p.d);
  if (t_begin < t_end) {
    stage_bf16_async<LD>(tiles, kb, p.k_st.s, t_begin * kBK, p.sk, p.d);
    stage_bf16_async<LD>(tiles + TILE, vb, p.v_st.s, t_begin * kBK, p.sk, p.d);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 query rows as A fragments, for every k-step
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4(smem_addr(tiles + 2 * TILE + (warp * 16 + lane % 16) * LD +
                          kk * 16 + (lane / 16) * 8),
                qf[kk]);
  __syncthreads();                         // Q's buffer is free for K/V

  const int64_t row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int64_t tile = t_begin; tile < t_end; ++tile) {
    const int64_t k0 = tile * kBK;
    const int buf = (int)((tile - t_begin) & 1);
    const bf16* ks = tiles + 2 * buf * TILE;
    const bf16* vs = ks + TILE;
    if (tile + 1 < t_end) {                // the next tile loads meanwhile
      bf16* next = tiles + 2 * (buf ^ 1) * TILE;
      stage_bf16_async<LD>(next, kb, p.k_st.s, k0 + kBK, p.sk, p.d);
      stage_bf16_async<LD>(next + TILE, vb, p.v_st.s, k0 + kBK, p.sk, p.d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // the tile needs the mask only where it crosses the band's edge
    const bool edge = k0 + kBK > p.sk || (p.causal && k0 + kBK - 1 > q0) ||
                      (p.window > 0 && k0 <= q0 + kBQ - 1 - p.window);

    // S = Q K^T: 16 rows x 64 keys a warp, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int np = 0; np < 4; ++np) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t bk[4];
        ldmatrix_x4(smem_addr(ks + (np * 16 + lane % 8 + (lane / 16) * 8) * LD +
                              kk * 16 + ((lane / 8) % 2) * 8),
                    bk);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // mask and the online softmax of rows row0 (s[.][0..1]), row1 ([2..3])
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t col = k0 + j * 8 + 2 * t + (e & 1);
        const bool ok = !edge || allowed(p, e < 2 ? row0 : row1, col);
        s[j][e] = ok ? s[j][e] * p.scale_log2 : kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked score is exactly kNegInf and contributes 0, also while
        // its row has seen no valid key (m = kNegInf)
        s[j][e] = s[j][e] <= kNegInf ? 0.f : exp2f(s[j][e] - (e < 2 ? mn0 : mn1));
      }
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * alpha0 + sum0;               // this lane's share of the row sum
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      o[j][0] *= alpha0;
      o[j][1] *= alpha0;
      o[j][2] *= alpha1;
      o[j][3] *= alpha1;
    }

    // O += P V: the score fragments of two key n-tiles are the A fragment
    // of one 16-key step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < NT / 2; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(smem_addr(vs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD +
                                    dp * 16 + (lane / 16) * 8),
                          bv);
        mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();                       // this buffer is refilled next
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = j * 8 + 2 * t;
    if (col >= p.d) continue;
    if (row0 < p.sq)
      *reinterpret_cast<uint32_t*>(ob + row0 * p.o_st.s + col) =
          pack_bf16(o[j][0] / d0, o[j][1] / d0);
    if (row1 < p.sq)
      *reinterpret_cast<uint32_t*>(ob + row1 * p.o_st.s + col) =
          pack_bf16(o[j][2] / d1, o[j][3] / d1);
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

template <int DMAX>
int launch_bf16(const Params& p, int batch, int heads, cudaStream_t stream) {
  const int smem = 4 * 64 * (DMAX + 8) * (int)sizeof(__nv_bfloat16);
  return launch(flash_kernel_mma<DMAX>, kMmaThreads, smem, p, batch, heads,
                stream);
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
    return d <= 64 ? launch_bf16<64>(p, batch, heads, s)
                   : launch_bf16<128>(p, batch, heads, s);
  return d <= 64 ? launch_f32<64>(p, batch, heads, s)
                 : launch_f32<128>(p, batch, heads, s);
}

"""CUDA kernel ``flash_attention``: blockwise attention with an online
softmax over GQA heads, causal and sliding-window masks; the port of
``flash_attention_pallas`` (``repro/kernels/flash_attention.py:68``).
Q and K have one width, D_q, and V and the output another, D_v ≤ D_q: MLA's
prefill passes D_q = 192 (128 + 64 of rope) and D_v = 128, which the TPU
kernel does not take (it sizes V and the output by q's width).

The device code is ``csrc/flash_attention.cu``, float32 scores and
accumulators in both dtypes, and only the key tiles inside the causal /
window band visited.  bf16 runs one block per (128-row query tile, head,
batch): a producer thread feeds 128-key K/V tiles by TMA into a ring in
shared memory, and two warpgroups of 64 rows multiply them with ``wgmma``.
float32 runs one block per 64-row query tile on the tensor cores in
3xTF32 (each operand split into TF32 high and low parts, hi·lo + lo·hi +
hi·hi a product, float32-class: within 1e-5 of float64 at D 128 and 192):
TMA loads each K and V tile, a producer warpgroup splits it, K-major,
V transposed, and one consumer warpgroup multiplies with ``wgmma``.  The
tensor maps are built in the C entry point from the strides passed here.
Each dtype has one instance per width class, ``<D_q, D_v>`` rounded up
to boxes of 64: ``<64, 64>``, ``<128, 128>`` and ``<192, 128>``, and in
float32 ``<192, 192>`` too; bf16's ``<192, 192>`` would need 240 KB of
shared memory, over the 227 KB a block may use, so it raises.  The TPU kernel's
``block_q``, ``block_k``, ``interpret`` and ``kv_len`` have no counterpart:
any ``S`` goes in as it is (the kernel masks the ragged tile itself), and
the inputs may be strided views, such as the
``(B, S, H, D) → (B, H, S, D)`` transposes of the model's attention, as long
as their last axis is contiguous.
"""

from __future__ import annotations

import ctypes

import torch

#: the head dimensions the kernel takes: multiples of 8, D_v ≤ D_q ≤ this
MAX_HEAD_DIM = 192
#: bf16's widest D_v where D_q > 128 (shared memory: Q 48 KB + 2 × (K 48 KB
#: + V 32 KB) = 208 KB of the 227 KB a block may use)
BF16_MAX_DV_AT_DQ_192 = 128
#: grid.y / grid.z limit of a launch (heads, batch)
MAX_GRID_YZ = 65535
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_operand(name: str, t: torch.Tensor, dtype: torch.dtype,
                  device: torch.device) -> None:
    """What the kernel assumes of each operand: 4-d, of the query's dtype
    and device, the last axis contiguous, every row 16-byte aligned."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype or t.dim() != 4:
        raise ValueError(f"{name}: expected a 4-d {dtype} tensor, got "
                         f"{t.dim()}-d {t.dtype}")
    if t.stride(3) != 1:
        raise ValueError(f"{name}: the head dimension must be contiguous "
                         f"(strides {t.stride()})")
    per_16_bytes = 16 // t.element_size()
    if t.data_ptr() % 16 or any(s % per_16_bytes for s in t.stride()[:3]):
        raise ValueError(f"{name}: rows must start on 16-byte boundaries "
                         f"(strides {t.stride()})")


def check_shapes(q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> tuple:
    """The shapes the kernel and its plain version take: ``q`` (B, H, S_q,
    D_q), ``k`` (B, H_kv, S_k, D_q), ``v`` (B, H_kv, S_k, D_v) with
    D_v ≤ D_q ≤ MAX_HEAD_DIM, H a multiple of H_kv (the kernel also wants
    D_q and D_v multiples of 8: ``flash_attention_cuda``).  Returns (B, H,
    H_kv, S_q, S_k, D_q, D_v); raises naming the dimension that does not
    fit."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name}: expected a 4-d tensor, got {t.dim()}-d")
    b, h, sq, dq = q.shape
    _, hkv, sk, dk = k.shape
    dv = v.shape[3]
    if k.shape[0] != b or v.shape[0] != b:
        raise ValueError(f"batch B: q has {b}, k {k.shape[0]}, v {v.shape[0]}")
    if v.shape[1] != hkv:
        raise ValueError(f"key/value heads H_kv: k has {hkv}, v {v.shape[1]}")
    if v.shape[2] != sk:
        raise ValueError(f"key length S_k: k has {sk}, v {v.shape[2]}")
    if dk != dq:
        raise ValueError(f"k's width D_k = {dk} differs from q's D_q = {dq}")
    if not 0 < dq <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes a query/key width D_q up to "
                         f"{MAX_HEAD_DIM}, not {dq}")
    if not 0 < dv <= dq:
        raise ValueError(f"flash_attention takes a value width D_v up to "
                         f"D_q = {dq}, not {dv}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} "
                         "key/value heads")
    return b, h, hkv, sq, sk, dq, dv


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """``q`` (B, H, S_q, D_q), ``k`` (B, H_kv, S_k, D_q) and ``v``
    (B, H_kv, S_k, D_v) on one CUDA device, bf16 or float32, as
    ``check_shapes`` takes them (bf16: D_v ≤ 128 where D_q > 128); returns
    ``o`` (B, H, S_q, D_v) in ``q``'s dtype, laid out like ``q`` (a
    transposed view of ``q`` gives a transposed view back)."""
    from repro_torch.kernels._build import library

    device = q.device
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention takes bfloat16 or float32, not "
                         f"{q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(name, t, q.dtype, device)
    b, h, hkv, sq, sk, dq, dv = check_shapes(q, k, v)
    if dq % 8 or dv % 8:
        raise ValueError(f"the flash_attention kernel takes widths that are a "
                         f"multiple of 8 (16-byte rows), not D_q = {dq}, "
                         f"D_v = {dv}")
    if q.dtype == torch.bfloat16 and dq > 128 and dv > BF16_MAX_DV_AT_DQ_192:
        raise ValueError(f"bf16 flash_attention takes D_v up to "
                         f"{BF16_MAX_DV_AT_DQ_192} where D_q > 128 (the "
                         f"<192, 192> tile would need 240 KB of shared memory, "
                         f"over the 227 KB of a block), not D_v = {dv}")
    if h > MAX_GRID_YZ or b > MAX_GRID_YZ:
        raise ValueError(f"B = {b} and H = {h} must be at most {MAX_GRID_YZ}")
    if sq == 0 or b == 0 or h == 0:
        raise ValueError(f"flash_attention needs at least one query row, "
                         f"got q {tuple(q.shape)}")
    # q's strides where q is dense, else contiguous; D_v wide
    out = torch.empty_like(q if dv == dq else q[..., :dv])
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out)
                                      for s in t.stride()[:3]))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = library().flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            _DTYPES[q.dtype], b, h, hkv, sq, sk, dq, dv, int(causal),
            int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed with CUDA error "
                           f"{err} (q {tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"v {tuple(v.shape)}, {q.dtype})")
    return out

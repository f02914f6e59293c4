"""CUDA kernel ``flash_attention``: blockwise attention with an online
softmax over GQA heads, causal and sliding-window masks; the port of
``flash_attention_pallas`` (``repro/kernels/flash_attention.py:68``).

The device code is ``csrc/flash_attention.cu``, float32 scores and
accumulators in both dtypes, and only the key tiles inside the causal /
window band visited.  bf16 runs one block per (128-row query tile, head,
batch): a producer thread feeds 128-key K/V tiles by TMA into a ring in
shared memory, and two warpgroups of 64 rows multiply them with ``wgmma``.
The tensor maps are built in the C entry point from the strides passed
here.  float32 runs 64-row tiles on the CUDA cores.  The TPU kernel's
``block_q``, ``block_k``, ``interpret`` and ``kv_len`` have no counterpart:
any ``S`` goes in as it is (the kernel masks the ragged tile itself), and
the inputs may be strided views, such as the
``(B, S, H, D) → (B, H, S, D)`` transposes of the model's attention, as long
as their last axis is contiguous.
"""

from __future__ import annotations

import ctypes

import torch

#: the head dimensions the kernel takes: multiples of 8 up to this
MAX_HEAD_DIM = 128
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


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """``q`` (B, H, S_q, D), ``k`` and ``v`` (B, H_kv, S_k, D) on one CUDA
    device, bf16 or float32, ``H`` a multiple of ``H_kv``, ``D`` a multiple
    of 8 up to 128; returns ``o`` (B, H, S_q, D) in ``q``'s dtype, laid out
    like ``q`` (a transposed view of ``q`` gives a transposed view back)."""
    from repro_torch.kernels._build import library

    device = q.device
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention takes bfloat16 or float32, not "
                         f"{q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(name, t, q.dtype, device)
    b, h, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit (B, H, S, D) / "
                         "(B, H_kv, S, D)")
    if d % 8 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes a head dimension that is a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}, not {d}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"{h} query heads are not a multiple of {hkv} "
                         "key/value heads")
    if h > MAX_GRID_YZ or b > MAX_GRID_YZ:
        raise ValueError(f"B = {b} and H = {h} must be at most {MAX_GRID_YZ}")
    if sq == 0 or b == 0 or h == 0:
        raise ValueError(f"flash_attention needs at least one query row, "
                         f"got q {tuple(q.shape)}")
    out = torch.empty_like(q)        # q's strides where q is dense, else contiguous
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out)
                                      for s in t.stride()[:3]))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = library().flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            _DTYPES[q.dtype], b, h, hkv, sq, sk, d, int(causal), int(window),
            stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed with CUDA error "
                           f"{err} (q {tuple(q.shape)}, k {tuple(k.shape)}, "
                           f"{q.dtype})")
    return out

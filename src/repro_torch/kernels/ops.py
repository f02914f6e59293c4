"""Public kernel wrappers and their launch counters; counterpart of
``repro/kernels/ops.py``.

Each wrapper dispatches on the device of the tensors it is given: a CPU
tensor runs the plain version in ``ref.py``; a CUDA tensor launches the
hand-written kernel (or raises).  A DTensor raises on either device: its
``data_ptr`` is not its shard's, so the caller hands a kernel each rank's
local shard (``models/layers.py`` ``_local_heads``).  ``LAUNCHES`` counts kernel launches per
wrapper and nothing else, so a run can show that it went through the
kernels.  ``RANGE_REDUCTIONS`` counts the reductions those launches ran in
segment ranges, by path: ``scan`` (each range's blocks read every code of
their row chunk) or ``sorted`` (the launch's rows counting-sorted by range
first, each block reading only its range's), as ``seg_aggregate.py``'s
shape rule picks it; ``reset_launches`` clears both counters.

Each reduction wrapper runs inside a ``kernel.<wrapper>`` span
(``obs/trace.py``), on either device.  With tracing on, the span carries
the launch's rows, its reductions as ``[mode, n_segments, width,
n_parts]`` (mode "seg" or "hist", then ".range" where the card cuts the
accumulator into segment ranges on the scan path, ".sorted" on the sorted
path: the same rule on either device), and the least work the launch does:
``bytes``, each distinct input tensor read once at its element size and
the float32 output written once, and ``ops``, one add per row and output
column it adds into.  Off, none of it is computed.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ref
from repro_torch.kernels.covar_xtx import covar_xtx_cuda
from repro_torch.kernels.flash_attention import check_shapes, flash_attention_cuda
from repro_torch.kernels.fused_scan import (Part, Parts, ReduceSpec, _cols,
                                            fused_scan_block_cuda,
                                            fused_scan_parts_cuda)
from repro_torch.kernels.seg_aggregate import (RANGE_REDUCTIONS, reduction_mode,
                                               seg_aggregate_cuda)
from repro_torch.kernels.tree_hist import (tree_hist_batched_cuda,
                                           tree_hist_cuda)
from repro_torch.obs.trace import lazy_span

__all__ = ["LAUNCHES", "Part", "Parts", "RANGE_REDUCTIONS", "ReduceSpec", "covar_xtx",
           "flash_attention", "fused_scan_block", "fused_scan_parts",
           "reset_launches", "seg_aggregate", "tree_hist", "tree_hist_batched"]

LAUNCHES: Dict[str, int] = {"covar_xtx": 0, "flash_attention": 0,
                            "fused_scan_block": 0, "seg_aggregate": 0,
                            "tree_hist": 0, "tree_hist_batched": 0}


def reset_launches() -> None:
    for counter in (LAUNCHES, RANGE_REDUCTIONS):
        for k in counter:
            counter[k] = 0


def _check_local(name: str, *tensors) -> None:
    """A kernel reads raw pointers: a DTensor (whose ``data_ptr`` is not
    its local shard's) raises rather than reach it."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{name} takes plain tensors, not DTensors: pass each "
                        "rank's local shard (DTensor.to_local())")


def _check_no_grad(name: str, *tensors) -> None:
    """No kernel has a backward (nor has the reference's Pallas kernel), and
    a kernel's output carries no ``grad_fn``: a wrapper called where
    autograd would record it raises on either device rather than return a
    result that trains on the CPU and silently detaches on the card."""
    _check_local(name, *tensors)
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward (the reference's Pallas kernel has none "
            "either) and was called on tensors that require grad; training "
            "takes attention impl 'dense' or 'chunked', and the engine's "
            "reductions run under torch.no_grad()")


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {t.device}")


def _read_bytes(tensors) -> int:
    """Bytes of each distinct tensor of ``tensors``, every element it
    addresses read once (an axis of stride 0 adds none).  One pass of a
    few attribute reads a tensor: a launch may hand hundreds of parts."""
    seen, total = set(), 0
    for t in tensors:
        shape, st = t.shape, t.stride()
        key = (t.data_ptr(), shape, st)
        if key in seen:
            continue
        seen.add(key)
        n = t.element_size()
        for size, step in zip(shape, st):
            if step:
                n *= size
        total += n
    return total


def _launch_args(n: int, tensors, reds) -> dict:
    """A reduction launch's span arguments over ``n`` rows: ``reds`` holds
    (kind, n_segments, width, columns a row adds into, n_parts) each."""
    modes, out, adds = [], 0, 0
    for kind, n_seg, width, cols, n_parts in reds:
        mode = reduction_mode(kind, n_seg, cols if kind == "seg" else width)
        modes.append([kind + ("", ".range", ".sorted")[mode], n_seg, width, n_parts])
        out += n_seg * width
        adds += cols
    return {"rows": n, "reductions": modes,
            "bytes": _read_bytes(tensors) + 4 * out, "ops": n * adds}


def _packed_args(codes, fpay, specs) -> dict:
    return _launch_args(codes.shape[0], (codes, fpay), [
        (sp.kind, sp.n_segments, sp.width, sp.width, 1 if sp.kind == "seg" else 2)
        for sp in specs])


def _parts_args(reds) -> dict:
    tensors, shapes = [], []
    for r in reds:
        tensors.append(r.codes)
        if r.kind == "hist":
            tensors += r.parts
            shapes.append(("hist", r.n_segments, r.out_width, r.out_width, 2))
            continue
        cols = 0
        for p in r.parts:
            t = p.values
            tensors.append(t)
            cols += _cols(t)
        shapes.append(("seg", r.n_segments, r.out_width, cols, len(r.parts)))
    return _launch_args(reds[0].codes.shape[0], tensors, shapes)


def _seg_args(seg, payload, n_segments) -> dict:
    w = _cols(payload)
    return _launch_args(seg.shape[0], (seg, payload), [("seg", n_segments, w, w, 1)])


def _hist_args(codes, y, cond, n_buckets) -> dict:
    w = 3 * _cols(cond)
    return _launch_args(codes.shape[0], (codes, y, cond),
                        [("hist", n_buckets, w, w, 2)])


def covar_xtx(x: torch.Tensor, w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``C = Xᵀ·diag(w)·X``: the (F, F) float32 ``C[f, g] = Σ_n w[n]·x[n, f]·
    x[n, g]`` for ``x`` (n, F) of any float dtype (cast to float32) and ``w``
    (n,) or ``None`` (ones).  Any ``n``, and on the card any ``F`` up to
    ``covar_xtx.MAX_FEATURES`` (past it the wrapper raises): the
    reference's ``block_rows``, ``interpret`` and ``feature_align`` pad for
    the TPU's tiles and have no counterpart here."""
    _check_no_grad("covar_xtx", x, w)
    x = x.to(torch.float32)
    w = (torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
         if w is None else w.to(torch.float32))
    if not _on_cuda(x):
        return ref.covar_xtx_ref(x, w)
    out = covar_xtx_cuda(x, w)
    LAUNCHES["covar_xtx"] += 1
    return out


def fused_scan_block(codes: torch.Tensor, fpay: torch.Tensor,
                     specs: Sequence[ReduceSpec]):
    """Whole-step fused reduction: returns one ``(n_segments, width)``
    tensor per spec."""
    specs = tuple(specs)
    _check_no_grad("fused_scan_block", codes, fpay)
    with lazy_span("kernel.fused_scan_block", _packed_args, codes, fpay, specs):
        if not _on_cuda(codes):
            return ref.fused_scan_block_ref(codes, fpay, specs)
        out = fused_scan_block_cuda(codes, fpay, specs)
    LAUNCHES["fused_scan_block"] += 1
    return out


def fused_scan_parts(reds: Sequence[Parts]):
    """The same launch over reductions given as :class:`Parts`: each its
    codes and payload parts where they lie.  Counted as a
    ``fused_scan_block`` launch."""
    reds = tuple(reds)
    _check_no_grad("fused_scan_block", *(t for r in reds for t in (
        r.codes, *(getattr(p, "values", p) for p in r.parts))))
    with lazy_span("kernel.fused_scan_block", _parts_args, reds):
        if not _on_cuda(reds[0].codes):
            return ref.fused_scan_parts_ref(reds)
        out = fused_scan_parts_cuda(reds)
    LAUNCHES["fused_scan_block"] += 1
    return out


def seg_aggregate(seg: torch.Tensor, payload: torch.Tensor,
                  n_segments: int) -> torch.Tensor:
    """Segment-sum payload rows into ``n_segments`` (out-of-range ids
    contribute nowhere)."""
    _check_no_grad("seg_aggregate", seg, payload)
    with lazy_span("kernel.seg_aggregate", _seg_args, seg, payload, n_segments):
        if not _on_cuda(seg):
            return ref.seg_aggregate_ref(seg, payload, n_segments)
        out = seg_aggregate_cuda(seg, payload, n_segments)
    LAUNCHES["seg_aggregate"] += 1
    return out


def tree_hist(codes: torch.Tensor, y: torch.Tensor, cond: torch.Tensor,
              n_buckets: int) -> torch.Tensor:
    """Per-bucket ``[count, Σy, Σy²]`` under the mask ``cond``."""
    _check_no_grad("tree_hist", codes, y, cond)
    with lazy_span("kernel.tree_hist", _hist_args, codes, y, cond, n_buckets):
        if not _on_cuda(codes):
            return ref.tree_hist_ref(codes, y, cond, n_buckets)
        out = tree_hist_cuda(codes, y, cond, n_buckets)
    LAUNCHES["tree_hist"] += 1
    return out


def tree_hist_batched(codes: torch.Tensor, y: torch.Tensor,
                      cond: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Per-node, per-bucket ``[count, Σy, Σy²]``: ``cond`` is (n, N), one
    mask column per frontier node; returns (N, n_buckets, 3)."""
    _check_no_grad("tree_hist_batched", codes, y, cond)
    with lazy_span("kernel.tree_hist_batched", _hist_args, codes, y, cond, n_buckets):
        if not _on_cuda(codes):
            return ref.tree_hist_batched_ref(codes, y, cond, n_buckets)
        out = tree_hist_batched_cuda(codes, y, cond, n_buckets)
    LAUNCHES["tree_hist_batched"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Blockwise attention over ``q`` (B, H, S_q, D_q), ``k`` (B, H_kv,
    S_k, D_q) and ``v`` (B, H_kv, S_k, D_v), GQA by head index, with causal
    and sliding-window masks, scaled by 1/sqrt(D_q); returns (B, H, S_q,
    D_v) in ``q``'s dtype.  D_v ≤ D_q ≤ 192 on either device
    (``flash_attention.check_shapes``), multiples of 8 on the card.  Any
    ``S``: the reference's ``block_q``, ``block_k`` and ``interpret`` pad
    for the TPU's tiles and have no counterpart here.  Forward only: under
    grad it raises (``_check_no_grad``)."""
    _check_no_grad("flash_attention", q, k, v)
    if not _on_cuda(q):
        check_shapes(q, k, v)
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window)
    LAUNCHES["flash_attention"] += 1
    return out

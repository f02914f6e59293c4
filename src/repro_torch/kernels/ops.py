"""Public kernel wrappers and their launch counters; counterpart of
``repro/kernels/ops.py``.

Each wrapper dispatches on the device of the tensors it is given: a CPU
tensor runs the plain version in ``ref.py``; a CUDA tensor launches the
hand-written kernel (or raises).  ``LAUNCHES`` counts kernel launches per
wrapper and nothing else, so a run can show that it went through the
kernels.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.covar_xtx import covar_xtx_cuda
from repro_torch.kernels.fused_scan import ReduceSpec, fused_scan_block_cuda
from repro_torch.kernels.seg_aggregate import seg_aggregate_cuda
from repro_torch.kernels.tree_hist import (tree_hist_batched_cuda,
                                           tree_hist_cuda)

__all__ = ["LAUNCHES", "ReduceSpec", "covar_xtx", "fused_scan_block",
           "reset_launches", "seg_aggregate", "tree_hist", "tree_hist_batched"]

LAUNCHES: Dict[str, int] = {"covar_xtx": 0, "fused_scan_block": 0,
                            "seg_aggregate": 0, "tree_hist": 0,
                            "tree_hist_batched": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {t.device}")


def covar_xtx(x: torch.Tensor, w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``C = Xᵀ·diag(w)·X``: the (F, F) float32 ``C[f, g] = Σ_n w[n]·x[n, f]·
    x[n, g]`` for ``x`` (n, F) of any float dtype (cast to float32) and ``w``
    (n,) or ``None`` (ones).  Any ``n`` and ``F``: the reference's
    ``block_rows``, ``interpret`` and ``feature_align`` pad for the TPU's
    tiles and have no counterpart here."""
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
    if not _on_cuda(codes):
        return ref.fused_scan_block_ref(codes, fpay, specs)
    out = fused_scan_block_cuda(codes, fpay, specs)
    LAUNCHES["fused_scan_block"] += 1
    return out


def seg_aggregate(seg: torch.Tensor, payload: torch.Tensor,
                  n_segments: int) -> torch.Tensor:
    """Segment-sum payload rows into ``n_segments`` (out-of-range ids
    contribute nowhere)."""
    if not _on_cuda(seg):
        return ref.seg_aggregate_ref(seg, payload, n_segments)
    out = seg_aggregate_cuda(seg, payload, n_segments)
    LAUNCHES["seg_aggregate"] += 1
    return out


def tree_hist(codes: torch.Tensor, y: torch.Tensor, cond: torch.Tensor,
              n_buckets: int) -> torch.Tensor:
    """Per-bucket ``[count, Σy, Σy²]`` under the mask ``cond``."""
    if not _on_cuda(codes):
        return ref.tree_hist_ref(codes, y, cond, n_buckets)
    out = tree_hist_cuda(codes, y, cond, n_buckets)
    LAUNCHES["tree_hist"] += 1
    return out


def tree_hist_batched(codes: torch.Tensor, y: torch.Tensor,
                      cond: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Per-node, per-bucket ``[count, Σy, Σy²]``: ``cond`` is (n, N), one
    mask column per frontier node; returns (N, n_buckets, 3)."""
    if not _on_cuda(codes):
        return ref.tree_hist_batched_ref(codes, y, cond, n_buckets)
    out = tree_hist_batched_cuda(codes, y, cond, n_buckets)
    LAUNCHES["tree_hist_batched"] += 1
    return out

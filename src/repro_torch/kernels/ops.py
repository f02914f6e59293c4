"""Public kernel wrappers and their launch counters; counterpart of
``repro/kernels/ops.py``.

Each wrapper dispatches on the device of the tensors it is given: a CPU
tensor runs the plain version in ``ref.py``; a CUDA tensor launches the
hand-written kernel (or raises).  ``LAUNCHES`` counts kernel launches per
wrapper and nothing else, so a run can show that it went through the
kernels.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused_scan import ReduceSpec, fused_scan_block_cuda
from repro_torch.kernels.seg_aggregate import seg_aggregate_cuda
from repro_torch.kernels.tree_hist import tree_hist_cuda

__all__ = ["LAUNCHES", "ReduceSpec", "fused_scan_block", "reset_launches",
           "seg_aggregate", "tree_hist"]

LAUNCHES: Dict[str, int] = {"fused_scan_block": 0, "seg_aggregate": 0,
                            "tree_hist": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for tensors on {t.device}")


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

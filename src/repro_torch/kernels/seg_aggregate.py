"""CUDA kernel ``seg_aggregate``: ``out[s, a] = Σ_{seg[n]=s} payload[n, a]``;
the port of ``seg_aggregate_pallas`` (``repro/kernels/seg_aggregate.py:39``).

One "seg" reduction of the shared device code in ``csrc/scan_reduce.cuh``,
launched through its own entry point (``csrc/seg_aggregate.cu``).  Ids
outside ``[0, n_segments)`` contribute nowhere, so no padding rows or
sacrificial segment are needed.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fused_scan import (ReduceSpec, check_tensor,
                                            launch_plan, run)


def seg_aggregate_cuda(seg: torch.Tensor, payload: torch.Tensor,
                       n_segments: int) -> torch.Tensor:
    """``seg`` (n,) int32 and ``payload`` (n, A) float32, contiguous on one
    CUDA device; returns (n_segments, A) float32."""
    from repro_torch.kernels._build import library

    device = seg.device
    check_tensor("seg", seg, torch.int32, 1, device)
    check_tensor("payload", payload, torch.float32, 2, device)
    n, width = payload.shape
    if seg.shape[0] != n or n == 0:
        raise ValueError(f"seg {tuple(seg.shape)} and payload "
                         f"{tuple(payload.shape)} need the same, non-zero rows")
    spec = ReduceSpec("seg", 0, n_segments, width, 0)
    plan = launch_plan((spec,), ("seg",), n, device)
    (out,) = run(library().seg_aggregate,
                 [seg.data_ptr(), n, payload.data_ptr(), width],
                 plan, n, device)
    return out

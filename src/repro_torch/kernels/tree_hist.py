"""CUDA kernels ``tree_hist`` and ``tree_hist_batched``: per-bucket
``[Σcond, Σcond·y, Σcond·y²]`` under one node mask, or under each of ``N``
node masks at once; the ports of ``tree_hist_pallas`` and
``tree_hist_batched_pallas`` (``repro/kernels/tree_hist.py:51`` and
``:99``).

The payload ``cond ⊗ [1, y, y²]`` is formed in registers from ``y`` and
``cond`` (the ``vec_hist`` and ``mat_hist`` kinds of
``csrc/scan_reduce.cuh``, entry points ``csrc/tree_hist.cu`` and
``csrc/tree_hist_batched.cu``) and never written to device memory.  Codes
outside ``[0, n_buckets)`` contribute nowhere.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fused_scan import (ReduceSpec, check_tensor,
                                            launch_plan, run)


def tree_hist_cuda(codes: torch.Tensor, y: torch.Tensor, cond: torch.Tensor,
                   n_buckets: int) -> torch.Tensor:
    """``codes`` (n,) int32, ``y`` and ``cond`` (n,) float32, contiguous on
    one CUDA device; returns (n_buckets, 3) float32."""
    from repro_torch.kernels._build import library

    device = codes.device
    check_tensor("codes", codes, torch.int32, 1, device)
    check_tensor("y", y, torch.float32, 1, device)
    check_tensor("cond", cond, torch.float32, 1, device)
    n = codes.shape[0]
    if y.shape[0] != n or cond.shape[0] != n or n == 0:
        raise ValueError("codes, y and cond need the same, non-zero length")
    spec = ReduceSpec("hist", 0, n_buckets, 3, 0, n_cond=1)
    plan = launch_plan((spec,), ("vec_hist",), n, device)
    (out,) = run(library().tree_hist,
                 [codes.data_ptr(), y.data_ptr(), cond.data_ptr(), n],
                 plan, n, device)
    return out


def tree_hist_batched_cuda(codes: torch.Tensor, y: torch.Tensor,
                           cond: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """``codes`` (n,) int32, ``y`` (n,) float32 and ``cond`` (n, N) float32,
    contiguous on one CUDA device; returns (N, n_buckets, 3) float32."""
    from repro_torch.kernels._build import library

    device = codes.device
    check_tensor("codes", codes, torch.int32, 1, device)
    check_tensor("y", y, torch.float32, 1, device)
    check_tensor("cond", cond, torch.float32, 2, device)
    n, n_cond = cond.shape
    if codes.shape[0] != n or y.shape[0] != n or n == 0 or n_cond == 0:
        raise ValueError(f"codes {tuple(codes.shape)}, y {tuple(y.shape)} and "
                         f"cond {tuple(cond.shape)} need the same, non-zero "
                         "rows and at least one cond column")
    spec = ReduceSpec("hist", 0, n_buckets, 3 * n_cond, 0, n_cond=n_cond)
    plan = launch_plan((spec,), ("mat_hist",), n, device)
    (out,) = run(library().tree_hist_batched,
                 [codes.data_ptr(), y.data_ptr(), cond.data_ptr(), n, n_cond],
                 plan, n, device)
    # columns are [node j, stat k]: (D, N·3) -> (N, D, 3)
    return out.view(n_buckets, n_cond, 3).permute(1, 0, 2).contiguous()

"""CUDA kernels ``tree_hist`` and ``tree_hist_batched``: per-bucket
``[Σcond, Σcond·y, Σcond·y²]`` under one node mask, or under each of ``N``
node masks at once; the ports of ``tree_hist_pallas`` and
``tree_hist_batched_pallas`` (``repro/kernels/tree_hist.py:51`` and
``:99``).

Both are one HIST reduction of ``csrc/seg_reduce.cuh`` (entry points
``csrc/tree_hist.cu`` and ``csrc/tree_hist_batched.cu``): the payload
``cond ⊗ [1, y, y²]`` is formed in registers from ``y`` and ``cond`` and
never written to device memory; ``tree_hist`` is the one-node case.  Codes
outside ``[0, n_buckets)`` contribute nowhere.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.seg_aggregate import (Shape, check_tensor,
                                               launch_plan, run, source)


def _hist(entry, codes: torch.Tensor, y: torch.Tensor, cond: torch.Tensor,
          n_buckets: int, lib=None) -> torch.Tensor:
    """One HIST launch over ``cond`` (n, N), or (n,) for one node; returns
    (N, n_buckets, 3), the kernel writing each node's histogram whole.
    ``lib``: the library of ``entry`` where it is not the package's."""
    device, n = codes.device, cond.shape[0]
    n_cond = cond.shape[1] if cond.dim() == 2 else 1
    plan = launch_plan(n, (Shape("hist", n_buckets, (n_cond, 1), 3 * n_cond),),
                       device, lib)
    (out,) = run(entry, plan, [source(codes),
                               source(cond, ocol=3, ostride=3 * n_buckets),
                               source(y, col0=n_cond)], n, device)
    return out.view(n_cond, n_buckets, 3)


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
    return _hist(library().tree_hist, codes, y, cond, n_buckets).view(n_buckets, 3)


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
    return _hist(library().tree_hist_batched, codes, y, cond, n_buckets)

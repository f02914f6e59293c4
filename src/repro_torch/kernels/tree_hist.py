"""CUDA kernel ``tree_hist``: per-bucket ``[Σcond, Σcond·y, Σcond·y²]``;
the port of ``tree_hist_pallas`` (``repro/kernels/tree_hist.py:51``).

The payload ``cond ⊗ [1, y, y²]`` is formed in registers from the two
vectors (the ``vec_hist`` kind of ``csrc/scan_reduce.cuh``, entry point
``csrc/tree_hist.cu``) and never written to device memory.  Codes outside
``[0, n_buckets)`` contribute nowhere.
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

"""Plain PyTorch versions of the scan kernels; counterpart of
``repro/kernels/ref.py``.  The CPU path runs them, and the card's kernels
are held against them."""

from __future__ import annotations

import torch


def seg_aggregate_ref(seg: torch.Tensor, payload: torch.Tensor,
                      n_segments: int) -> torch.Tensor:
    # out-of-range segment ids must contribute nowhere (padding convention)
    ok = (seg >= 0) & (seg < n_segments)
    pay = payload.to(torch.float32) * ok[:, None].to(torch.float32)
    sid = torch.where(ok, seg, torch.zeros_like(seg)).long()
    out = torch.zeros((n_segments, payload.shape[1]), dtype=torch.float32,
                      device=payload.device)
    return out.index_add_(0, sid, pay)


def tree_hist_ref(codes: torch.Tensor, y: torch.Tensor, cond: torch.Tensor,
                  n_buckets: int) -> torch.Tensor:
    payload = torch.stack([cond, cond * y, cond * y * y], dim=1)
    return seg_aggregate_ref(codes, payload, n_buckets)


def fused_scan_block_ref(codes: torch.Tensor, fpay: torch.Tensor, specs):
    """Each :class:`ReduceSpec` is a seg-sum of its payload slice (hist
    payloads formed as cond⊗yk)."""
    outs = []
    for sp in specs:
        code = codes[:, sp.code_col]
        if sp.kind == "seg":
            pay = fpay[:, sp.pay_off:sp.pay_off + sp.width]
        else:
            cond = fpay[:, sp.pay_off:sp.pay_off + sp.n_cond]
            yk = fpay[:, sp.yk_off:sp.yk_off + 3]
            pay = (cond[:, :, None] * yk[:, None, :]).reshape(
                codes.shape[0], sp.n_cond * 3)
        outs.append(seg_aggregate_ref(code, pay, sp.n_segments))
    return tuple(outs)

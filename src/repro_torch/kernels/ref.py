"""Plain PyTorch versions of the kernels; counterpart of
``repro/kernels/ref.py``.  The CPU path runs them, and the card's kernels
are held against them."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.fused_scan import disjoint_columns


def covar_xtx_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.einsum("nf,n,ng->fg", x.to(torch.float32),
                        w.to(torch.float32), x.to(torch.float32))


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


def tree_hist_batched_ref(codes: torch.Tensor, y: torch.Tensor,
                          cond: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """cond (n, N) node-mask columns -> (N, n_buckets, 3)."""
    n, n_cond = cond.shape
    yk = torch.stack([torch.ones_like(y), y, y * y], dim=1)
    payload = (cond[:, :, None] * yk[:, None, :]).reshape(n, n_cond * 3)
    out = seg_aggregate_ref(codes, payload, n_buckets)
    return out.view(n_buckets, n_cond, 3).permute(1, 0, 2)


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


def fused_scan_parts_ref(reds):
    """Each reduction of the parts form (``fused_scan.Parts``) as a seg-sum:
    a "seg" payload is its parts placed at their output columns (a column no
    part names is 0); a "hist" payload is cond⊗yk, yk formed from y."""
    outs = []
    for red in reds:
        n = red.codes.shape[0]
        if red.kind == "hist":
            cond, y = red.parts
            yk = (y if y.dim() == 2
                  else torch.stack([torch.ones_like(y), y, y * y], dim=1))
            pay = (cond[:, :, None] * yk[:, None, :]).reshape(
                n, 3 * cond.shape[1])
        else:
            pay = torch.zeros((n, red.out_width), dtype=torch.float32,
                              device=red.codes.device)
            if not disjoint_columns(red.out_width, tuple(
                    (p.ocol, p.ostride, p.values.reshape(n, -1).shape[1])
                    for p in red.parts)):
                raise ValueError("two parts name one output column")
            for part in red.parts:
                v = part.values.reshape(n, -1)
                cols = part.ocol + part.ostride * torch.arange(
                    v.shape[1], device=v.device)
                pay[:, cols] = v.to(torch.float32)
        outs.append(seg_aggregate_ref(red.codes, pay, red.n_segments))
    return tuple(outs)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """Dense attention with GQA (K/V heads repeated), causal and
    sliding-window masks over ``q`` (B, H, S_q, D_q), ``k`` (B, H_kv, S_k,
    D_q) and ``v`` (B, H_kv, S_k, D_v): scores scaled by 1/sqrt(D_q), as the
    reference's ``_dense_attention`` scales by q's width, softmax and the
    product in float32; the output is (B, H, S_q, D_v), V's own width (MLA:
    D_q = 192, D_v = 128), in ``q``'s dtype; a row with no valid key gives
    0."""
    d = q.shape[-1]
    group = q.shape[1] // k.shape[1]
    kr = k.float().repeat_interleave(group, dim=1)
    vr = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) / math.sqrt(d)
    rows = torch.arange(q.shape[2], device=q.device)[:, None]
    cols = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = torch.ones((q.shape[2], k.shape[2]), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= cols <= rows
    if window > 0:
        mask &= cols > rows - window
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    p = torch.nan_to_num(p, nan=0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)

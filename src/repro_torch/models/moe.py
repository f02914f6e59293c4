"""Mixture-of-Experts FFN with capacity-bucketed top-k dispatch;
counterpart of ``repro/models/moe.py``.

The same semantics as the reference: GShard dispatch groups (tokens split
into ``moe_groups`` contiguous groups; ranks and capacities are per group),
a cumsum rank inside (group, expert) — not a sort — and a capacity
``C = ceil(T_g·k/E · capacity_factor)`` per expert; assignments past it
are dropped (weight 0), and the top-k weights are renormalised over the k
choices.  The Switch load-balance loss (E · Σ f·P) comes back with the
output.

Each kept bucket receives exactly one token, so the buckets are built by
one ``index_copy_`` into ``E·C + 1`` rows a group whose last row takes every
overflow and is dropped (the reference's ``segment_sum`` of masked rows
gives the same values).  The reference's sharding constraints are no-ops
without a mesh and are left out until sharding is ported.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec, p_, wide


def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    specs = {
        "router": p_((d, e), ("embed", "experts")),
        "wg": p_((e, d, f), ("experts", "embed", None)),
        "wu": p_((e, d, f), ("experts", "embed", None)),
        "wd": p_((e, f, d), ("experts", None, "embed")),
    }
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        specs.update({
            "swg": p_((d, fs), ("embed", "ffn")),
            "swu": p_((d, fs), ("embed", "ffn")),
            "swd": p_((fs, d), ("ffn", "embed")),
        })
    return specs


def _dispatch_groups(cfg: ModelConfig, t: int) -> int:
    g = max(min(cfg.moe_groups, t), 1)
    while t % g:
        g -= 1
    return g


def route(p, xf: torch.Tensor, cfg: ModelConfig):
    """Router probabilities (T, E) in float32 (float64 in a float64 model)
    — the product in the model dtype, then cast, as the reference — and the
    top-k (weights, experts)."""
    probs = torch.softmax(wide(xf @ p["router"]), dim=-1)
    top_w, top_e = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, top_w, top_e


def dispatch(top_e: torch.Tensor, cfg: ModelConfig, ng: int):
    """Each assignment's rank within its (group, expert), whether it is
    kept under the capacity, and the capacity: ``(pos, keep, cap)``, with
    ``pos`` and ``keep`` of shape (groups, T_g·k)."""
    e = cfg.n_experts
    t, k = top_e.shape
    cap = int(math.ceil(t // ng * k / e * cfg.capacity_factor))
    ge = top_e.reshape(ng, -1)
    oh = F.one_hot(ge, e).to(torch.int32)                 # (g, tg·k, e)
    rank = torch.cumsum(oh, dim=1, dtype=torch.int32) - oh  # prior count
    pos = torch.gather(rank, 2, ge[..., None])[..., 0]
    return pos, pos < cap, cap


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    ng = _dispatch_groups(cfg, t)
    tg = t // ng
    xf = x.reshape(t, d)

    probs, top_w, top_e = route(p, xf, cfg)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # Switch aux loss: fraction of assignments per expert × mean router prob
    load = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, top_e.reshape(-1), torch.ones(t * k, dtype=torch.float32,
                                         device=x.device)) / (t * k)
    aux = e * torch.sum(load * probs.mean(dim=0))

    # per-group capacity bucketing: rank within (group, expert) via cumsum
    pos, keep, cap = dispatch(top_e, cfg, ng)
    ge = top_e.reshape(ng, tg * k)
    w_kept = torch.where(keep, top_w.reshape(ng, tg * k), 0.0)
    rows = e * cap + 1                                     # + overflow row
    group = torch.arange(ng, device=x.device)[:, None]
    bucket = group * rows + torch.where(keep, ge * cap + pos, e * cap)
    src = xf.repeat_interleave(k, dim=0)                   # (t·k, d)
    buckets = torch.zeros(ng * rows, d, dtype=x.dtype, device=x.device)
    buckets.index_copy_(0, bucket.reshape(-1), src)
    buckets = buckets.reshape(ng, rows, d)[:, :-1].reshape(ng, e, cap, d)

    # batched per-expert SwiGLU
    g = F.silu(torch.einsum("gecd,edf->gecf", buckets, p["wg"]))
    u = torch.einsum("gecd,edf->gecf", buckets, p["wu"])
    yb = torch.einsum("gecf,efd->gecd", g * u, p["wd"])    # (g, e, cap, d)

    # gather back + weighted combine over the k assignments
    safe = group * (e * cap) + torch.where(keep, ge * cap + pos, 0)
    y_flat = yb.reshape(ng * e * cap, d).index_select(0, safe.reshape(-1))
    y = (y_flat * w_kept.reshape(-1, 1).to(y_flat.dtype)).reshape(t, k, d).sum(dim=1)

    out = y.reshape(b, s, d).to(x.dtype)
    if cfg.n_shared_experts:
        gs = F.silu(x @ p["swg"])
        us = x @ p["swu"]
        out = out + (gs * us) @ p["swd"]
    return out, aux


def router_stats(p, x: torch.Tensor, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Per-expert load counters — the group-by-expert aggregate — and the
    router's mean entropy."""
    t = x.shape[0] * x.shape[1]
    probs, _, top_e = route(p, x.reshape(t, -1), cfg)
    counts = torch.zeros(cfg.n_experts, dtype=torch.float32, device=x.device)
    counts.index_add_(0, top_e.reshape(-1),
                      torch.ones(top_e.numel(), dtype=torch.float32, device=x.device))
    return {"expert_load": counts, "router_entropy":
            -torch.mean(torch.sum(probs * torch.log(probs + 1e-9), dim=-1))}

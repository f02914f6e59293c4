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
gives the same values).  The reference's sharding constraints on the
buckets and the expert outputs stand where it has them (no-ops without a
mesh).

Under a mesh (x a DTensor) the dispatch runs on each rank's local tokens:
x's sequence is gathered and its batch kept over the batch axes where the
dispatch groups split evenly with it (else the tokens are replicated), so
each rank routes whole groups of its own.  DTensor has no sharding rule
for ``topk``, ``one_hot``/``cumsum`` ranks, ``index_copy_`` or
``index_select`` over a flattened (group, expert, slot) index, so these run
on plain local tensors: the router is replicated for them (one d × E
tensor), the load-balance loss's token sums are partial sums over the
batch axes, reduced by DTensor.  The buckets become a DTensor again for
the expert products, sharded over ``experts`` by the reference's
``constrain`` (expert parallelism over ``model``), and the expert outputs
are gathered over ``model`` for the combine.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import (constrain, fsdp,
                                              mesh_dims_sharding, place)
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


class _Tokens:
    """Where ``moe_apply``'s local tensors live: ``mesh`` None (plain
    tensors, every method the identity) or the mesh with the placements of
    the dispatch's tokens: batch over ``bdims`` (dimension 0), everything
    else replicated."""

    def __init__(self, x, ng: int):
        self.mesh = x.device_mesh if isinstance(x, DTensor) else None
        self.bdims = []
        if self.mesh is None:
            self.x = x
            return
        x = constrain(x, "batch", None, None)
        bdims = mesh_dims_sharding(x, 0)
        if ng % math.prod(self.mesh.size(i) for i in bdims):
            bdims = []                   # groups straddle ranks: replicate
        self.bdims = bdims
        self.x = place(x, self.mesh, self.placements())

    def placements(self, partial: bool = False):
        return tuple((Partial() if partial else Shard(0)) if i in self.bdims
                     else Replicate() for i in range(self.mesh.ndim))

    def local(self, t):
        return t.to_local() if isinstance(t, DTensor) else t

    def replicated(self, w):
        """A parameter whole on every rank, as a local tensor whose
        gradient is a partial sum over the batch axes."""
        if self.mesh is None:
            return w
        w = place(w, self.mesh, (Replicate(),) * self.mesh.ndim)
        return w.to_local(grad_placements=self.placements(partial=True))

    def like_x(self, t):
        """A local tensor with one row block a rank, as a DTensor."""
        if self.mesh is None:
            return t
        return DTensor.from_local(t, self.mesh, self.placements(),
                                  run_check=False)

    def total(self, t):
        """The sum over every rank's tokens of a local partial sum."""
        if self.mesh is None:
            return t
        return DTensor.from_local(t, self.mesh, self.placements(partial=True),
                                  run_check=False).redistribute(
            self.mesh, (Replicate(),) * self.mesh.ndim)


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    ng = _dispatch_groups(cfg, t)
    tg = t // ng
    tok = _Tokens(x, ng)
    xf = tok.local(tok.x).reshape(-1, d)                  # this rank's tokens
    ngl = xf.shape[0] // tg                               # and its groups

    probs, top_w, top_e = route({"router": tok.replicated(p["router"])}, xf, cfg)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # Switch aux loss: fraction of assignments per expert × mean router prob
    counts = torch.zeros(e, dtype=torch.float32, device=xf.device).index_add_(
        0, top_e.reshape(-1), torch.ones(top_e.numel(), dtype=torch.float32,
                                         device=xf.device))
    if tok.mesh is None:
        load, mean_p = counts / (t * k), probs.mean(dim=0)
    else:
        load, mean_p = tok.total(counts) / (t * k), tok.total(probs.sum(dim=0)) / t
    aux = e * torch.sum(load * mean_p)

    # per-group capacity bucketing: rank within (group, expert) via cumsum
    pos, keep, cap = dispatch(top_e, cfg, ngl)
    ge = top_e.reshape(ngl, tg * k)
    w_kept = torch.where(keep, top_w.reshape(ngl, tg * k), 0.0)
    rows = e * cap + 1                                     # + overflow row
    group = torch.arange(ngl, device=xf.device)[:, None]
    bucket = group * rows + torch.where(keep, ge * cap + pos, e * cap)
    src = xf.repeat_interleave(k, dim=0)                   # (t·k, d)
    buckets = torch.zeros(ngl * rows, d, dtype=x.dtype, device=xf.device)
    buckets.index_copy_(0, bucket.reshape(-1), src)
    buckets = buckets.reshape(ngl, rows, d)[:, :-1].reshape(ngl, e, cap, d)
    buckets = constrain(tok.like_x(buckets), "batch", "experts", None, None)

    # batched per-expert SwiGLU
    g = F.silu(torch.einsum("gecd,edf->gecf", buckets, fsdp(p["wg"])))
    u = torch.einsum("gecd,edf->gecf", buckets, fsdp(p["wu"]))
    yb = torch.einsum("gecf,efd->gecd", g * u, fsdp(p["wd"]))  # (g, e, cap, d)
    yb = constrain(yb, "batch", "experts", None, None)
    if tok.mesh is not None:                               # every expert's rows
        yb = place(yb, tok.mesh, tok.placements())

    # gather back + weighted combine over the k assignments
    safe = group * (e * cap) + torch.where(keep, ge * cap + pos, 0)
    y_flat = tok.local(yb).reshape(ngl * e * cap, d).index_select(0, safe.reshape(-1))
    y = (y_flat * w_kept.reshape(-1, 1).to(y_flat.dtype)).reshape(-1, k, d).sum(dim=1)

    out = tok.like_x(y.reshape(-1, s, d).to(x.dtype))
    if cfg.n_shared_experts:
        gs = F.silu(tok.x @ fsdp(p["swg"]))
        us = tok.x @ fsdp(p["swu"])
        out = out + (gs * us) @ fsdp(p["swd"])
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

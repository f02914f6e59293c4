"""Train and prefill steps; counterpart of ``repro/train/step.py``.

Features:
  * chunked cross-entropy — the LM head + softmax run over sequence chunks,
    each rematerialised in the backward pass, so (B, S, vocab) float32
    logits never exist at once;
  * microbatch gradient accumulation: a loop over ``grad_accum`` slices of
    the batch, the gradients summed in float32;
  * optional int8 error-feedback gradient compression between accumulation
    and the optimizer (``distributed/compression.py``);
  * AdamW with global-norm clipping, cosine/WSD schedules.

Gradients come from ``torch.autograd``; the models rematerialise each layer
when ``cfg.remat`` is set.  State layout (a plain dict tree): params / m /
v / step / (ef residual); a step updates its tensors in place (the
reference's launcher donates them) and returns the state with
``{"loss", "grad_norm", "lr"}`` as device tensors: nothing in a step reads
a value on the host.

With a mesh (a ``DeviceMesh`` with the reference's axis names) the steps
run under ``distributed/sharding.py``'s ``mesh_context``: the state is a
tree of DTensors placed by ``state_pspecs`` (``shard_tree``), the batch by
``batch_pspecs``' rule (a plain batch, the same on every rank, is cut
locally; a sharded one is gathered first when ``grad_accum`` slices it into
microbatches: token ids only), gradients come back in their parameter's
placements, the optimizer and the gradient compression run on the local
shards, and the metrics are plain replicated tensors on every rank.
``abstract_state`` gives the state's shapes and dtypes on the ``meta``
device, with no allocation.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed import compression as comp
from repro_torch.distributed.sharding import (P, carry_mesh, constrain, fsdp,
                                              mesh_context, param_pspecs, place,
                                              rules_for, spec_for)
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_params, logits_apply, map_specs, wide
from repro_torch.train import adamw
from repro_torch.train.schedules import SCHEDULES

#: attention implementations a train step takes: the flash kernel has no
#: backward (nor has the reference's Pallas kernel)
TRAIN_ATTN = ("dense", "chunked")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    peak_lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"
    adam: adamw.AdamWConfig = dataclasses.field(default_factory=adamw.AdamWConfig)
    ce_chunk: int = 512
    grad_accum: int = 1
    aux_loss_weight: float = 0.01
    compress_grads: bool = False
    attn_impl: str = "chunked"


def _ce_sum(params, xi, li, mi):
    """Σ (log-sum-exp − gold logit) · mask over one chunk: the head's
    logits in float32 (float64 for a float64 model).  Under a mesh the
    chunk's sequence is gathered first: a chunk that spans the whole
    sequence keeps the stream's sequence sharding, and the head's product
    would flatten it with the batch (torch 2.11 refuses that view)."""
    xi = constrain(xi, "batch", None, None)
    logits = wide(logits_apply(params, xi))
    logits = constrain(logits, "batch", None, "vocab")
    if isinstance(logits, DTensor):
        return _local_ce_sum(logits, li, mi)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, li[..., None].long())[..., 0]
    return torch.sum((lse - gold) * mi)


def _local_ce_sum(logits, li, mi):
    """``_ce_sum`` under a mesh: the chunk's logits gathered over vocab,
    then the sum over each rank's own rows on local tensors, all-reduced
    over the batch's ranks.  DTensor's gather of a gold logit from
    vocab-sharded logits gives a masked partial sum that its later ops
    fail to reduce (torch 2.11 and 2.13), and whether it shards the gather
    is its cost model's choice: so none is asked of it."""
    logits = constrain(logits, "batch", None, None)
    li, mi = constrain(li, "batch", None), constrain(mi, "batch", None)
    ll = logits.to_local()
    lse = torch.logsumexp(ll, dim=-1)
    gold = torch.gather(ll, -1, li.to_local()[..., None].long())[..., 0]
    part = torch.sum((lse - gold) * mi.to_local())
    mesh = logits.device_mesh
    rows = tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in logits.placements)
    return DTensor.from_local(part, mesh, rows, run_check=False).redistribute(
        mesh, [Replicate()] * mesh.ndim)


def chunked_ce(params, x, labels, mask, cfg: ModelConfig, chunk: int):
    """Mean next-token CE; the head applied per sequence chunk, each chunk
    rematerialised under grad.  The last chunk may be shorter (the
    reference pads it with masked rows: the same sum)."""
    s = x.shape[1]
    chunk = min(chunk, s)
    params = {"embedding": fsdp(params["embedding"])}     # gathered once

    def chunk_loss(xi, li, mi):
        return _ce_sum(params, xi, li, mi)

    if torch.is_grad_enabled():
        def run(*xs):
            return checkpoint(carry_mesh(chunk_loss), *xs, use_reentrant=False,
                              preserve_rng_state=False)
    else:
        run = chunk_loss
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, chunk):
        total = total + run(x[:, i:i + chunk], labels[:, i:i + chunk],
                            mask[:, i:i + chunk])
    return total / mask.sum().clamp_min(1.0)


def _loss_fn(params, batch, cfg: ModelConfig, tcfg: TrainConfig):
    x, aux = M.forward_hidden(params, batch, cfg, impl=tcfg.attn_impl)
    tokens = batch["tokens"]
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    mask[:, -1] = 0.0
    loss = chunked_ce(params, x, labels, mask, cfg, tcfg.ce_chunk)
    loss = loss + tcfg.aux_loss_weight * aux["aux_loss"]
    return loss, aux


def _check_attn(tcfg: TrainConfig) -> None:
    if tcfg.attn_impl not in TRAIN_ATTN:
        raise ValueError(
            f"a train step takes attn_impl in {TRAIN_ATTN}, not "
            f"{tcfg.attn_impl!r}: the flash_attention kernel has no backward "
            "(the reference's Pallas kernel has none either)")


def _value(t):
    """A metric as a plain tensor: a DTensor's replicated value."""
    if isinstance(t, DTensor):
        return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim).to_local()
    return t


def _placed(batch):
    """Under a mesh each batch leaf cut to its batch shard (``batch_pspecs``'
    spec, replicated where the batch axes do not divide it); as it is
    without one."""
    return {k: constrain(a, "batch", *([None] * (a.dim() - 1)))
            for k, a in batch.items()}


def _whole(t):
    """A batch leaf whole on every rank: a sharded one is gathered (token
    ids, a few MB at most)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None, rules=None):
    """Returns train_step(state, batch) -> (state, metrics); with ``mesh``
    the step runs on its ranks (every rank calls it alike)."""
    _check_attn(tcfg)
    sched = SCHEDULES[tcfg.schedule]

    def grads_of(params, leaves, batch):
        loss, _ = _loss_fn(params, _placed(batch), cfg, tcfg)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach has a zero gradient, as in JAX;
        # under a mesh each comes back in its parameter's placements
        return loss.detach(), [torch.zeros_like(p) if g is None else
                               place(g, p.device_mesh, p.placements)
                               if isinstance(p, DTensor) else g
                               for p, g in zip(leaves, gs)]

    def train_step(state, batch):
        with mesh_context(mesh, rules):
            return step_body(state, batch)

    def step_body(state, batch):
        params = state["params"]
        leaves = adamw.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                if tcfg.grad_accum > 1:
                    n = tcfg.grad_accum
                    batch = {k: _whole(a) for k, a in batch.items()}
                    per = batch["tokens"].shape[0] // n
                    sums = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
                    loss = torch.zeros((), dtype=torch.float32,
                                       device=batch["tokens"].device)
                    for i in range(n):
                        mb = {k: a[i * per:(i + 1) * per] for k, a in batch.items()}
                        lm, gs = grads_of(params, leaves, mb)
                        for s, g in zip(sums, gs):
                            s.add_(g)
                        loss = loss + lm
                        del gs
                    for s in sums:
                        s.div_(n)
                    grads, loss = sums, loss / n
                else:
                    loss, grads = grads_of(params, leaves, batch)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = adamw.tree_unflatten(params, grads)

        if tcfg.compress_grads:
            grads, new_ef = comp.compress_decompress(grads, state["ef"])
        else:
            new_ef = state.get("ef")

        lr = sched(adamw.local(state["step"]), peak_lr=tcfg.peak_lr,
                   warmup=tcfg.warmup, total=tcfg.total_steps)
        new_p, new_m, new_v, gnorm = adamw.update(
            params, grads, state["m"], state["v"], state["step"], lr, tcfg.adam)
        del grads
        new_state = {"params": new_p, "m": new_m, "v": new_v,
                     "step": state["step"] + 1}
        if new_ef is not None:
            new_state["ef"] = new_ef
        return new_state, {"loss": _value(loss), "grad_norm": gnorm, "lr": lr}

    return train_step


def make_prefill_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None, rules=None):
    """Forward-only prefill: backbone + last-position logits (under a mesh
    a DTensor, batch over the batch axes and vocab over ``model``)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        with mesh_context(mesh, rules):
            x, _ = M.forward_hidden(params, _placed(batch), cfg,
                                    impl=tcfg.attn_impl)
            # the last position of a sequence-sharded x: gathered first
            x = constrain(x, "batch", None, None)
            return logits_apply(params, x[:, -1:, :])

    return prefill_step


# ---------------------------------------------------------------------------
# State construction
# ---------------------------------------------------------------------------


def init_state(cfg: ModelConfig, tcfg: TrainConfig,
               generator: torch.Generator, device="cuda") -> Dict[str, Any]:
    """Random parameters from ``generator`` (on ``device``), zero float32
    moments, ``step`` an int32 scalar on ``device`` (the card unless the
    caller asks for the CPU), and the error-feedback residuals when
    ``compress_grads``."""
    device = resolve_device(device)
    params = init_params(M.model_specs(cfg), generator, cfg.torch_dtype, device)
    m, v = adamw.init_moments(params)
    state = {"params": params, "m": m, "v": v,
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if tcfg.compress_grads:
        state["ef"] = adamw.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
            params)
    return state


def abstract_state(cfg: ModelConfig, tcfg: TrainConfig) -> Dict[str, Any]:
    """The state's tree of shapes and dtypes as tensors on the ``meta``
    device: nothing is allocated (the reference's ``ShapeDtypeStruct``
    tree)."""
    params = map_specs(lambda s: torch.empty(s.shape, dtype=cfg.torch_dtype,
                                             device="meta"), M.model_specs(cfg))
    f32 = functools.partial(torch.empty_like, dtype=torch.float32)
    state = {"params": params, "m": adamw.tree_map(f32, params),
             "v": adamw.tree_map(f32, params),
             "step": torch.empty((), dtype=torch.int32, device="meta")}
    if tcfg.compress_grads:
        state["ef"] = adamw.tree_map(f32, params)
    return state


def state_pspecs(cfg: ModelConfig, tcfg: TrainConfig, mesh):
    rules = rules_for(mesh)
    pspec = param_pspecs(M.model_specs(cfg), rules, mesh)
    state = {"params": pspec, "m": pspec, "v": pspec, "step": P()}
    if tcfg.compress_grads:
        state["ef"] = pspec
    return state


def batch_pspecs(cfg: ModelConfig, mesh):
    rules = rules_for(mesh)
    bspec = spec_for(("batch", None), rules)
    out = {"tokens": bspec}
    if cfg.family == "vlm":
        out["vision"] = spec_for(("batch", None, None), rules)
    if cfg.family == "audio":
        out["frames"] = spec_for(("batch", None, None), rules)
    return out

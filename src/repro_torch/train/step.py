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
a value on the host.  The steps take no mesh: sharding waits for the
port's ``distributed/sharding.py``, and with it the reference's
``abstract_state``, ``state_pspecs`` and ``batch_pspecs``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed import compression as comp
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_params, logits_apply, wide
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
    logits in float32 (float64 for a float64 model)."""
    logits = wide(logits_apply(params, xi))
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, li[..., None].long())[..., 0]
    return torch.sum((lse - gold) * mi)


def chunked_ce(params, x, labels, mask, cfg: ModelConfig, chunk: int):
    """Mean next-token CE; the head applied per sequence chunk, each chunk
    rematerialised under grad.  The last chunk may be shorter (the
    reference pads it with masked rows: the same sum)."""
    s = x.shape[1]
    chunk = min(chunk, s)

    def chunk_loss(xi, li, mi):
        return _ce_sum(params, xi, li, mi)

    if torch.is_grad_enabled():
        def run(*xs):
            return checkpoint(chunk_loss, *xs, use_reentrant=False,
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


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns train_step(state, batch) -> (state, metrics)."""
    _check_attn(tcfg)
    sched = SCHEDULES[tcfg.schedule]

    def grads_of(params, leaves, batch):
        loss, _ = _loss_fn(params, batch, cfg, tcfg)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not reach has a zero gradient, as in JAX
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, gs)]

    def train_step(state, batch):
        params = state["params"]
        leaves = adamw.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                if tcfg.grad_accum > 1:
                    n = tcfg.grad_accum
                    per = batch["tokens"].shape[0] // n
                    sums = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                            for p in leaves]
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

        lr = sched(state["step"], peak_lr=tcfg.peak_lr, warmup=tcfg.warmup,
                   total=tcfg.total_steps)
        new_p, new_m, new_v, gnorm = adamw.update(
            params, grads, state["m"], state["v"], state["step"], lr, tcfg.adam)
        del grads
        new_state = {"params": new_p, "m": new_m, "v": new_v,
                     "step": state["step"] + 1}
        if new_ef is not None:
            new_state["ef"] = new_ef
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step


def make_prefill_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Forward-only prefill: backbone + last-position logits."""

    @torch.no_grad()
    def prefill_step(params, batch):
        x, _ = M.forward_hidden(params, batch, cfg, impl=tcfg.attn_impl)
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

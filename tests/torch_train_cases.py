"""Shared cases of the port's training tests (``test_torch_train.py``,
``test_torch_train_families.py``): smoke configs at S = 16 with a 6-row
attention chunk and a 5-row CE chunk (both end ragged), parameters and
batches from numpy seeds that both packages receive, and the reference's
loss and gradients compiled once a (config, impl)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.train import step as JS
from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.models.layers import map_specs
from repro_torch.train import step as TS
from repro_torch.train.adamw import tree_leaves

B, S = 2, 16
ATTN_CHUNK, CE_CHUNK = 6, 5
#: losses to 1e-5; each gradient leaf to a relative L2 error of 1e-5
#: (float32 summed in other orders through three or four layers reads up
#: to 2e-6)
LOSS_TOL = 1e-5
GRAD_REL = 1e-5


def rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def cfgs(arch):
    """The reference's and the port's smoke config of ``arch``."""
    ov = dict(attn_chunk=ATTN_CHUNK)
    if arch == "h2o-danube-3-4b":
        ov["window"] = 6                   # a window that binds at S = 16
    return jconfigs.get_smoke(arch).with_(**ov), configs.get_smoke(arch).with_(**ov)


def np_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision"] = rng.standard_normal((B, cfg.vision_tokens, cfg.d_model)
                                            ).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal((B, cfg.encoder_frames, cfg.d_model)
                                            ).astype(np.float32)
    return out


def np_params(cfg, seed=0):
    """Parameters for ``cfg`` from numpy, by the port's spec tree (the
    reference's keys and shapes): normal leaves N(0, 1)·scale, ones and
    zeros as specified."""
    rng = np.random.default_rng(seed)

    def make(spec):
        if spec.init == "zeros":
            return np.zeros(spec.shape, np.float32)
        if spec.init == "ones":
            return np.ones(spec.shape, np.float32)
        return (spec.scale * rng.standard_normal(spec.shape)).astype(np.float32)

    return map_specs(make, M.model_specs(cfg))


_J_GRAD = jax.jit(jax.value_and_grad(JS._loss_fn, has_aux=True), static_argnums=(2, 3))


def ref_impl(cfg, impl):
    """The reference's ``chunked`` masks cross-attention keys past the
    query length (``kv_len=s``, ``repro/models/layers.py``): whisper's
    decoder (16 tokens over 24 frames) is held against its ``dense``."""
    return "dense" if cfg.family == "audio" else impl


@functools.lru_cache(maxsize=None)
def reference(arch, impl):
    """The parameters, batch, and the reference's loss and gradient
    leaves (``jax.value_and_grad(repro.train.step._loss_fn)``)."""
    jcfg, cfg = cfgs(arch)
    params = np_params(cfg)
    batch = np_batch(cfg, 1)
    tcfg = JS.TrainConfig(ce_chunk=CE_CHUNK, attn_impl=ref_impl(cfg, impl))
    (loss, _), grads = _J_GRAD(jax.tree.map(jnp.asarray, params),
                               {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, tcfg)
    return params, batch, float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def port_grads(params, batch, cfg, impl):
    """The port's loss and gradient leaves by autograd."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, _ = TS._loss_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                              cfg, TS.TrainConfig(ce_chunk=CE_CHUNK, attn_impl=impl))
        return float(loss.detach()), torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)

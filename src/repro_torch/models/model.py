"""Model assembly for the dense family; counterpart of
``repro/models/model.py``.

The same entry points as the reference:

  model_specs(cfg)                  -> ParamSpec tree (init)
  forward(params, batch, cfg, impl) -> (logits, aux dict)       [prefill]
  cache_specs(cfg, batch, max_len)  -> ParamSpec tree for the decode cache
  decode_step(params, cache, tokens, pos, cfg) -> (logits, cache)

The reference's ``lax.scan`` over stacked layers is a Python loop that
indexes the stacked tensors; its ``remat`` and ``scan_unroll`` switches
(compile-time choices of XLA) have no counterpart.  Without a mesh the
reference's sharding constraints are no-ops: the port leaves them out until
sharding is ported (ROADMAP Queue 1).  Only ``family == "dense"`` is
ported; the other families raise ``NotImplementedError`` naming their
ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (ParamSpec, attn_apply, attn_specs,
                                       embed_apply, embed_specs, logits_apply,
                                       map_specs, mlp_apply, mlp_specs, p_,
                                       rms_norm)


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.kv_lora:
        what = "MLA attention" if cfg.kv_lora else f"the {cfg.family!r} family"
        raise NotImplementedError(
            f"{cfg.name}: {what} is not ported yet (ROADMAP Queue 1 item 2: "
            "the remaining LM families)")


# --------------------------------------------------------------------------
# Spec helpers
# --------------------------------------------------------------------------


def stack_specs(specs, n: int):
    """Add a leading stacked-layers dim to every ParamSpec in the tree."""
    return map_specs(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.init,
                            s.scale), specs)


def _norm(d):
    return p_((d,), ("embed",), init="ones")


def dense_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {"ln1": _norm(d), "attn": attn_specs(cfg), "ln2": _norm(d),
            "mlp": mlp_specs(d, cfg.d_ff)}


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    _dense_only(cfg)
    s: Dict[str, Any] = dict(embed_specs(cfg))
    s["layers"] = stack_specs(dense_block_specs(cfg), cfg.n_layers)
    return s


def layer(stacked, i: int):
    """Layer ``i`` of a stacked tree: views, so an in-place write into a
    cache layer writes into the stack."""
    if isinstance(stacked, torch.Tensor):
        return stacked[i]
    return {k: layer(v, i) for k, v in stacked.items()}


# --------------------------------------------------------------------------
# Blocks (apply)
# --------------------------------------------------------------------------


def dense_block(p, x, cfg, *, positions, impl, cache=None, decode_pos=None):
    h, nc = attn_apply(p["attn"], rms_norm(x, p["ln1"]), cfg,
                       positions=positions, impl=impl, cache=cache,
                       decode_pos=decode_pos)
    x = x + h
    x = x + mlp_apply(p["mlp"], rms_norm(x, p["ln2"]))
    return x, nc


# --------------------------------------------------------------------------
# Forward (prefill)
# --------------------------------------------------------------------------


def forward(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            impl: str = "flash") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    x, aux = forward_hidden(params, batch, cfg, impl)
    return logits_apply(params, x), aux


def forward_hidden(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                   impl: str = "flash") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Backbone forward up to the final norm.  ``batch["tokens"]`` is a
    (B, S) integer tensor on the parameters' device."""
    _dense_only(cfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    x = embed_apply(params, tokens).to(cfg.torch_dtype)
    stacked = params["layers"]
    for i in range(cfg.n_layers):
        x, _ = dense_block(layer(stacked, i), x, cfg, positions=positions,
                           impl=impl)
    x = rms_norm(x, params["final_norm"])
    return x, {"aux_loss": torch.zeros((), dtype=torch.float32,
                                       device=x.device)}


# --------------------------------------------------------------------------
# Decode caches + serve step
# --------------------------------------------------------------------------


def _kv_cache_specs(cfg: ModelConfig, n: int, batch: int, max_len: int):
    # sliding-window archs only need a window-sized cache (a ring buffer)
    t = min(max_len, cfg.window) if cfg.window else max_len
    return {"k": p_((n, batch, t, cfg.n_kv, cfg.hd),
                    ("layers", "cache_batch", "cache_seq", "kv", None), init="zeros"),
            "v": p_((n, batch, t, cfg.n_kv, cfg.hd),
                    ("layers", "cache_batch", "cache_seq", "kv", None), init="zeros")}


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Any]:
    _dense_only(cfg)
    return {"kv": _kv_cache_specs(cfg, cfg.n_layers, batch, max_len)}


def decode_step(params, cache, tokens, pos: int, cfg: ModelConfig):
    """One-token decode.  tokens: (B, 1); pos: the cache fill level.  The
    cache is updated in place (the reference returns a new one) and returned
    with the logits."""
    _dense_only(cfg)
    b = tokens.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=tokens.device)
    x = embed_apply(params, tokens).to(cfg.torch_dtype)
    for i in range(cfg.n_layers):
        x, _ = dense_block(layer(params["layers"], i), x, cfg,
                           positions=positions, impl="dense",
                           cache=layer(cache["kv"], i), decode_pos=pos)
    x = rms_norm(x, params["final_norm"])
    return logits_apply(params, x), cache

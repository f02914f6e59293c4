"""Model assembly for the dense, MoE, SSM and hybrid families; counterpart
of ``repro/models/model.py``.

The same entry points as the reference:

  model_specs(cfg)                  -> ParamSpec tree (init)
  forward(params, batch, cfg, impl) -> (logits, aux dict)       [prefill]
  cache_specs(cfg, batch, max_len)  -> ParamSpec tree for the decode cache
  decode_step(params, cache, tokens, pos, cfg) -> (logits, cache)

The reference's ``lax.scan`` over stacked layers is a Python loop that
indexes the stacked tensors (two levels for the hybrid's groups); its
``remat`` and ``scan_unroll`` switches (compile-time choices of XLA) have
no counterpart.  Without a mesh the reference's sharding constraints are
no-ops: the port leaves them out until sharding is ported (ROADMAP Queue
1).  MLA attention and the ``vlm`` and ``audio`` families raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (ParamSpec, attn_apply, attn_specs,
                                       embed_apply, embed_specs, init_params,
                                       logits_apply, map_specs, mlp_apply,
                                       mlp_specs, p_, rms_norm)

FAMILIES = ("dense", "moe", "ssm", "hybrid")


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.kv_lora:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention is not ported yet (ROADMAP Queue 1 "
            "item 4: MLA)")
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            "(ROADMAP Queue 1 item 5: VLM and audio)")
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


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


def moe_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {"ln1": _norm(d), "attn": attn_specs(cfg), "ln2": _norm(d),
            "moe": moe_mod.moe_specs(cfg)}


def ssm_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln1": _norm(cfg.d_model), "mamba": m2.mamba_specs(cfg)}


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    _check_ported(cfg)
    s: Dict[str, Any] = dict(embed_specs(cfg))
    fam = cfg.family
    if fam == "dense":
        s["layers"] = stack_specs(dense_block_specs(cfg), cfg.n_layers)
    elif fam == "moe":
        s["layers"] = stack_specs(moe_block_specs(cfg), cfg.n_layers)
    elif fam == "ssm":
        s["layers"] = stack_specs(ssm_block_specs(cfg), cfg.n_layers)
    else:                                                   # hybrid
        g, r = divmod(cfg.n_layers, cfg.attn_every)
        s["groups"] = stack_specs(stack_specs(ssm_block_specs(cfg), cfg.attn_every), g)
        if r:
            s["tail"] = stack_specs(ssm_block_specs(cfg), r)
        s["shared_attn"] = dense_block_specs(cfg)    # ONE shared block, reused
    return s


def layer(stacked, *idx: int):
    """Layer ``idx`` of a stacked tree (two indices for the hybrid's
    groups): views, so an in-place write into a cache layer writes into the
    stack."""
    if isinstance(stacked, torch.Tensor):
        return stacked[idx]
    return {k: layer(v, *idx) for k, v in stacked.items()}


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


def moe_block(p, x, cfg, *, positions, impl, cache=None, decode_pos=None):
    h, nc = attn_apply(p["attn"], rms_norm(x, p["ln1"]), cfg,
                       positions=positions, impl=impl, cache=cache,
                       decode_pos=decode_pos)
    x = x + h
    h, aux = moe_mod.moe_apply(p["moe"], rms_norm(x, p["ln2"]), cfg)
    return x + h, nc, aux


def ssm_block(p, x, cfg, *, state=None):
    """With a ``state`` (views into the decode cache), the new state is
    written into it in place."""
    h, ns = m2.mamba_apply(p["mamba"], rms_norm(x, p["ln1"]), cfg, state=state)
    if state is not None:
        state["h"].copy_(ns["h"])
        state["conv"].copy_(ns["conv"])
    return x + h


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
    (B, S) integer tensor on the parameters' device; ``aux["aux_loss"]`` is
    the MoE load-balance loss averaged over the layers (0 elsewhere)."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    x = embed_apply(params, tokens).to(cfg.torch_dtype)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    fam = cfg.family
    if fam == "dense":
        for i in range(cfg.n_layers):
            x, _ = dense_block(layer(params["layers"], i), x, cfg,
                               positions=positions, impl=impl)
    elif fam == "moe":
        for i in range(cfg.n_layers):
            x, _, a = moe_block(layer(params["layers"], i), x, cfg,
                                positions=positions, impl=impl)
            aux_total = aux_total + a
    elif fam == "ssm":
        for i in range(cfg.n_layers):
            x = ssm_block(layer(params["layers"], i), x, cfg)
    else:                                                   # hybrid
        g, r = divmod(cfg.n_layers, cfg.attn_every)
        for gi in range(g):
            for li in range(cfg.attn_every):
                x = ssm_block(layer(params["groups"], gi, li), x, cfg)
            x, _ = dense_block(params["shared_attn"], x, cfg,
                               positions=positions, impl=impl)
        for i in range(r):
            x = ssm_block(layer(params["tail"], i), x, cfg)
    x = rms_norm(x, params["final_norm"])
    return x, {"aux_loss": aux_total / max(cfg.n_layers, 1)}


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


def _ssm_state_specs(cfg: ModelConfig, lead: Tuple[int, ...], batch: int):
    nh, n, hp = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    din = cfg.expand * cfg.d_model
    laxes = ("layers",) * len(lead)
    return {"h": ParamSpec(lead + (batch, nh, n, hp),
                           laxes + ("cache_batch", "heads", None, None), "zeros", 0.0),
            "conv": ParamSpec(lead + (batch, 3, din + 2 * n),
                              laxes + ("cache_batch", None, None), "zeros", 0.0)}


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Any]:
    _check_ported(cfg)
    fam = cfg.family
    if fam in ("dense", "moe"):
        return {"kv": _kv_cache_specs(cfg, cfg.n_layers, batch, max_len)}
    if fam == "ssm":
        return {"ssm": _ssm_state_specs(cfg, (cfg.n_layers,), batch)}
    g, r = divmod(cfg.n_layers, cfg.attn_every)             # hybrid
    out = {"groups": _ssm_state_specs(cfg, (g, cfg.attn_every), batch),
           "shared_kv": _kv_cache_specs(cfg, g, batch, max_len)}
    if r:
        out["tail"] = _ssm_state_specs(cfg, (r,), batch)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """A zero decode cache of ``cache_specs`` on ``device`` (the card unless
    the caller asks for the CPU): SSM states ``h`` in float32, as
    ``mamba2.init_mamba_state`` makes them, the rest in the model dtype."""
    def f32_states(tree):
        if isinstance(tree, torch.Tensor):
            return tree
        return {k: v.float() if k == "h" else f32_states(v) for k, v in tree.items()}

    return f32_states(init_params(cache_specs(cfg, batch, max_len), None,
                                  cfg.torch_dtype, device))


def decode_step(params, cache, tokens, pos: int, cfg: ModelConfig):
    """One-token decode.  tokens: (B, 1); pos: the cache fill level.  The
    cache is updated in place (the reference returns a new one) and returned
    with the logits."""
    _check_ported(cfg)
    b = tokens.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=tokens.device)
    x = embed_apply(params, tokens).to(cfg.torch_dtype)
    fam = cfg.family
    if fam in ("dense", "moe"):
        block = dense_block if fam == "dense" else moe_block
        for i in range(cfg.n_layers):
            x = block(layer(params["layers"], i), x, cfg, positions=positions,
                      impl="dense", cache=layer(cache["kv"], i), decode_pos=pos)[0]
    elif fam == "ssm":
        for i in range(cfg.n_layers):
            x = ssm_block(layer(params["layers"], i), x, cfg,
                          state=layer(cache["ssm"], i))
    else:                                                   # hybrid
        g, r = divmod(cfg.n_layers, cfg.attn_every)
        for gi in range(g):
            for li in range(cfg.attn_every):
                x = ssm_block(layer(params["groups"], gi, li), x, cfg,
                              state=layer(cache["groups"], gi, li))
            x, _ = dense_block(params["shared_attn"], x, cfg, positions=positions,
                               impl="dense", cache=layer(cache["shared_kv"], gi),
                               decode_pos=pos)
        for i in range(r):
            x = ssm_block(layer(params["tail"], i), x, cfg,
                          state=layer(cache["tail"], i))
    x = rms_norm(x, params["final_norm"])
    return logits_apply(params, x), cache

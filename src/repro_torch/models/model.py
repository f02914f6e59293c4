"""Model assembly for every family: dense, MoE (with MLA attention for
deepseek), SSM, hybrid, VLM and audio; counterpart of
``repro/models/model.py``.

The same entry points as the reference:

  model_specs(cfg)                  -> ParamSpec tree (init)
  forward(params, batch, cfg, impl) -> (logits, aux dict)       [prefill]
  cache_specs(cfg, batch, max_len)  -> ParamSpec tree for the decode cache
  encode_context(params, batch, cfg) -> the context decode_step reads
  decode_step(params, cache, tokens, pos, cfg, context) -> (logits, cache)

The reference's ``lax.scan`` over stacked layers is a Python loop that
indexes the stacked tensors (two levels for the hybrid's groups and the
VLM's super-blocks).  Its ``remat`` is ``torch.utils.checkpoint`` around
each layer, taken only under grad (``_maybe_remat``); its ``scan_unroll``
(a switch of XLA's cost analysis) has no counterpart.  The reference's
sharding constraints (``distributed/sharding.py`` ``constrain``) stand
where it has them: no-ops without a mesh.  Under a mesh (the train, prefill
and serve steps' ``mesh_context``) parameters, activations and the decode
cache are DTensors, for every family: attention (GQA, MLA's expanded
heads, cross-attention over a context) runs on each rank's local heads,
the SSD on each rank's local SSM heads, and decode writes each new cache
entry or state on the ranks that hold it.  The context a VLM or audio
model reads is placed like a batch (``encode_context``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import carry_mesh, constrain, fsdp
from repro_torch.models import mamba2 as m2
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (ParamSpec, attn_apply, attn_specs,
                                       embed_apply, embed_specs, init_params,
                                       logits_apply, map_specs, mlp_apply,
                                       mlp_specs, p_, proj_heads, rms_norm)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def _check_family(cfg: ModelConfig) -> None:
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


def _self_attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    return mla_mod.mla_specs(cfg) if cfg.kv_lora else attn_specs(cfg)


def dense_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {"ln1": _norm(d), "attn": _self_attn_specs(cfg), "ln2": _norm(d),
            "mlp": mlp_specs(d, cfg.d_ff)}


def moe_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {"ln1": _norm(d), "attn": _self_attn_specs(cfg), "ln2": _norm(d),
            "moe": moe_mod.moe_specs(cfg)}


def ssm_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln1": _norm(cfg.d_model), "mamba": m2.mamba_specs(cfg)}


def cross_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {"ln1": _norm(d), "attn": attn_specs(cfg), "ln2": _norm(d),
            "mlp": mlp_specs(d, cfg.d_ff)}


def model_specs(cfg: ModelConfig) -> Dict[str, Any]:
    _check_family(cfg)
    s: Dict[str, Any] = dict(embed_specs(cfg))
    fam = cfg.family
    if fam == "dense":
        s["layers"] = stack_specs(dense_block_specs(cfg), cfg.n_layers)
    elif fam == "moe":
        s["layers"] = stack_specs(moe_block_specs(cfg), cfg.n_layers)
    elif fam == "ssm":
        s["layers"] = stack_specs(ssm_block_specs(cfg), cfg.n_layers)
    elif fam == "hybrid":
        g, r = divmod(cfg.n_layers, cfg.attn_every)
        s["groups"] = stack_specs(stack_specs(ssm_block_specs(cfg), cfg.attn_every), g)
        if r:
            s["tail"] = stack_specs(ssm_block_specs(cfg), r)
        s["shared_attn"] = dense_block_specs(cfg)    # ONE shared block, reused
    elif fam == "vlm":
        if cfg.n_layers % cfg.cross_every:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not "
                             f"super-blocks of {cfg.cross_every}")
        n_super, n_self = _super_blocks(cfg)
        s["super"] = {
            "self": stack_specs(stack_specs(dense_block_specs(cfg), n_self), n_super),
            "cross": stack_specs(cross_block_specs(cfg), n_super),
        }
    else:                                                   # audio
        s["enc_pos"] = p_((cfg.encoder_frames, cfg.d_model), (None, "embed"))
        s["encoder"] = stack_specs(dense_block_specs(cfg), cfg.encoder_layers)
        s["enc_norm"] = _norm(cfg.d_model)
        dec = {"ln1": _norm(cfg.d_model), "self": attn_specs(cfg),
               "ln2": _norm(cfg.d_model), "cross": attn_specs(cfg),
               "ln3": _norm(cfg.d_model), "mlp": mlp_specs(cfg.d_model, cfg.d_ff)}
        s["decoder"] = stack_specs(dec, cfg.n_layers)
    return s


def _super_blocks(cfg: ModelConfig) -> Tuple[int, int]:
    """The VLM's super-blocks and the self-attention layers in each: every
    ``cross_every``-th layer cross-attends."""
    return cfg.n_layers // cfg.cross_every, cfg.cross_every - 1


def layer(stacked, *idx: int):
    """Layer ``idx`` of a stacked tree (two indices for the hybrid's groups
    and the VLM's super-blocks): views, so an in-place write into a cache
    layer writes into the stack."""
    if isinstance(stacked, torch.Tensor):
        return stacked[idx]
    return {k: layer(v, *idx) for k, v in stacked.items()}


# --------------------------------------------------------------------------
# Blocks (apply)
# --------------------------------------------------------------------------


def _apply_attn(p, x, cfg, *, positions, impl, cache=None, decode_pos=None,
                causal=True):
    """Self-attention: MLA where the config has a latent (``kv_lora``),
    else GQA."""
    if cfg.kv_lora:
        return mla_mod.mla_apply(p, x, cfg, positions=positions, impl=impl,
                                 cache=cache, decode_pos=decode_pos)
    return attn_apply(p, x, cfg, positions=positions, impl=impl, causal=causal,
                      cache=cache, decode_pos=decode_pos)


def _residual(x, h):
    """``x + h``, the sublayer output ``h`` first placed like the residual
    stream (sequence over ``model``; a no-op without a mesh).  Left to
    DTensor, the add reduces ``h``'s partial sums to the stream's layout
    without autograd seeing it, so ``h``'s gradient comes back sharded over
    the sequence, which a matrix product's backward then flattens with the
    batch: torch 2.11 refuses that view (a sharded dimension flattened
    after another).  Placed here, the gradient comes back as ``h`` was."""
    return x + constrain(h, "batch", "seq", None)


def dense_block(p, x, cfg, *, positions, impl, cache=None, decode_pos=None,
                causal=True):
    h, nc = _apply_attn(p["attn"], rms_norm(x, p["ln1"]), cfg,
                        positions=positions, impl=impl, cache=cache,
                        decode_pos=decode_pos, causal=causal)
    x = _residual(x, h)
    x = _residual(x, mlp_apply(p["mlp"], rms_norm(x, p["ln2"])))
    return constrain(x, "batch", "seq", None), nc


def moe_block(p, x, cfg, *, positions, impl, cache=None, decode_pos=None):
    h, nc = _apply_attn(p["attn"], rms_norm(x, p["ln1"]), cfg,
                        positions=positions, impl=impl, cache=cache,
                        decode_pos=decode_pos)
    x = _residual(x, h)
    h, aux = moe_mod.moe_apply(p["moe"], rms_norm(x, p["ln2"]), cfg)
    return constrain(_residual(x, h), "batch", "seq", None), nc, aux


def ssm_block(p, x, cfg, *, state=None):
    """With a ``state`` (views into the decode cache), the new state is
    written into it in place: under a mesh into each rank's local shards,
    which is what ``mamba_apply`` returns there."""
    h, ns = m2.mamba_apply(p["mamba"], rms_norm(x, p["ln1"]), cfg, state=state)
    if state is not None:
        for k in ("h", "conv"):
            dst = state[k]
            (dst.to_local() if isinstance(dst, DTensor) else dst).copy_(ns[k])
    return constrain(_residual(x, h), "batch", "seq", None)


def _cross_kv(p, context):
    """K and V of a cross-attention block, projected from the context
    (under a mesh its whole length on each rank, batch over the batch
    axes: the heads split in the projection)."""
    context = constrain(context, "batch", None, None)
    return proj_heads(context, p["wk"]), proj_heads(context, p["wv"])


def cross_block(p, x, cfg, *, context, impl):
    """The VLM's cross-attention layer over the vision embeddings."""
    h, _ = attn_apply(p["attn"], rms_norm(x, p["ln1"]), cfg, positions=None,
                      impl=impl, causal=False, cross_kv=_cross_kv(p["attn"], context))
    x = _residual(x, h)
    return constrain(_residual(x, mlp_apply(p["mlp"], rms_norm(x, p["ln2"]))),
                     "batch", "seq", None)


def decoder_block(p, x, cfg, *, enc, positions, impl, cache=None,
                  decode_pos=None):
    """Whisper's decoder layer: causal self-attention (roped, cached in
    decode), cross-attention over the encoder output, MLP."""
    h, _ = attn_apply(p["self"], rms_norm(x, p["ln1"]), cfg,
                      positions=positions, impl=impl, cache=cache,
                      decode_pos=decode_pos)
    x = _residual(x, h)
    h, _ = attn_apply(p["cross"], rms_norm(x, p["ln2"]), cfg, positions=None,
                      impl=impl, causal=False, cross_kv=_cross_kv(p["cross"], enc))
    x = _residual(x, h)
    return constrain(_residual(x, mlp_apply(p["mlp"], rms_norm(x, p["ln3"]))),
                     "batch", "seq", None)


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` rematerialised in the backward pass when ``cfg.remat`` is set
    and autograd records (the reference's ``_maybe_remat``): only the
    layer's inputs are kept, and the backward runs it again.  The models
    draw no random numbers, so no RNG state is saved.  The values are
    ``fn``'s; with grad disabled (serving) nothing is wrapped."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn

    def remat(*args, **kwargs):
        return checkpoint(carry_mesh(fn), *args, use_reentrant=False,
                          preserve_rng_state=False, **kwargs)

    return remat


# --------------------------------------------------------------------------
# Forward (prefill and training)
# --------------------------------------------------------------------------


def forward(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            impl: str = "flash") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    x, aux = forward_hidden(params, batch, cfg, impl)
    return constrain(logits_apply(params, x), "batch", None, "vocab"), aux


def forward_hidden(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                   impl: str = "flash") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Backbone forward up to the final norm.  ``batch["tokens"]`` is a
    (B, S) integer tensor on the parameters' device, and for the VLM
    ``batch["vision"]`` (B, vision_tokens, d_model), for audio
    ``batch["frames"]`` (B, frames, d_model); ``aux["aux_loss"]`` is the
    MoE load-balance loss averaged over the layers (0 elsewhere)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    x = embed_apply(params, tokens).to(cfg.torch_dtype)
    x = constrain(x, "batch", "seq", None)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    fam = cfg.family
    dense = _maybe_remat(dense_block, cfg)
    if fam == "dense":
        for i in range(cfg.n_layers):
            x, _ = dense(layer(params["layers"], i), x, cfg,
                         positions=positions, impl=impl)
    elif fam == "moe":
        moe = _maybe_remat(moe_block, cfg)
        for i in range(cfg.n_layers):
            x, _, a = moe(layer(params["layers"], i), x, cfg,
                          positions=positions, impl=impl)
            aux_total = aux_total + a
    elif fam == "ssm":
        ssm = _maybe_remat(ssm_block, cfg)
        for i in range(cfg.n_layers):
            x = ssm(layer(params["layers"], i), x, cfg)
    elif fam == "hybrid":
        ssm = _maybe_remat(ssm_block, cfg)
        g, r = divmod(cfg.n_layers, cfg.attn_every)
        for gi in range(g):
            for li in range(cfg.attn_every):
                x = ssm(layer(params["groups"], gi, li), x, cfg)
            x, _ = dense(params["shared_attn"], x, cfg,
                         positions=positions, impl=impl)
        for i in range(r):
            x = ssm(layer(params["tail"], i), x, cfg)
    elif fam == "vlm":
        cross = _maybe_remat(cross_block, cfg)
        vision = batch["vision"].to(cfg.torch_dtype)
        n_super, n_self = _super_blocks(cfg)
        for si in range(n_super):
            for li in range(n_self):
                x, _ = dense(layer(params["super"]["self"], si, li), x,
                             cfg, positions=positions, impl=impl)
            x = cross(layer(params["super"]["cross"], si), x, cfg,
                      context=vision, impl=impl)
    else:                                                   # audio
        dec = _maybe_remat(decoder_block, cfg)
        enc = _encode_audio(params, batch["frames"].to(cfg.torch_dtype), cfg, impl)
        for i in range(cfg.n_layers):
            x = dec(layer(params["decoder"], i), x, cfg, enc=enc,
                    positions=positions, impl=impl)
    x = rms_norm(x, params["final_norm"])
    return x, {"aux_loss": aux_total / max(cfg.n_layers, 1)}


def _encode_audio(params, frames, cfg: ModelConfig, impl: str):
    """The encoder over precomputed frame embeddings: non-causal dense
    blocks after the learned positions (their ``embed`` dimension
    gathered under a mesh, as a weight's).  Under a mesh the output is
    placed like a batch: its whole length on each rank."""
    x = frames + fsdp(params["enc_pos"])[None, :frames.shape[1]].to(frames.dtype)
    positions = torch.arange(frames.shape[1], dtype=torch.int32,
                             device=frames.device)
    dense = _maybe_remat(dense_block, cfg)
    for i in range(cfg.encoder_layers):
        x, _ = dense(layer(params["encoder"], i), x, cfg,
                     positions=positions, impl=impl, causal=False)
    return constrain(rms_norm(x, params["enc_norm"]), "batch", None, None)


# --------------------------------------------------------------------------
# Decode caches + serve step
# --------------------------------------------------------------------------


def _kv_cache_specs(cfg: ModelConfig, n: int, batch: int, max_len: int):
    if cfg.kv_lora:                      # MLA: the latent and the rope key
        return {"c": p_((n, batch, max_len, cfg.kv_lora),
                        ("layers", "cache_batch", "cache_seq", None), init="zeros"),
                "kr": p_((n, batch, max_len, cfg.rope_dim),
                         ("layers", "cache_batch", "cache_seq", None), init="zeros")}
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
    _check_family(cfg)
    fam = cfg.family
    if fam in ("dense", "moe", "audio"):
        return {"kv": _kv_cache_specs(cfg, cfg.n_layers, batch, max_len)}
    if fam == "ssm":
        return {"ssm": _ssm_state_specs(cfg, (cfg.n_layers,), batch)}
    if fam == "vlm":                     # the self-attention layers only
        n_super, n_self = _super_blocks(cfg)
        return {"kv": _kv_cache_specs(cfg, n_super * n_self, batch, max_len)}
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


def encode_context(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                   impl: str = "flash") -> Optional[torch.Tensor]:
    """The static per-request context ``decode_step`` reads: the audio
    encoder's output (run once a request, not a token), or the vision
    embeddings as they are, in the model dtype; None for the other
    families.  Under a mesh the context comes back placed like a batch
    (batch over the batch axes, the rest whole), a plain input cut to the
    rank's rows."""
    if cfg.family == "audio":
        frames = constrain(batch["frames"], "batch", None, None)
        return _encode_audio(params, frames.to(cfg.torch_dtype), cfg, impl)
    if cfg.family == "vlm":
        return constrain(batch["vision"].to(cfg.torch_dtype), "batch", None, None)
    return None


def decode_step(params, cache, tokens, pos: int, cfg: ModelConfig,
                context: Optional[torch.Tensor] = None):
    """One-token decode.  tokens: (B, 1); pos: the cache fill level;
    context: ``encode_context``'s output for the VLM and audio.  The cache
    is updated in place (the reference returns a new one) and returned with
    the logits.  Attention is plain torch here: no kernel is launched."""
    _check_family(cfg)
    if cfg.family in ("vlm", "audio") and context is None:
        raise ValueError(f"{cfg.name}: decode_step needs the context "
                         "(encode_context's output)")
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
    elif fam == "vlm":
        vision = context.to(cfg.torch_dtype)
        n_super, n_self = _super_blocks(cfg)
        for si in range(n_super):
            for li in range(n_self):
                x, _ = dense_block(layer(params["super"]["self"], si, li), x,
                                   cfg, positions=positions, impl="dense",
                                   cache=layer(cache["kv"], si * n_self + li),
                                   decode_pos=pos)
            x = cross_block(layer(params["super"]["cross"], si), x, cfg,
                            context=vision, impl="dense")
    elif fam == "audio":
        enc = context.to(cfg.torch_dtype)
        for i in range(cfg.n_layers):
            x = decoder_block(layer(params["decoder"], i), x, cfg, enc=enc,
                              positions=positions, impl="dense",
                              cache=layer(cache["kv"], i), decode_pos=pos)
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
    return constrain(logits_apply(params, x), "batch", None, "vocab"), cache

"""Multi-head Latent Attention (DeepSeek-V2) with a compressed KV cache;
counterpart of ``repro/models/mla.py``.

The KV path is compressed to a joint latent ``c`` of width ``kv_lora`` plus
a decoupled rope key ``kr`` of width ``rope_dim`` shared by the heads; the
decode cache holds only those, ``{"c": (B, T, kv_lora), "kr": (B, T,
rope_dim)}``.  Prefill expands the latent into per-head keys of width
``head_dim + rope_dim`` and values of width ``head_dim`` and runs
``attention_core``: with ``impl="flash"`` that is the ``flash_attention``
kernel at D_q = 192, D_v = 128 on deepseek-v2-lite.  Decode uses the
absorption trick: q is projected into the latent space so attention runs
against the compressed cache, and the value up-projection follows the
weighted sum; it is plain torch, as in the reference, and launches no
kernel.  The cache is written in place at ``decode_pos`` (the reference
returns a new one).  Under a mesh prefill runs the kernel on each rank's
local heads, and decode is context-parallel over the cache's length
(``_mla_decode_sharded``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.sharding import (constrain, fsdp,
                                              local_shard_offsets,
                                              mesh_dims_sharding, place,
                                              write_position)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (ParamSpec, attention_core, p_,
                                       proj_heads, rope, split_softmax,
                                       split_weighted_sum)


def mla_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, h, hd, ck, rd = cfg.d_model, cfg.n_heads, cfg.hd, cfg.kv_lora, cfg.rope_dim
    return {
        "wq": p_((d, h, hd + rd), ("embed", "heads", None)),
        "wdkv": p_((d, ck), ("embed", None)),
        "wkrope": p_((d, rd), ("embed", None)),
        "wkup": p_((ck, h, hd), (None, "heads", None)),
        "wvup": p_((ck, h, hd), (None, "heads", None)),
        "wo": p_((h, hd, d), ("heads", None, "embed")),
    }


def mla_apply(p, x, cfg: ModelConfig, *, positions, impl="flash",
              cache: Optional[dict] = None, decode_pos=None):
    """Returns (out, cache); ``cache`` (views into the stacked decode
    cache) is None in prefill.  Under a mesh the input's sequence is
    gathered first (as ``attn_apply``'s), the shared rope key is cut to
    each rank's heads before it joins the expanded keys, so q, k and v
    reach ``attention_core`` (each rank's local heads) split alike; decode
    against a cache whose length is sharded runs ``_mla_decode_sharded``."""
    h, hd, rd = cfg.n_heads, cfg.hd, cfg.rope_dim
    x = constrain(x, "batch", None, None)
    b, s, d = x.shape
    q = proj_heads(x, p["wq"])
    q_nope, q_rope = q[..., :hd], rope(q[..., hd:], positions, cfg.rope_theta)
    c = x @ fsdp(p["wdkv"])                                        # latent
    kr = rope((x @ fsdp(p["wkrope"]))[:, :, None, :], positions,
              cfg.rope_theta)[:, :, 0, :]                          # shared rope key
    wo = fsdp(p["wo"]).reshape(h * hd, d)

    if cache is None:
        # prefill: expand the latent and run standard attention
        kr = constrain(kr[:, :, None, :].expand(b, s, h, rd), "batch", None, "heads", None)
        k = torch.cat([proj_heads(c, p["wkup"]), kr], dim=-1)
        v = proj_heads(c, p["wvup"])
        o = attention_core(torch.cat([q_nope, q_rope], dim=-1), k, v,
                           causal=True, impl=impl, chunk=cfg.attn_chunk)
        return o.reshape(b, s, h * hd) @ wo, None

    # decode with absorption: attend in latent space against the cache
    q_lat = torch.einsum("bshk,chk->bshc", q_nope, fsdp(p["wkup"]))  # absorb W_kup
    if isinstance(cache["c"], DTensor):
        o_lat = _mla_decode_sharded(q_lat, q_rope, c, kr, cache, decode_pos, hd + rd)
    else:
        cache["c"][:, decode_pos:decode_pos + 1] = c.to(cache["c"].dtype)
        cache["kr"][:, decode_pos:decode_pos + 1] = kr.to(cache["kr"].dtype)
        c_cache, kr_cache = cache["c"], cache["kr"]
        s_lat = torch.einsum("bshc,btc->bhst", q_lat, c_cache)
        s_rope = torch.einsum("bshr,btr->bhst", q_rope, kr_cache)
        scores = (s_lat + s_rope).float() / math.sqrt(hd + rd)
        valid = torch.arange(c_cache.shape[1], device=x.device) <= decode_pos
        pr = torch.softmax(scores.masked_fill(~valid, -1e30), dim=-1).to(x.dtype)
        o_lat = torch.einsum("bhst,btc->bshc", pr, c_cache)
    o = torch.einsum("bshc,chk->bshk", o_lat, fsdp(p["wvup"]))      # absorb W_vup
    return o.reshape(b, s, h * hd) @ wo, cache


def _mla_decode_sharded(q_lat, q_rope, c, kr, cache, pos: int, width: int):
    """Absorbed decode against a cache ``{c, kr}`` (B, T, ·) whose length
    is sharded over ``model`` and batch over the batch axes
    (context-parallel): the new latent and rope key are written at ``pos``
    by the rank that holds it; each rank scores every head of its batch
    rows against its part of the length, and the softmax's max and sum
    and the weighted latents are all-reduced over the length's ranks.
    Returns o_lat (B, 1, H, kv_lora) as a DTensor placed like the cache's
    rows, every head on each rank (``W_vup`` then applies on the heads'
    placement)."""
    cc, ckr = cache["c"], cache["kr"]
    mesh = cc.device_mesh
    write_position(cc, c, pos)
    write_position(ckr, kr, pos)
    rows = tuple(pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
                 for pl in cc.placements)
    ql, qr = (place(t, mesh, rows).to_local() for t in (q_lat, q_rope))
    cl, krl = cc.to_local(), ckr.to_local()
    (_, tl, _), (_, t0, _) = local_shard_offsets(cc.shape, cc.placements, mesh)
    scores = (torch.einsum("bshc,btc->bhst", ql, cl)
              + torch.einsum("bshr,btr->bhst", qr, krl)).float() / math.sqrt(width)
    valid = t0 + torch.arange(tl, device=cl.device) <= pos
    length = mesh_dims_sharding(cc, 1)
    pr = split_softmax(scores.masked_fill(~valid, -1e30), mesh, length)
    o_lat = split_weighted_sum("bhst,btc->bshc", pr, cl, mesh, length)
    return DTensor.from_local(o_lat, mesh, rows, run_check=False)

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
returns a new one).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (ParamSpec, attention_core, p_,
                                       proj_heads, rope)


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
    cache) is None in prefill."""
    h, hd, rd = cfg.n_heads, cfg.hd, cfg.rope_dim
    b, s, d = x.shape
    q = proj_heads(x, p["wq"])
    q_nope, q_rope = q[..., :hd], rope(q[..., hd:], positions, cfg.rope_theta)
    c = x @ p["wdkv"]                                              # latent
    kr = rope((x @ p["wkrope"])[:, :, None, :], positions,
              cfg.rope_theta)[:, :, 0, :]                          # shared rope key

    if cache is None:
        # prefill: expand the latent and run standard attention
        k = torch.cat([proj_heads(c, p["wkup"]),
                       kr[:, :, None, :].expand(b, s, h, rd)], dim=-1)
        v = proj_heads(c, p["wvup"])
        o = attention_core(torch.cat([q_nope, q_rope], dim=-1), k, v,
                           causal=True, impl=impl, chunk=cfg.attn_chunk)
        return o.reshape(b, s, h * hd) @ p["wo"].reshape(h * hd, d), None

    # decode with absorption: attend in latent space against the cache
    cache["c"][:, decode_pos:decode_pos + 1] = c.to(cache["c"].dtype)
    cache["kr"][:, decode_pos:decode_pos + 1] = kr.to(cache["kr"].dtype)
    c_cache, kr_cache = cache["c"], cache["kr"]
    q_lat = torch.einsum("bshk,chk->bshc", q_nope, p["wkup"])     # absorb W_kup
    s_lat = torch.einsum("bshc,btc->bhst", q_lat, c_cache)
    s_rope = torch.einsum("bshr,btr->bhst", q_rope, kr_cache)
    scores = (s_lat + s_rope).float() / math.sqrt(hd + rd)
    valid = torch.arange(c_cache.shape[1], device=x.device) <= decode_pos
    pr = torch.softmax(scores.masked_fill(~valid, -1e30), dim=-1).to(x.dtype)
    o_lat = torch.einsum("bhst,btc->bshc", pr, c_cache)
    o = torch.einsum("bshc,chk->bshk", o_lat, p["wvup"])          # absorb W_vup
    return o.reshape(b, s, h * hd) @ p["wo"].reshape(h * hd, d), cache

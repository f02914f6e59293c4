"""Core model layers as pure functions over parameter trees; counterpart of
``repro/models/layers.py``.

Parameters are declared as :class:`ParamSpec` trees (nested dicts) with the
reference's logical axis names, and materialised by :func:`init_params` as
dicts of tensors of the same keys and shapes.  Activations keep the
reference's layouts: ``(B, S, H, hd)`` for attention, weights ``wq``
``(d, h, hd)`` and so on.

Attention offers three implementations:
  * ``dense``   — full softmax (the reference's ``_dense_attention``)
  * ``chunked`` — a loop over query chunks of ``cfg.attn_chunk`` rows, each
                  a dense softmax against every key: O(S·chunk) live scores
                  (the reference's ``_chunked_attention``), each chunk
                  rematerialised under grad
  * ``flash``   — ``kernels/ops.py:flash_attention``, the counterpart of the
                  reference's ``pallas``: the hand-written CUDA kernel on
                  the card, its plain version on the CPU.  The default.

Under a mesh (``distributed/sharding.py``) the tensors are DTensors.  Each
weight is read through ``sharding.fsdp`` (its FSDP dimensions gathered
where it is used); attention and the MLP first gather the sequence of their
input (``constrain(x, "batch", None, None)``: the reference's GSPMD
re-gathers a sequence-sharded residual inside the block, Megatron-SP); the
embedding is a lookup into the vocab-sharded table (DTensor's masked
partial sum; a plain ``w[tokens]`` index would gather the table).  The
attention core runs on each rank's local (batch, heads) shard
(``_local_heads``: every implementation, the flash kernel included, sees
plain tensors), and decode attends over the length-sharded cache with a
softmax whose max and sum are all-reduced over the length's ranks
(``_decode_attention_sharded``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (carry_mesh, constrain, fsdp,
                                              local_shard_offsets,
                                              mesh_dims_sharding, place,
                                              replicated_like, write_position)
from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig

# --------------------------------------------------------------------------
# Parameter specs
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]      # logical axis names (len == ndim)
    init: str = "normal"                 # normal | zeros | ones
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             "in rank")


def p_(shape, axes, init="normal", scale=0.02) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), init, scale)


def map_specs(fn, specs) -> Any:
    """``fn`` applied to every :class:`ParamSpec` of a nested-dict tree, in
    sorted key order (the order ``jax.tree`` walks a dict)."""
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return {k: map_specs(fn, specs[k]) for k in sorted(specs)}


def init_params(specs, generator: Optional[torch.Generator],
                dtype: torch.dtype, device="cuda") -> Any:
    """Tensors for a spec tree: ``normal`` draws N(0, 1) · scale in float32
    from ``generator`` (a ``torch.Generator`` on ``device``; its numbers
    differ from ``jax.random``'s), then casts to ``dtype``, in pieces of at
    most 2²⁸ elements along the first axis, so a stacked leaf (a MoE
    layer's experts: 2.4G elements) needs no float32 copy of itself;
    ``zeros`` and ``ones`` need no generator."""
    device = resolve_device(device)

    def make(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        if generator is None:
            raise ValueError("normal-initialised parameters need a generator")
        out = torch.empty(spec.shape, dtype=dtype, device=device)
        rows = max(1, (1 << 28) // max(1, out[0].numel()))
        for part in out.split(rows):
            part.copy_(torch.randn(part.shape, generator=generator,
                                   dtype=torch.float32, device=device)
                       .mul_(spec.scale))
        return out

    return map_specs(make, specs)


# --------------------------------------------------------------------------
# Normalization / embeddings / rope
# --------------------------------------------------------------------------


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the dtype the reference accumulates in, float32, or in
    float64 where the model runs in float64 (the float64 gradient checks of
    ``chip_smoke.py``); the same values as ``x.float()`` otherwise."""
    return x if x.dtype == torch.float64 else x.float()


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = wide(x)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * fsdp(w).to(x.dtype)).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, n, d) rotary over the last dim; positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32, device=x.device)
                      * (math.log(theta) / half))
    ang = positions[..., None].float() * freqs             # (..., S, half)
    cos = replicated_like(torch.cos(ang)[..., None, :], x)
    sin = replicated_like(torch.sin(ang)[..., None, :], x)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# Attention cores
# --------------------------------------------------------------------------


def _dense_attention(q, k, v, *, causal: bool, window: int,
                     q_offset: int = 0):
    """q: (B,S,H,hd), k: (B,T,Kv,hd), v: (B,T,Kv,hd_v). Returns
    (B,S,H,hd_v): V's own width, which differs from q's for MLA (scores
    scaled by q's width).  Query row i sits at position ``q_offset + i``."""
    b, s, h, hd = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, hd)
    scores = wide(torch.einsum("bskgd,btkd->bkgst", qg, k))
    scores = scores / math.sqrt(hd)
    rows = q_offset + torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= cols <= rows
    if window > 0:
        mask &= cols > rows - window
    p = torch.softmax(scores.masked_fill(~mask, -1e30), dim=-1).to(q.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", p, v)
    return o.reshape(b, s, h, v.shape[-1])


def _chunked_attention(q, k, v, *, causal: bool, window: int,
                       chunk: int = 512):
    """Memory-efficient attention: query chunks of ``chunk`` rows, each a
    dense softmax over all keys at its offset (the last chunk may be
    shorter; the reference pads it instead, with the same rows).  Under
    grad each chunk is rematerialised, as the reference's ``jax.checkpoint``
    body: the backward keeps no chunk's scores past its own recompute.
    Returns V's width, as ``_dense_attention``."""
    s = q.shape[1]
    chunk = min(chunk, s)

    def body(qi, k, v, i):
        return _dense_attention(qi, k, v, causal=causal, window=window,
                                q_offset=i)

    if torch.is_grad_enabled():
        def run(qi, i):
            return checkpoint(carry_mesh(body), qi, k, v, i, use_reentrant=False,
                              preserve_rng_state=False)
    else:
        def run(qi, i):
            return body(qi, k, v, i)
    return torch.cat([run(q[:, i:i + chunk], i) for i in range(0, s, chunk)],
                     dim=1)


def attention_core(q, k, v, *, causal: bool = True, window: int = 0,
                   impl: str = "flash", chunk: int = 512):
    if isinstance(q, DTensor):
        return _local_heads(functools.partial(
            attention_core, causal=causal, window=window, impl=impl,
            chunk=chunk), q, k, v)
    if impl == "dense":
        return _dense_attention(q, k, v, causal=causal, window=window)
    if impl == "chunked":
        return _chunked_attention(q, k, v, causal=causal, window=window,
                                  chunk=chunk)
    if impl == "flash":
        # (B, S, H, hd) -> (B, H, S, hd) as strided views: the kernel reads
        # them in place, and its output comes back laid out like q
        o = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 window=window)
        return o.transpose(1, 2)
    raise ValueError(f"unknown attention impl {impl!r} (the port has "
                     "'dense', 'chunked' and 'flash')")


def _kv_heads_needed(h0: int, hl: int, g: int) -> Tuple[slice, Any]:
    """The key/value heads that local query heads ``h0 .. h0 + hl − 1``
    read (query head ``h`` reads ``h // g``): a slice where they group
    evenly, so the local kernel's own ``j // (hl / n)`` mapping holds; else
    one index a query head (plain multi-head attention locally)."""
    need = [(h0 + j) // g for j in range(hl)]
    n = need[-1] - need[0] + 1
    if hl % n == 0 and need == [need[0] + j // (hl // n) for j in range(hl)]:
        return slice(need[0], need[-1] + 1)
    return need


def _local_heads(fn, q, k, v):
    """``fn`` over each rank's local shard: q (B, S, H, hd) with batch over
    the batch axes and heads over ``model``, k and v (B, T, Kv, hd) alike,
    or kv heads replicated where ``model`` does not divide them (GQA: 8 kv
    heads on a 16-way axis); the sequence whole.  Where the kv heads are
    replicated and the q heads split, each rank is given the kv heads its
    global q heads read, and the gradients of k and v are partial sums over
    the ranks that split the heads.  Returns a DTensor laid out like q."""
    q = constrain(q, "batch", None, "heads", None)
    k = constrain(k, "batch", None, "kv", None)
    v = constrain(v, "batch", None, "kv", None)
    mesh = q.device_mesh
    (_, _, hl, _), (_, _, h0, _) = local_shard_offsets(q.shape, q.placements, mesh)
    q_split, k_split = mesh_dims_sharding(q, 2), mesh_dims_sharding(k, 2)
    grad_pl = tuple(Partial() if i in q_split and i not in k_split else p
                    for i, p in enumerate(k.placements))
    ql = q.to_local()
    kl, vl = k.to_local(grad_placements=grad_pl), v.to_local(grad_placements=grad_pl)
    if not k_split:
        idx = _kv_heads_needed(h0, hl, q.shape[2] // k.shape[2])
        kl, vl = kl[:, :, idx], vl[:, :, idx]
    return DTensor.from_local(fn(ql, kl, vl), mesh, q.placements, run_check=False)


def decode_attention(q, k_cache, v_cache, pos: int, *, window: int = 0):
    """Single-token decode: q (B,1,H,hd); caches (B,T,Kv,hd); ``pos`` is the
    number of valid cache entries.  Softmax masks the cache tail (and the
    sliding window)."""
    b, _, h, hd = q.shape
    t, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, hd)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k_cache).float()
    scores = scores / math.sqrt(hd)
    cols = torch.arange(t, device=q.device)
    mask = cols < pos
    if window > 0:
        mask &= cols > pos - 1 - window
    p = torch.softmax(scores.masked_fill(~mask, -1e30), dim=-1).to(q.dtype)
    o = torch.einsum("bkgt,btkd->bkgd", p, v_cache)
    return o.reshape(b, 1, h, hd)


def _all_reduce(t: torch.Tensor, mesh, dims, op) -> torch.Tensor:
    """``t`` reduced in place over the mesh dimensions ``dims`` (one
    collective each, in mesh order, on every rank alike)."""
    for i in dims:
        dist.all_reduce(t, op=op, group=mesh.get_group(i))
    return t


def split_softmax(scores: torch.Tensor, mesh, dims) -> torch.Tensor:
    """The softmax over the last dimension of ``scores`` whose columns are
    split over the mesh dimensions ``dims`` (a decode cache's length): the
    max and the sum all-reduced over those ranks (decode, no autograd)."""
    m = _all_reduce(scores.amax(dim=-1, keepdim=True), mesh, dims, dist.ReduceOp.MAX)
    p = torch.exp(scores - m)
    return p / _all_reduce(p.sum(dim=-1, keepdim=True), mesh, dims, dist.ReduceOp.SUM)


def split_weighted_sum(eq: str, p: torch.Tensor, values: torch.Tensor, mesh,
                       dims) -> torch.Tensor:
    """``einsum(eq, p, values)`` over a length split like ``split_softmax``'s
    columns, summed in float32 across the length's ranks, in ``values``'
    dtype."""
    o = torch.einsum(eq, p.to(values.dtype), values).float()
    return _all_reduce(o, mesh, dims, dist.ReduceOp.SUM).to(values.dtype)


def _decode_attention_sharded(q, k, v, cache, widx: int, valid: int, *,
                              window: int = 0):
    """Decode against a cache (B, T, Kv, hd) whose length is sharded over
    ``model`` (context-parallel decode; its kv heads instead where
    ``model`` does not divide the length) and batch over the batch axes.
    The new key and value are written at ``widx`` by the rank that holds
    that position, and nowhere else; each rank scores its q heads (those
    of its kv heads) against its part of the length, and the softmax's max
    and sum and the weighted values are all-reduced over the length's
    ranks.  q, k, v: (B, 1, ·, hd) DTensors; returns o (B, 1, H, hd) as a
    DTensor split like the cache's batch and heads."""
    ck, cv = cache["k"], cache["v"]
    mesh = ck.device_mesh
    heads = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
                  for p in ck.placements)
    write_position(ck, k, widx)
    write_position(cv, v, widx)
    ql = place(q, mesh, heads).to_local()
    ckl, cvl = ck.to_local(), cv.to_local()
    (_, tl, _, _), (_, t0, _, _) = local_shard_offsets(ck.shape, ck.placements, mesh)
    b, _, h, hd = ql.shape
    kv = ckl.shape[2]
    scores = torch.einsum("bkgd,btkd->bkgt", ql.reshape(b, kv, h // kv, hd),
                          ckl).float() / math.sqrt(hd)
    cols = t0 + torch.arange(tl, device=ql.device)
    mask = cols < valid
    if window > 0:
        mask &= cols > valid - 1 - window
    length = mesh_dims_sharding(ck, 1)
    p = split_softmax(scores.masked_fill(~mask, -1e30), mesh, length)
    o = split_weighted_sum("bkgt,btkd->bkgd", p, cvl, mesh, length)
    return DTensor.from_local(o.reshape(b, 1, h, hd), mesh, heads,
                              run_check=False)


# --------------------------------------------------------------------------
# Standard GQA attention block (params + apply)
# --------------------------------------------------------------------------


def attn_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    return {
        "wq": p_((d, h, hd), ("embed", "heads", None)),
        "wk": p_((d, kv, hd), ("embed", "kv", None)),
        "wv": p_((d, kv, hd), ("embed", "kv", None)),
        "wo": p_((h, hd, d), ("heads", None, "embed")),
    }


def proj_heads(x, w):
    """einsum("bsd,dhk->bshk") as one matrix product."""
    w = fsdp(w)
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def attn_apply(p, x, cfg: ModelConfig, *, positions, impl="flash",
               causal=True, cross_kv=None, cache=None, decode_pos=None):
    """Returns (out, cache).  ``cache``: dict(k=(B,T,Kv,hd), v=...), views
    into the stacked decode cache, updated in place at ``decode_pos`` (the
    reference's ``dynamic_update_slice`` returns a new cache instead).
    ``cross_kv``: (k, v) projected from a context (cross-attention): q is
    not roped, no cache is read or written, and attention is non-causal
    (decode passes ``impl="dense"``)."""
    x = constrain(x, "batch", None, None)
    q = proj_heads(x, p["wq"])
    if cross_kv is not None:
        k, v = cross_kv
    else:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(proj_heads(x, p["wk"]), positions, cfg.rope_theta)
        v = proj_heads(x, p["wv"])
    if cache is not None and cross_kv is None:
        t = cache["k"].shape[1]
        if cfg.window and t == cfg.window:
            # ring buffer: O(window) cache; keys carry their absolute rope
            # phase, so attention over the ring needs no reordering
            widx = decode_pos % t
            valid = min(decode_pos + 1, t)
            ring_window = 0          # ring already holds only the window
        else:
            widx = decode_pos
            valid = decode_pos + 1
            ring_window = cfg.window
        if isinstance(cache["k"], DTensor):
            o = _decode_attention_sharded(q, k, v, cache, widx, valid,
                                          window=ring_window)
        else:
            cache["k"][:, widx:widx + 1] = k.to(cache["k"].dtype)
            cache["v"][:, widx:widx + 1] = v.to(cache["v"].dtype)
            o = decode_attention(q, cache["k"], cache["v"], valid,
                                 window=ring_window)
    else:
        o = attention_core(q, k, v, causal=causal and cross_kv is None,
                           window=cfg.window, impl=impl, chunk=cfg.attn_chunk)
    wo = fsdp(p["wo"])
    h, hd, d = wo.shape
    out = o.reshape(*o.shape[:2], h * hd) @ wo.reshape(h * hd, d)
    return out, cache


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------


def mlp_specs(d: int, f: int) -> Dict[str, ParamSpec]:
    return {
        "wg": p_((d, f), ("embed", "ffn")),
        "wu": p_((d, f), ("embed", "ffn")),
        "wd": p_((f, d), ("ffn", "embed")),
    }


def mlp_apply(p, x):
    x = constrain(x, "batch", None, None)
    g = torch.nn.functional.silu(x @ fsdp(p["wg"]))
    u = x @ fsdp(p["wu"])
    return (g * u) @ fsdp(p["wd"])


# --------------------------------------------------------------------------
# Embedding / head (tied)
# --------------------------------------------------------------------------


def embed_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    return {"embedding": p_((cfg.vocab, cfg.d_model), ("vocab", "embed")),
            "final_norm": p_((cfg.d_model,), ("embed",), init="ones")}


def embed_apply(p, tokens):
    w = fsdp(p["embedding"])
    if isinstance(w, DTensor):
        # vocab-parallel: a masked partial sum over the vocab's ranks,
        # reduced here, where DTensor still holds its mask
        tokens = constrain(tokens, "batch", None)
        return constrain(torch.nn.functional.embedding(tokens, w),
                         "batch", None, None)
    return w[tokens]


def logits_apply(p, x):
    return x @ fsdp(p["embedding"]).t()

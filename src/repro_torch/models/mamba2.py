"""Mamba-2 SSD (state-space duality) blocks — arXiv:2405.21060; counterpart
of ``repro/models/mamba2.py``.

Prefill uses the chunked SSD algorithm: within a chunk the recurrence is
unrolled into masked matrix products (the quadratic-in-chunk dual form);
across chunks a small state carries ``(heads, state, head_dim)`` in float32
— the reference's ``lax.scan`` is a loop over chunks here.  Decode carries
O(1) state per layer: ``h ← a·h + dt·B⊗x``, ``y = C·h``; no KV cache.

All of it is plain torch, as in the reference (no Pallas kernel there).
Under a mesh the conv, the SSD and the recurrence run on each rank's local
heads (``_ssm_local_heads``), the projections and the gated norm on
DTensors.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (constrain, fsdp, local_operand,
                                              local_shard_offsets,
                                              mesh_dims_sharding, place)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec, p_, rms_norm, wide


def mamba_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    din = cfg.expand * d
    nh, n = cfg.ssm_heads, cfg.ssm_state
    return {
        "wx": p_((d, din), ("embed", "ssm_in")),
        "wz": p_((d, din), ("embed", "ssm_in")),
        "wB": p_((d, n), ("embed", None)),
        "wC": p_((d, n), ("embed", None)),
        "wdt": p_((d, nh), ("embed", "heads")),
        "dt_bias": p_((nh,), ("heads",), init="zeros"),
        "A_log": p_((nh,), ("heads",), init="zeros"),
        "D": p_((nh,), ("heads",), init="ones"),
        "conv_w": p_((4, din + 2 * n), (None, None), scale=0.1),
        "norm": p_((din,), ("ssm_in",), init="ones"),
        "wo": p_((din, d), ("ssm_in", "embed")),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, kernel (K, C); u: (B, S, C).
    Returns (out, new_state) where state is the last K-1 inputs."""
    k = w.shape[0]
    if state is None:
        up = F.pad(u, (0, 0, k - 1, 0))
    else:
        up = torch.cat([state.to(u.dtype), u], dim=1)
    s = u.shape[1]
    out = sum(up[:, i:i + s, :] * w[i] for i in range(k))
    new_state = up[:, -(k - 1):, :] if k > 1 else None
    return F.silu(out), new_state


def ssd_chunked(x, dt, A, B_, C_, chunk: int, compute_dtype=torch.float32):
    """SSD forward.
    x: (B,S,H,P)  dt: (B,S,H)  A: (H,) negative  B_,C_: (B,S,N), float32.
    Returns y: (B,S,H,P) in ``x``'s dtype (float32; float64 in a float64
    model).  ``compute_dtype`` is the dtype of the dual form's decay and
    score matrices (bf16 halves their traffic; the cumsum and the
    inter-chunk state stay in ``x``'s dtype)."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"SSD chunk {chunk}")
    nc = s // chunk
    cd = compute_dtype
    xq = x.reshape(b, nc, chunk, h, p)
    dtq = dt.reshape(b, nc, chunk, h)
    Bq = B_.reshape(b, nc, chunk, n)
    Cq = C_.reshape(b, nc, chunk, n)

    cum = torch.cumsum(dtq * A, dim=2)                 # (b,nc,Q,h), log decay

    # intra-chunk (quadratic-in-chunk dual form):
    # L[i,j] = exp(cum_i - cum_j) for j <= i
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    # the mask goes on the exponent: exp of an unmasked (j > i) difference
    # can overflow to inf, and where()'s backward would then give 0·inf
    L = torch.exp(torch.where(causal, cum[:, :, :, None, :] - cum[:, :, None, :, :],
                              -torch.inf)).to(cd)      # (b,nc,Q,Q,h)
    sc = torch.einsum("bcin,bcjn->bcij", Cq.to(cd), Bq.to(cd))
    w = sc[..., None] * L * dtq[:, :, None, :, :].to(cd)
    del L
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xq.to(cd)).to(x.dtype)
    del w

    # chunk state: S_c = Σ_j exp(cum_end - cum_j)·dt_j·B_j ⊗ x_j
    decay_tail = torch.exp(cum[:, :, -1:, :] - cum)    # (b,nc,Q,h)
    S_c = torch.einsum("bcqn,bcqhp->bchnp", Bq,
                       xq * (dtq * decay_tail)[..., None])
    chunk_decay = torch.exp(cum[:, :, -1, :])          # (b,nc,h)

    # inter-chunk state carry, float32: the state before each chunk
    hcur = torch.zeros((b, h, n, p), dtype=x.dtype, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hcur)
        hcur = hcur * chunk_decay[:, c, :, None, None] + S_c[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)              # (b,nc,h,n,p)

    y_inter = torch.einsum("bcin,bchnp->bcihp", Cq, h_prevs) \
        * torch.exp(cum)[..., None]
    return (y_intra + y_inter).reshape(b, s, h, p)


def _ssm(u, dt, A, D, cfg: ModelConfig, h: Optional[torch.Tensor] = None):
    """The SSD (prefill) or the one-token recurrence (``h`` given) over the
    conv output ``u`` (B, S, dl + 2n): its first ``dl`` columns are the
    heads' inputs, then B and C.  Returns y (B, S, dl) in the accumulation
    dtype, the D skip added, and the new state (None in prefill)."""
    b, s, c = u.shape
    n, hp = cfg.ssm_state, cfg.ssm_head_dim
    dl = c - 2 * n
    xz, Bc, Cc = u[..., :dl], u[..., dl:dl + n], u[..., dl + n:]
    xh = xz.reshape(b, s, dl // hp, hp)
    if h is None:
        xw = wide(xh)
        y = ssd_chunked(xw, wide(dt), A, wide(Bc), wide(Cc), cfg.ssm_chunk,
                        compute_dtype=torch.bfloat16 if cfg.ssd_bf16 else xw.dtype)
        new_h = None
    else:
        # single-token recurrence: h <- a·h + dt·B⊗x ; y = C·h
        a = torch.exp(dt[:, 0] * A)                               # (b,h)
        hprev = h.float()                                         # (b,h,n,p)
        upd = dt[:, 0][:, :, None, None] * \
            Bc[:, 0].float()[:, None, :, None] * \
            xh[:, 0].float()[:, :, None, :]
        new_h32 = hprev * a[:, :, None, None] + upd
        y = torch.einsum("bn,bhnp->bhp", Cc[:, 0].float(), new_h32)[:, None]
        new_h = new_h32.to(h.dtype)
    y = y + wide(xh) * wide(D)[:, None]
    return y.reshape(b, s, dl), new_h


def _ssm_local_heads(xz, Bc, Cc, dt, A, p, cfg: ModelConfig, state):
    """``_causal_conv`` and ``_ssm`` on each rank's local shard under a
    mesh: batch over the batch axes, ``din`` and the heads over ``model``
    (the same split: ``din`` is the heads times ``ssm_head_dim``), the
    sequence whole, B and C replicated.  The conv reads the rank's columns
    of ``conv_w`` and the whole B/C part; in decode the new token's whole
    ``din`` is gathered, so the conv state, replicated over ``model``,
    stays alike on its ranks.  Returns y as a DTensor placed like ``xz``
    and the new state as local tensors."""
    mesh = xz.device_mesh
    out = tuple(xz.placements)
    if mesh_dims_sharding(dt, 2) != mesh_dims_sharding(xz, 2):
        raise ValueError(f"{cfg.name}: din {xz.shape[2]} and {dt.shape[2]} heads "
                         f"are split differently over the mesh {mesh.shape}")
    din = xz.shape[2]
    (_, _, dl), (_, _, d0) = local_shard_offsets(xz.shape, out, mesh)
    Bl, Cl = local_operand(Bc, out), local_operand(Cc, out)
    w = local_operand(p["conv_w"], out)
    if state is None:
        u, _ = _causal_conv(torch.cat([xz.to_local(), Bl, Cl], dim=-1),
                            torch.cat([w[:, d0:d0 + dl], w[:, din:]], dim=1))
        new_conv = None
    else:
        rows = tuple(pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
                     for pl in out)
        whole = place(xz, mesh, rows).to_local()
        u, new_conv = _causal_conv(torch.cat([whole, Bl, Cl], dim=-1), w,
                                   state["conv"].to_local())
        u = torch.cat([u[..., d0:d0 + dl], u[..., din:]], dim=-1)
    y, new_h = _ssm(u, dt.to_local(), local_operand(A, out),
                    local_operand(p["D"], out), cfg,
                    None if state is None else state["h"].to_local())
    y = DTensor.from_local(y, mesh, out, run_check=False)
    return y, None if state is None else {"h": new_h, "conv": new_conv}


def mamba_apply(p, x: torch.Tensor, cfg: ModelConfig, *,
                state: Optional[dict] = None):
    """Returns (out, new_state).  state = {"h": (B,H,N,P), "conv": (B,3,C)};
    with a state, ``x`` is one token (B, 1, d) and the recurrence runs.
    Under a mesh the input's sequence is gathered first (as attention's
    is), the conv and the SSD run on each rank's local heads
    (``_ssm_local_heads``) and the new state comes back as local tensors;
    the gated norm's sum of squares over ``din``, split over ``model``, is
    DTensor's reduction over the shards."""
    b, s, d = x.shape
    din = cfg.expand * d
    x = constrain(x, "batch", None, None)
    xz = x @ fsdp(p["wx"])
    z = x @ fsdp(p["wz"])
    Bc = x @ fsdp(p["wB"])
    Cc = x @ fsdp(p["wC"])
    dt = F.softplus(x @ fsdp(p["wdt"]) + p["dt_bias"])
    A = -torch.exp(wide(p["A_log"]))

    if isinstance(xz, DTensor):
        y, new_state = _ssm_local_heads(xz, Bc, Cc, dt, A, p, cfg, state)
    else:
        u, new_conv = _causal_conv(torch.cat([xz, Bc, Cc], dim=-1), p["conv_w"],
                                   None if state is None else state["conv"])
        y, new_h = _ssm(u, dt, A, p["D"], cfg, None if state is None else state["h"])
        new_state = None if state is None else {"h": new_h, "conv": new_conv}
    y = rms_norm(y.to(x.dtype) * F.silu(z), p["norm"])
    out = (y.reshape(b * s, din) @ fsdp(p["wo"])).reshape(b, s, d)
    return out, new_state


def init_mamba_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device="cuda"):
    """A zero decode state on ``device`` (the card unless the caller asks
    for the CPU): ``h`` in float32, ``conv`` in ``dtype``."""
    device = resolve_device(device)
    nh, n, hp = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    din = cfg.expand * cfg.d_model
    return {"h": torch.zeros((batch, nh, n, hp), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, 3, din + 2 * n), dtype=dtype, device=device)}

"""Lowering primitives over the group-program IR, in torch; counterpart of
``repro/core/lowering/common.py``.

Payload construction — gathers of incoming views, term evaluation in the
product's axis frame, marginalization of extra axes, validity masking — is
what every backend shares; only the reduction differs.  ``B`` is the rows
of one block.

Param-batch (node) axis: batched products and views carry an extra
*leading* node axis of size ``N`` before the row axis, so tensors are
``(N, B, *frame)``.  Non-batched factors stay ``(B, *frame)`` and broadcast
against batched ones from the right; the static ``batched`` flags of the IR
decide where the axis exists.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.core.aggregates import Params
from repro_torch.core.ir import (ColProgram, GatherSpec, ProductProgram,
                                 SegmentSpec, ViewProgram)

Cols = Mapping[str, torch.Tensor]

#: synthetic column carrying per-row signed multiplicities through the
#: blocked scan (maintained views' delta weights are blocked like the
#: relation's own columns)
ROW_WEIGHT = "__row_weight__"


def block_columns(rel_cols: Cols, block_size: int,
                  weights: Optional[torch.Tensor] = None):
    """Reshape relation columns (and optional ``(n,)`` row weights, under
    :data:`ROW_WEIGHT`) into scan blocks: returns ``(cols_blocked,
    n_blocks, B, n_pad)`` where every column becomes ``(n_blocks, B)``,
    the last block padded with zeros."""
    n_pad = int(next(iter(rel_cols.values())).shape[0])
    B = min(block_size, max(n_pad, 1))
    n_blocks = max(-(-n_pad // B), 1)
    pad = n_blocks * B - n_pad
    cols = dict(rel_cols)
    if weights is not None:
        cols[ROW_WEIGHT] = weights.to(torch.float32)
    cols_blocked = {}
    for a, c in cols.items():
        if pad:
            c = torch.cat([c, c.new_zeros(pad)])
        cols_blocked[a] = c.reshape(n_blocks, B)
    return cols_blocked, n_blocks, B, n_pad


def block_validity(blk_i: int, B: int, n_pad: int, n_valid, offset,
                   device: torch.device,
                   weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B,) float mask of the block's rows inside both the local (possibly
    padded) partition of ``n_pad`` rows and the global window ``[offset,
    offset + n_valid)`` — zero on the padded rows past either, whose codes
    are 0 and would otherwise land in segment 0 — times the block's signed
    row ``weight`` if given.  ``n_valid`` is a host int or a 0-d device
    tensor (a shard's own row count, which only the device knows after a
    delete), so the mask is built without a sync either way."""
    row_idx = blk_i * B + torch.arange(B, device=device)
    limit = n_valid - offset
    if isinstance(limit, torch.Tensor):
        limit = limit.clamp(max=n_pad)
    else:
        limit = min(n_pad, limit)
    valid = (row_idx < limit).to(torch.float32)
    return valid if weight is None else valid * weight


def align(x: torch.Tensor, src_axes: Tuple[str, ...],
          dst_axes: Tuple[str, ...], lead: int = 1) -> torch.Tensor:
    """Map (*lead, *src_dims) onto (*lead, *dst positions) with singleton axes
    elsewhere.  All src axes must appear in dst; ``lead`` counts the leading
    non-frame axes kept in place (row axis, or node and row axes)."""
    present = [a for a in dst_axes if a in src_axes]
    if tuple(present) != tuple(src_axes):
        perm = list(range(lead)) + [lead + src_axes.index(a) for a in present]
        x = x.permute(perm)
    shape = list(x.shape[:lead]) + [
        x.shape[lead + present.index(a)] if a in present else 1
        for a in dst_axes]
    return x.reshape(shape)


def reshape_axes(col: torch.Tensor, dst_axes: Tuple[str, ...]) -> torch.Tensor:
    """Row vector -> (B, 1, ..., 1) in the destination axis frame."""
    return col.reshape((col.shape[0],) + (1,) * len(dst_axes))


def segment_ids(cols: Cols, seg: SegmentSpec) -> torch.Tensor:
    """Mixed-radix flattening of the local group-by columns."""
    out = torch.zeros_like(cols[seg.attrs[0]])
    for a, d in zip(seg.attrs, seg.dims):
        out = out * d + cols[a]
    return out


def gather_children(gathers: Tuple[GatherSpec, ...], cols: Cols,
                    arrays: Mapping[int, torch.Tensor],
                    n_rows: int) -> Dict[int, torch.Tensor]:
    """Per child view: the (B, *rest_dims) slice each row sees — the paper's
    'lookup into incoming views', shared by all aggregates of the step.
    Batched children ((N, ...) tensors) gather past their node axis, giving
    (N, B, *rest_dims) slices.  Broadcasts are ``expand`` views: never
    written in place."""
    out: Dict[int, torch.Tensor] = {}
    for gs in gathers:
        arr = arrays[gs.vid]
        idx = tuple(cols[a].long() for a in gs.gather)
        if gs.batched:
            if idx:
                out[gs.vid] = arr[(slice(None),) + idx]
            else:
                out[gs.vid] = arr[:, None].expand(
                    (arr.shape[0], n_rows) + tuple(arr.shape[1:]))
        elif idx:
            out[gs.vid] = arr[idx]
        else:
            out[gs.vid] = arr.expand((n_rows,) + tuple(arr.shape))
    return out


def product_payload(pp: ProductProgram, cols: Cols,
                    gathered: Mapping[int, torch.Tensor], params: Params,
                    n_rows: int, device: torch.device) -> torch.Tensor:
    """(B, *kept_axis_dims) contribution of one product, extra axes summed;
    (N, B, *kept) when the product is batched."""
    n_frame = len(pp.axes)
    acc = None
    for ref in pp.child_refs:
        x = gathered[ref.vid][..., ref.col]        # (N?, B, *rest_dims)
        x = align(x, ref.rest, pp.axes, lead=2 if ref.batched else 1)
        acc = x if acc is None else acc * x
    for ta in pp.local_terms:
        env = {}
        for a in ta.col_attrs:
            env[a] = reshape_axes(cols[a], pp.axes)
        for a, d in zip(ta.dom_attrs, ta.dom_dims):
            dom = torch.arange(d, dtype=torch.int32, device=device)
            env[a] = align(dom[None, :], (a,), pp.axes)
        x = ta.term.evaluate(env, params).to(torch.float32)
        if ta.batched:
            if x.dim() == 1:       # (N,) per-node scalar -> (N, 1, ..., 1)
                x = x.reshape(x.shape + (1,) * (1 + n_frame))
        elif x.dim() == 0 and x.device.type == "cpu":
            # a host scalar (constant, scalar param): no copy to the device
            x = torch.full((n_rows,) + (1,) * n_frame, float(x),
                           device=device)
        elif x.dim() == 0:
            x = x.expand((n_rows,) + (1,) * n_frame)
        acc = x if acc is None else acc * x
    if acc is None:  # pure count: Π over empty set = 1
        acc = torch.ones((n_rows,) + (1,) * n_frame, dtype=torch.float32,
                         device=device)
    lead = acc.dim() - n_frame  # 1, or 2 when the node axis is present
    if n_frame > pp.n_keep:  # marginalize the non-output axes
        acc = acc.expand(acc.shape[:lead - 1] + (n_rows,) + pp.axis_dims)
        acc = acc.sum(dim=tuple(range(lead + pp.n_keep, lead + n_frame)))
    return acc


def col_payload(cp: ColProgram, cols: Cols,
                gathered: Mapping[int, torch.Tensor], params: Params,
                n_rows: int, device: torch.device) -> torch.Tensor:
    out = None
    for pp in cp.products:
        p = product_payload(pp, cols, gathered, params, n_rows, device)
        out = p if out is None else out + p
    return out


def view_columns(vp: ViewProgram, cols: Cols,
                 gathered: Mapping[int, torch.Tensor], params: Params,
                 valid: torch.Tensor, n_rows: int,
                 n_nodes: Optional[int] = None):
    """``(columns, shape)``: per aggregate of view vp, its (B,
    *pulled_dims) contributions of a row block — (N, B, *pulled_dims) for
    batched views, the ``shape`` — as an ``expand`` view where it
    broadcasts (never written in place), or ``None`` for a column with no
    products (zeros)."""
    target = (n_rows,) + vp.pulled_dims
    if vp.batched:
        if n_nodes is None:
            raise ValueError(f"view {vp.vid} is batched but n_nodes is unset")
        target = (n_nodes,) + target
    out = []
    for cp in vp.cols:
        if cp.products:
            c = (col_payload(cp, cols, gathered, params, n_rows, valid.device)
                 * reshape_axes(valid, vp.pulled))
            out.append(c.expand(target))
        else:
            out.append(None)
    return out, target


def view_payload(vp: ViewProgram, cols: Cols,
                 gathered: Mapping[int, torch.Tensor], params: Params,
                 valid: torch.Tensor, n_rows: int,
                 n_nodes: Optional[int] = None) -> torch.Tensor:
    """(B, *pulled_dims, n_aggs) contributions of a row block to view vp —
    (N, B, *pulled_dims, n_aggs) for batched views.  Columns with no
    products contribute zeros."""
    out_cols, target = view_columns(vp, cols, gathered, params, valid,
                                    n_rows, n_nodes)
    return torch.stack([valid.new_zeros(target) if c is None else c
                        for c in out_cols], dim=-1)


def finalize(vp: ViewProgram, acc: torch.Tensor) -> torch.Tensor:
    """Unflatten the segment axis and transpose to canonical group-by order;
    a leading node axis (batched views) stays in place."""
    lead = acc.dim() - len(vp.acc_shape)
    arr = acc.reshape(acc.shape[:lead] + vp.out_dims + (vp.n_aggs,))
    return arr.permute(tuple(range(lead))
                       + tuple(lead + p for p in vp.out_perm))

"""Lowering primitives over the group-program IR, in torch; counterpart of
``repro/core/lowering/common.py`` (batch subset: no row weights, offsets or
param-batch axis).

Payload construction — gathers of incoming views, term evaluation in the
product's axis frame, marginalization of extra axes, validity masking — is
what every backend shares; only the reduction differs.  ``B`` is the rows
of one block.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from repro_torch.core.aggregates import Params
from repro_torch.core.ir import (ColProgram, GatherSpec, ProductProgram,
                                 SegmentSpec, ViewProgram)

Cols = Mapping[str, torch.Tensor]


def block_columns(rel_cols: Cols, block_size: int):
    """Reshape relation columns into scan blocks: returns
    ``(cols_blocked, n_blocks, B, n_pad)`` where every column becomes
    ``(n_blocks, B)``, the last block padded with zeros."""
    n_pad = int(next(iter(rel_cols.values())).shape[0])
    B = min(block_size, max(n_pad, 1))
    n_blocks = max(-(-n_pad // B), 1)
    pad = n_blocks * B - n_pad
    cols_blocked = {}
    for a, c in rel_cols.items():
        if pad:
            c = torch.cat([c, c.new_zeros(pad)])
        cols_blocked[a] = c.reshape(n_blocks, B)
    return cols_blocked, n_blocks, B, n_pad


def block_validity(blk_i: int, B: int, n_valid: int,
                   device: torch.device) -> torch.Tensor:
    """(B,) float mask of the block's rows below ``n_valid`` — zero on the
    padded rows of the last block, whose codes are 0 and would otherwise
    land in segment 0."""
    row_idx = blk_i * B + torch.arange(B, device=device)
    return (row_idx < n_valid).to(torch.float32)


def align(x: torch.Tensor, src_axes: Tuple[str, ...],
          dst_axes: Tuple[str, ...], lead: int = 1) -> torch.Tensor:
    """Map (*lead, *src_dims) onto (*lead, *dst positions) with singleton axes
    elsewhere.  All src axes must appear in dst."""
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
    Broadcasts are ``expand`` views: never written in place."""
    out: Dict[int, torch.Tensor] = {}
    for gs in gathers:
        arr = arrays[gs.vid]
        if gs.gather:
            out[gs.vid] = arr[tuple(cols[a].long() for a in gs.gather)]
        else:
            out[gs.vid] = arr.expand((n_rows,) + tuple(arr.shape))
    return out


def product_payload(pp: ProductProgram, cols: Cols,
                    gathered: Mapping[int, torch.Tensor], params: Params,
                    n_rows: int, device: torch.device) -> torch.Tensor:
    """(B, *kept_axis_dims) contribution of one product, extra axes summed."""
    n_frame = len(pp.axes)
    acc = None
    for ref in pp.child_refs:
        x = gathered[ref.vid][..., ref.col]        # (B, *rest_dims)
        x = align(x, ref.rest, pp.axes)
        acc = x if acc is None else acc * x
    for ta in pp.local_terms:
        env = {}
        for a in ta.col_attrs:
            env[a] = reshape_axes(cols[a], pp.axes)
        for a, d in zip(ta.dom_attrs, ta.dom_dims):
            dom = torch.arange(d, dtype=torch.int32, device=device)
            env[a] = align(dom[None, :], (a,), pp.axes)
        x = ta.term.evaluate(env, params).to(torch.float32)
        if x.dim() == 0 and x.device.type == "cpu":
            # a host scalar (constant, scalar param): no copy to the device
            x = torch.full((n_rows,) + (1,) * n_frame, float(x),
                           device=device)
        elif x.dim() == 0:
            x = x.expand((n_rows,) + (1,) * n_frame)
        acc = x if acc is None else acc * x
    if acc is None:  # pure count: Π over empty set = 1
        acc = torch.ones((n_rows,) + (1,) * n_frame, dtype=torch.float32,
                         device=device)
    if n_frame > pp.n_keep:  # marginalize the non-output axes
        acc = acc.expand((n_rows,) + pp.axis_dims)
        acc = acc.sum(dim=tuple(range(1 + pp.n_keep, 1 + n_frame)))
    return acc


def col_payload(cp: ColProgram, cols: Cols,
                gathered: Mapping[int, torch.Tensor], params: Params,
                n_rows: int, device: torch.device) -> torch.Tensor:
    out = None
    for pp in cp.products:
        p = product_payload(pp, cols, gathered, params, n_rows, device)
        out = p if out is None else out + p
    return out


def view_payload(vp: ViewProgram, cols: Cols,
                 gathered: Mapping[int, torch.Tensor], params: Params,
                 valid: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(B, *pulled_dims, n_aggs) contributions of a row block to view vp.
    Columns with no products contribute zeros."""
    target = (n_rows,) + vp.pulled_dims
    out_cols = []
    for cp in vp.cols:
        if cp.products:
            c = (col_payload(cp, cols, gathered, params, n_rows, valid.device)
                 * reshape_axes(valid, vp.pulled))
        else:
            c = valid.new_zeros(target)
        out_cols.append(c.expand(target))
    return torch.stack(out_cols, dim=-1)


def finalize(vp: ViewProgram, acc: torch.Tensor) -> torch.Tensor:
    """Unflatten the segment axis and transpose to canonical group-by order."""
    arr = acc.reshape(vp.out_dims + (vp.n_aggs,))
    return arr.permute(vp.out_perm)

"""CUDA lowering backend: segment reductions on the hand-written kernels;
counterpart of ``repro/core/lowering/pallas.py``.

Rows stream through a Python loop over ``PlanConfig.block_size`` blocks (the
reference's ``lax.scan``): each block gathers incoming views once, builds the
payloads of every view of the step with torch, and reduces them on the card.

Launch fusion (``PlanConfig.fuse_kernels``, default): the union of a step's
reductions — every local group-by bucket and every histogram-pattern view —
goes to ONE ``fused_scan_block`` launch per row block, in the reference's
order (buckets, then hist views), each reduction's codes and payload read
where they lie (``ops.fused_scan_parts``): a bucket's parts are its views'
aggregate columns (a batched view's, node by node), a hist view's its cond mask (the (N, B) node masks read
transposed) and its y column, ``[1, y, y²]`` formed in the kernel.  Nothing
is stacked or concatenated for the launch.  :func:`fused_layout` gives the
reference's packing of the same launch, which the kernel also takes.  The
unfused path launches one ``seg_aggregate`` per bucket (its views'
payloads concatenated) and one ``tree_hist`` per hist view
(``tree_hist_batched`` for a batched one).  On CPU tensors the kernel
wrappers run their plain versions, which keeps this backend testable
everywhere.

Param-batch (node) axis: batched views fold the ``N`` nodes into the
kernels' column axis — bucket columns are ``[node, pulled…, agg]`` and
batched hist columns ``[node, stat]`` — so one launch still serves the
whole frontier.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.core.aggregates import Params
from repro_torch.core.ir import StepProgram, ViewProgram
from repro_torch.core.lowering import common
from repro_torch.kernels import ops


def step_split(prog: StepProgram):
    """Static split of a step's views: hist-pattern views, then general
    views bucketed by their local segment key (views sharing a key reduce in
    one scatter pass)."""
    hist_views = [vp for vp in prog.views if vp.hist is not None]
    bucket_map: Dict[Tuple[str, ...], List[ViewProgram]] = {}
    for vp in prog.views:
        if vp.hist is None:
            key = vp.seg.attrs if vp.seg is not None else ()
            bucket_map.setdefault(key, []).append(vp)
    return hist_views, sorted(bucket_map.items())


def flat_width(vp: ViewProgram, n_nodes: Optional[int] = None) -> int:
    """Kernel columns of a bucket view: batched views fold the node axis
    into the aggregate columns."""
    w = vp.n_aggs * (n_nodes if vp.batched else 1)
    for d in vp.pulled_dims:
        w *= d
    return w


def fused_layout(prog: StepProgram, n_nodes: Optional[int] = None):
    """The static packing of a step's fused launch: ``(specs, yk_offs)``
    with bucket specs first, then one hist spec per hist view (``n_cond =
    N`` when batched), and the payload offset of the ``[1, y, y²]`` triple
    of each y attribute."""
    hist_views, buckets = step_split(prog)
    specs: List[ops.ReduceSpec] = []
    c, off = 0, 0
    for key, vps in buckets:
        w = sum(flat_width(vp, n_nodes) for vp in vps)
        n_seg = vps[0].seg.n_segments if key else 1
        specs.append(ops.ReduceSpec("seg", c, n_seg, w, off))
        c += 1
        off += w
    cond_slots = []
    for vp in hist_views:
        nc = n_nodes if vp.batched else 1
        cond_slots.append((c, off, nc))
        c += 1
        off += nc
    yk_offs: Dict[str, int] = {}
    for vp in hist_views:
        if vp.hist.y_attr not in yk_offs:
            yk_offs[vp.hist.y_attr] = off
            off += 3
    for (ci, po, nc), vp in zip(cond_slots, hist_views):
        specs.append(ops.ReduceSpec("hist", ci, vp.hist.n_buckets, nc * 3, po,
                                    n_cond=nc, yk_off=yk_offs[vp.hist.y_attr]))
    return tuple(specs), yk_offs


class CudaBackend:
    """Lowers one scan step to blocked kernel launches."""

    name = "cuda"

    @staticmethod
    def count_launches(prog: StepProgram, config) -> int:
        """Kernel-launch sites this step dispatches per row block: 1 fused,
        or one per bucket plus one per hist view unfused."""
        hist_views, buckets = step_split(prog)
        if config.fuse_kernels:
            return 1 if (hist_views or buckets) else 0
        return len(hist_views) + len(buckets)

    def run_step(self, prog: StepProgram, rel_cols: Mapping[str, torch.Tensor],
                 arrays: Dict[int, torch.Tensor], params: Params, *,
                 n_valid, config, n_nodes: Optional[int] = None,
                 weights: Optional[torch.Tensor] = None,
                 offset: int = 0) -> None:
        """``weights`` (optional, (n_rows,) float) multiply each row's
        contribution — signed multiplicities of a maintained view's delta
        scan (+1 insert, -1 delete, 0 padding).  They fold into the
        validity before any payload or cond is formed, so every kernel
        sees the same contract as on an unweighted scan.  Rows count where
        they lie in the global window ``[offset, offset + n_valid)``, as on
        the ``torch`` backend: a rank's shard only narrows the kernels'
        valid rows, the kernels themselves are unchanged."""
        cols_blocked, n_blocks, B, n_pad = common.block_columns(
            rel_cols, config.block_size, weights)
        w_blocked = cols_blocked.pop(common.ROW_WEIGHT, None)
        device = next(iter(rel_cols.values())).device
        hist_views, buckets = step_split(prog)

        def blocks():
            """Per row block: (columns, gathered child slices, validity)."""
            for blk_i in range(n_blocks):
                blk_cols = {a: c[blk_i] for a, c in cols_blocked.items()}
                valid = common.block_validity(
                    blk_i, B, n_pad, n_valid, offset, device,
                    None if w_blocked is None else w_blocked[blk_i])
                gathered = common.gather_children(prog.gathers, blk_cols,
                                                  arrays, B)
                yield blk_cols, gathered, valid

        def flat_payload(vp, blk_cols, gathered, valid):
            p = common.view_payload(vp, blk_cols, gathered, params, valid, B,
                                    n_nodes)
            if vp.batched:   # (N, B, *pulled, n_aggs) -> (B, N·pulled·n_aggs)
                p = p.movedim(0, 1)
            return p.reshape(B, -1)

        def bucket_payload(vps, blk_cols, gathered, valid):
            return torch.cat([flat_payload(vp, blk_cols, gathered, valid)
                              for vp in vps], dim=1)

        def hist_cond(vp, blk_cols, gathered, valid):
            """(B, 1) mask, or (B, N) node masks of a batched hist view."""
            cond = common.col_payload(vp.hist.cond, blk_cols, gathered,
                                      params, B, device) * valid
            return cond.t() if vp.batched else cond[:, None]

        def bucket_codes(key, vps, blk_cols):
            if key:
                return common.segment_ids(blk_cols, vps[0].seg).to(torch.int32)
            return torch.zeros((B,), dtype=torch.int32, device=device)

        def bucket_parts(vps, blk_cols, gathered, valid):
            """A bucket's payload as it lies, and its width: one part per
            aggregate column of a view (per node of a batched one), its
            pulled values at a stride of the view's aggregates.  A column
            with no products is no part."""
            parts, o = [], 0
            for vp in vps:
                cols, _ = common.view_columns(vp, blk_cols, gathered, params,
                                              valid, B, n_nodes)
                pulled = math.prod(vp.pulled_dims)
                for a, c in enumerate(cols):
                    if c is None:
                        continue
                    for node, col in enumerate(c if vp.batched else [c]):
                        parts.append(ops.Part(
                            col if col.dim() <= 2 else col.reshape(B, -1),
                            o + node * pulled * vp.n_aggs + a, vp.n_aggs))
                o += flat_width(vp, n_nodes)
            if not parts:   # every column zero: one expanded zero column
                parts.append(ops.Part(valid.new_zeros(1).expand(B), 0))
            return tuple(parts), o

        if config.fuse_kernels and (hist_views or buckets):
            accs = None
            for blk_cols, gathered, valid in blocks():
                reds = []
                for key, vps in buckets:
                    parts, width = bucket_parts(vps, blk_cols, gathered, valid)
                    reds.append(ops.Parts(
                        "seg", bucket_codes(key, vps, blk_cols), parts,
                        vps[0].seg.n_segments if key else 1, width))
                for vp in hist_views:
                    reds.append(ops.Parts(
                        "hist", blk_cols[vp.hist.code_attr].to(torch.int32),
                        (hist_cond(vp, blk_cols, gathered, valid),
                         blk_cols[vp.hist.y_attr].to(torch.float32)),
                        vp.hist.n_buckets))
                outs = ops.fused_scan_parts(reds)
                if accs is None:
                    accs = list(outs)
                else:
                    for acc, out in zip(accs, outs):
                        acc += out
            bucket_accs = accs[:len(buckets)]
            hist_accs = []
            for vp, acc in zip(hist_views, accs[len(buckets):]):
                if vp.batched:   # columns [node j, stat k] -> (N, D, 3)
                    acc = acc.view(vp.hist.n_buckets, n_nodes, 3).permute(
                        1, 0, 2)
                hist_accs.append(acc)
        else:
            hist_accs = [torch.zeros(
                ((n_nodes,) if vp.batched else ()) + (vp.hist.n_buckets, 3),
                dtype=torch.float32, device=device) for vp in hist_views]
            bucket_accs = [torch.zeros(
                (vps[0].seg.n_segments if key else 1,
                 sum(flat_width(vp, n_nodes) for vp in vps)),
                dtype=torch.float32, device=device) for key, vps in buckets]
            for blk_cols, gathered, valid in blocks():
                for vp, acc in zip(hist_views, hist_accs):
                    codes = blk_cols[vp.hist.code_attr].to(torch.int32)
                    y = blk_cols[vp.hist.y_attr].to(torch.float32)
                    cond = hist_cond(vp, blk_cols, gathered, valid)
                    if vp.batched:
                        acc += ops.tree_hist_batched(
                            codes, y, cond.contiguous(), vp.hist.n_buckets)
                    else:
                        acc += ops.tree_hist(codes, y, cond[:, 0],
                                             vp.hist.n_buckets)
                for (key, vps), acc in zip(buckets, bucket_accs):
                    acc += ops.seg_aggregate(
                        bucket_codes(key, vps, blk_cols),
                        bucket_payload(vps, blk_cols, gathered, valid),
                        vps[0].seg.n_segments if key else 1)

        for vp, acc in zip(hist_views, hist_accs):
            arrays[vp.vid] = common.finalize(vp, acc)
        for (key, vps), out in zip(buckets, bucket_accs):
            o = 0
            for vp in vps:
                w = flat_width(vp, n_nodes)
                n_seg = vp.seg.n_segments if vp.seg is not None else 1
                lead = (n_nodes,) if vp.batched else ()
                acc = out[:, o:o + w].reshape((n_seg,) + lead + vp.pulled_dims
                                              + (vp.n_aggs,))
                if vp.seg is None:
                    acc = acc[0]
                elif vp.batched:
                    acc = acc.movedim(1, 0)   # node axis back in front
                arrays[vp.vid] = common.finalize(vp, acc)
                o += w

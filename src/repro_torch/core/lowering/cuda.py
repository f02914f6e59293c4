"""CUDA lowering backend: segment reductions on the hand-written kernels;
counterpart of ``repro/core/lowering/pallas.py``.

Rows stream through a Python loop over ``PlanConfig.block_size`` blocks (the
reference's ``lax.scan``): each block gathers incoming views once, builds the
payloads of every view of the step with torch, and reduces them on the card.

Launch fusion (``PlanConfig.fuse_kernels``, default): the union of a step's
reductions — every local group-by bucket and every histogram-pattern view —
goes to ONE ``fused_scan_block`` launch per row block, packed exactly as the
reference packs it (bucket specs first, then hist specs; one ``[1, y, y²]``
triple per distinct y attribute, shared by the hist views on it).  The
unfused path launches one ``seg_aggregate`` per bucket and one
``tree_hist`` per hist view.  On CPU tensors the kernel wrappers run their
plain versions, which keeps this backend testable everywhere.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

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


def flat_width(vp: ViewProgram) -> int:
    w = vp.n_aggs
    for d in vp.pulled_dims:
        w *= d
    return w


def fused_layout(prog: StepProgram):
    """The static packing of a step's fused launch: ``(specs, yk_offs)``
    with bucket specs first, then one hist spec per hist view, and the
    payload offset of the ``[1, y, y²]`` triple of each y attribute."""
    hist_views, buckets = step_split(prog)
    specs: List[ops.ReduceSpec] = []
    c, off = 0, 0
    for key, vps in buckets:
        w = sum(flat_width(vp) for vp in vps)
        n_seg = vps[0].seg.n_segments if key else 1
        specs.append(ops.ReduceSpec("seg", c, n_seg, w, off))
        c += 1
        off += w
    cond_slots = []
    for _ in hist_views:
        cond_slots.append((c, off))
        c += 1
        off += 1
    yk_offs: Dict[str, int] = {}
    for vp in hist_views:
        if vp.hist.y_attr not in yk_offs:
            yk_offs[vp.hist.y_attr] = off
            off += 3
    for (ci, po), vp in zip(cond_slots, hist_views):
        specs.append(ops.ReduceSpec("hist", ci, vp.hist.n_buckets, 3, po,
                                    n_cond=1, yk_off=yk_offs[vp.hist.y_attr]))
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
                 n_valid: int, config) -> None:
        cols_blocked, n_blocks, B, _ = common.block_columns(
            rel_cols, config.block_size)
        device = next(iter(rel_cols.values())).device
        hist_views, buckets = step_split(prog)

        def blocks():
            """Per row block: (columns, gathered child slices, validity)."""
            for blk_i in range(n_blocks):
                blk_cols = {a: c[blk_i] for a, c in cols_blocked.items()}
                valid = common.block_validity(blk_i, B, n_valid, device)
                gathered = common.gather_children(prog.gathers, blk_cols,
                                                  arrays, B)
                yield blk_cols, gathered, valid

        def bucket_payload(vps, blk_cols, gathered, valid):
            return torch.cat(
                [common.view_payload(vp, blk_cols, gathered, params, valid,
                                     B).reshape(B, -1) for vp in vps], dim=1)

        def hist_cond(vp, blk_cols, gathered, valid):
            return common.col_payload(vp.hist.cond, blk_cols, gathered,
                                      params, B, device) * valid

        def bucket_codes(key, vps, blk_cols):
            if key:
                return common.segment_ids(blk_cols, vps[0].seg).to(torch.int32)
            return torch.zeros((B,), dtype=torch.int32, device=device)

        if config.fuse_kernels and (hist_views or buckets):
            specs, yk_offs = fused_layout(prog)
            accs = [torch.zeros((sp.n_segments, sp.width), dtype=torch.float32,
                                device=device) for sp in specs]
            for blk_cols, gathered, valid in blocks():
                code_cols, pay_cols = [], []
                for key, vps in buckets:
                    code_cols.append(bucket_codes(key, vps, blk_cols))
                    pay_cols.append(bucket_payload(vps, blk_cols, gathered,
                                                   valid))
                for vp in hist_views:
                    code_cols.append(blk_cols[vp.hist.code_attr].to(torch.int32))
                    pay_cols.append(hist_cond(vp, blk_cols, gathered,
                                              valid)[:, None])
                for ya in yk_offs:
                    y = blk_cols[ya].to(torch.float32)
                    pay_cols.append(torch.stack([torch.ones_like(y), y, y * y],
                                                dim=1))
                outs = ops.fused_scan_block(torch.stack(code_cols, dim=1),
                                            torch.cat(pay_cols, dim=1), specs)
                for acc, out in zip(accs, outs):
                    acc += out
            bucket_accs = accs[:len(buckets)]
            hist_accs = accs[len(buckets):]
        else:
            hist_accs = [torch.zeros((vp.hist.n_buckets, 3), dtype=torch.float32,
                                     device=device) for vp in hist_views]
            bucket_accs = [torch.zeros(
                (vps[0].seg.n_segments if key else 1,
                 sum(flat_width(vp) for vp in vps)), dtype=torch.float32,
                device=device) for key, vps in buckets]
            for blk_cols, gathered, valid in blocks():
                for vp, acc in zip(hist_views, hist_accs):
                    acc += ops.tree_hist(
                        blk_cols[vp.hist.code_attr].to(torch.int32),
                        blk_cols[vp.hist.y_attr].to(torch.float32),
                        hist_cond(vp, blk_cols, gathered, valid),
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
                w = flat_width(vp)
                n_seg = vp.seg.n_segments if vp.seg is not None else 1
                acc = out[:, o:o + w].reshape((n_seg,) + vp.pulled_dims
                                              + (vp.n_aggs,))
                if vp.seg is None:
                    acc = acc[0]
                arrays[vp.vid] = common.finalize(vp, acc)
                o += w

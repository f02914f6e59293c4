"""Plain-torch lowering backend: a blocked loop whose reductions are
``index_add_``; counterpart of ``repro/core/lowering/xla.py``.

Rows stream through a Python loop over ``PlanConfig.block_size`` blocks
(the reference's ``lax.scan``): each block gathers incoming views once,
evaluates every fused view's payload, and reduces it in float32, as the
reference's ``jax.ops.segment_sum`` does: by ``index_add_`` (local
group-bys) or by a sum over the row axis (scalar / pulled-only views) into
a block partial, which is then added to the step's total.  ``index_add_``
adds row by row into its output, and one float32 partial of a 2²⁰-row
block put the covar batch 3.4e-4 off a float64 oracle on the card at 84M
rows (the kernels: 5.0e-6; ``chip_smoke.py``'s ``config.torch``), so
:func:`segment_sum` gives every run of :data:`CHUNK_ROWS` rows of a block
its own float32 copy of the segments, in the same ``index_add_``, and sums
the copies by ``torch.sum``.
No hand-written kernel runs, so no launch is counted: this backend is the
whole-path library baseline of the ``cuda`` one, chosen only by
``ExecutionConfig(backend="torch")`` and never in place of a kernel.

On the card ``index_add_`` adds in an order that varies from run to run,
so two runs agree to float32 rounding, not bitwise.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch

from repro_torch.core.aggregates import Params
from repro_torch.core.ir import StepProgram
from repro_torch.core.lowering import common

#: rows of a block that add into one float32 copy of a view's segments
CHUNK_ROWS = 1 << 12
#: the most bytes the copies of one view may take (a view too wide for two
#: copies is reduced in one)
MAX_COPIES_BYTES = 256 << 20


def segment_sum(ids: torch.Tensor, payload: torch.Tensor, n_seg: int,
                row_axis: int = 0) -> torch.Tensor:
    """Float32 sum of ``payload``'s rows (along ``row_axis``) into ``n_seg``
    segments by ``ids``: one ``index_add_`` into a copy of the segments per
    :data:`CHUNK_ROWS` rows (as many as :data:`MAX_COPIES_BYTES` holds),
    then a ``torch.sum`` over the copies."""
    n_rows = int(ids.shape[0])
    shape = list(payload.shape)
    shape[row_axis] = n_seg
    copies = max(1, min(-(-n_rows // CHUNK_ROWS),
                        MAX_COPIES_BYTES // max(4 * math.prod(shape), 1)))
    per_copy = -(-n_rows // copies)
    chunk = torch.arange(n_rows, device=ids.device) // per_copy
    shape[row_axis] = copies * n_seg
    out = payload.new_zeros(shape).index_add_(row_axis, ids + chunk * n_seg,
                                              payload)
    return out.unflatten(row_axis, (copies, n_seg)).sum(dim=row_axis)


class TorchBackend:
    """Lowers one scan step to a blocked loop of torch reductions."""

    name = "torch"

    def run_step(self, prog: StepProgram, rel_cols: Mapping[str, torch.Tensor],
                 arrays: Dict[int, torch.Tensor], params: Params, *,
                 n_valid, config, n_nodes: Optional[int] = None,
                 weights: Optional[torch.Tensor] = None,
                 offset: int = 0) -> None:
        """``weights`` (optional, (n_rows,) float) multiply each row's
        contribution — signed multiplicities of a maintained view's delta
        scan (+1 insert, -1 delete, 0 padding).  Rows count where they lie
        in the global window ``[offset, offset + n_valid)``: a rank's shard
        of a partitioned relation starts at its ``offset``
        (``core/distributed.py``).  ``n_valid`` is a host int or a 0-d
        device tensor (``common.block_validity``)."""
        cols_blocked, n_blocks, B, n_pad = common.block_columns(
            rel_cols, config.block_size, weights)
        w_blocked = cols_blocked.pop(common.ROW_WEIGHT, None)
        device = next(iter(rel_cols.values())).device

        # batched views carry the param-batch (node) axis in front: one
        # relation pass accumulates all N parameter settings at once
        accs = [torch.zeros(((n_nodes,) if vp.batched else ()) + vp.acc_shape,
                            dtype=torch.float32, device=device)
                for vp in prog.views]
        for blk_i in range(n_blocks):
            blk_cols = {a: c[blk_i] for a, c in cols_blocked.items()}
            valid = common.block_validity(
                blk_i, B, n_pad, n_valid, offset, device,
                None if w_blocked is None else w_blocked[blk_i])
            gathered = common.gather_children(prog.gathers, blk_cols, arrays, B)
            for vp, acc in zip(prog.views, accs):
                payload = common.view_payload(vp, blk_cols, gathered, params,
                                              valid, B, n_nodes)
                row_axis = 1 if vp.batched else 0
                if vp.seg is not None:
                    # (N?, B, ...) rows into segments: the reference's
                    # segment_sum over the row axis (behind the node axis)
                    acc += segment_sum(common.segment_ids(blk_cols, vp.seg),
                                       payload, acc.shape[row_axis], row_axis)
                else:
                    acc += payload.sum(dim=row_axis)

        for vp, acc in zip(prog.views, accs):
            arrays[vp.vid] = common.finalize(vp, acc)

"""Executable plan: IR build -> shared-scan schedule -> backend lowering;
counterpart of ``repro/core/plan.py`` (no autotune, no plan verifier, no
sharded psum).

  * ``ir.py`` compiles each view group into a typed :class:`GroupProgram`;
  * ``schedule.py`` fuses same-relation, dependency-independent groups into
    single shared scans and fixes execution order;
  * ``lowering/`` runs each fused step on the device (``cuda`` backend).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.aggregates import Params
from repro_torch.core.groups import ViewGroup
from repro_torch.core.ir import (StepProgram, batched_param_names,
                                 build_programs, compute_batched_vids,
                                 fuse_programs)
from repro_torch.core.jointree import JoinTree
from repro_torch.core.lowering import get_backend
from repro_torch.core.pushdown import PushdownResult
from repro_torch.core.schedule import Schedule, build_schedule
from repro_torch.core.schema import DatabaseSchema

Columns = Mapping[str, Mapping[str, torch.Tensor]]  # rel -> attr -> (n,)


def validate_block_size(block_size) -> None:
    if (not isinstance(block_size, int) or isinstance(block_size, bool)
            or block_size < 1):
        raise ValueError(f"block_size must be a positive int; got {block_size!r}")


@dataclasses.dataclass
class PlanConfig:
    #: rows per kernel launch: each scan step walks its relation in blocks
    #: of this many rows, and every block costs one launch per reduction
    #: (fused: one) plus the eager torch ops that build its payloads
    block_size: int = 1 << 20
    backend: str = "cuda"
    fuse_kernels: bool = True       # whole-step fused kernel launch

    def __post_init__(self):
        validate_block_size(self.block_size)


class ExecutablePlan:
    """Executes a pushed-down, merged, grouped aggregate batch by driving the
    scheduler's fused scan steps through the configured lowering backend."""

    def __init__(self, schema: DatabaseSchema, tree: JoinTree, result: PushdownResult,
                 groups: Sequence[ViewGroup], config: Optional[PlanConfig] = None):
        self.schema = schema
        self.tree = tree
        self.result = result
        self.views = result.views
        self.groups = list(groups)
        self.config = config or PlanConfig()
        self.programs = build_programs(schema, result.views, self.groups)
        self.schedule: Schedule = build_schedule(self.groups, fuse=True)
        self.step_programs: List[StepProgram] = [
            fuse_programs([self.programs[gid] for gid in step.gids])
            for step in self.schedule.steps]
        self.backend = get_backend(self.config.backend)
        # param-batch (node) axis bookkeeping
        self.batched_vids = compute_batched_vids(result.views)
        self.batched_params = batched_param_names(result.views)
        self._col_indices: Dict[Tuple[str, torch.device], torch.Tensor] = {}

    def n_kernel_launches(self) -> int:
        """Static kernel-launch *sites* per full pass (distinct kernels one
        scan block dispatches, summed over steps)."""
        return sum(self.backend.count_launches(prog, self.config)
                   for prog in self.step_programs)

    def bind(self, n_rows: Dict[str, int], n_nodes: Optional[int] = None):
        """Returns fn(columns, params) -> {query: tensor} for relations of
        ``n_rows`` rows.  ``n_nodes`` is the param-batch (node) axis size —
        required iff the plan has batched params, in which case each batched
        param carries a leading axis of that size and batched query outputs
        gain a leading node axis."""
        if self.batched_params and n_nodes is None:
            raise ValueError(
                f"plan has batched params {sorted(self.batched_params)}; "
                "bind with n_nodes (use CompiledBatch.run_batched)")
        n_rows = dict(n_rows)

        def run(columns: Columns, params: Params):
            return self.extract_outputs(
                self._run_steps(columns, params, n_rows, n_nodes))

        return run

    def bind_arrays(self, n_rows: Dict[str, int]):
        """Like :meth:`bind`, but the returned fn(columns, params) yields
        *every* materialized view tensor keyed by vid, not just the query
        outputs: the full scan of a maintained batch (``core/ivm.py``),
        which keeps these tensors as its state.  ``n_rows`` are the
        relations' valid row counts (their columns may run past them).
        Maintained batches have no param-batch axis."""
        n_rows = dict(n_rows)

        def run(columns: Columns, params: Params):
            return self._run_steps(columns, params, n_rows, None)

        return run

    def resolve_delta_configs(self, steps, n_rows: Sequence[int]) -> List[PlanConfig]:
        """One :class:`PlanConfig` per delta step of a maintained batch
        (``core/ivm.py``); ``n_rows[i]`` is step i's scan length.  The port
        has no autotuner, so every step runs the session's config (the
        reference's fixed-blocking branch)."""
        return [self.config] * len(steps)

    def _run_steps(self, columns: Columns, params: Params,
                   n_rows: Dict[str, int],
                   n_nodes: Optional[int]) -> Dict[int, torch.Tensor]:
        arrays: Dict[int, torch.Tensor] = {}
        for step, prog in zip(self.schedule.steps, self.step_programs):
            self.backend.run_step(prog, columns[step.rel], arrays, params,
                                  n_valid=n_rows[step.rel],
                                  config=self.config, n_nodes=n_nodes)
        return arrays

    def extract_outputs(self, arrays: Mapping[int, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Read query results out of view tensors (column select + transpose
        from canonical to user group-by order)."""
        out = {}
        for qname, qo in self.result.outputs.items():
            arr = arrays[qo.vid]
            cols = arr.index_select(-1, self._col_index(qname, arr.device))
            # canonical axis order -> user group-by order; a leading node
            # axis (batched outputs) stays in front
            lead = 1 if qo.vid in self.batched_vids else 0
            perm = [qo.canonical_group_by.index(a) + lead
                    for a in qo.query.group_by]
            perm = list(range(lead)) + perm + [lead + len(qo.query.group_by)]
            out[qname] = cols.permute(perm)
        return out

    def _col_index(self, qname: str, device: torch.device) -> torch.Tensor:
        """The output's view columns as an index tensor on ``device``, made
        once: a Python list as an index would cross to the card (and sync)
        on every read."""
        key = (qname, device)
        idx = self._col_indices.get(key)
        if idx is None:
            idx = torch.tensor(self.result.outputs[qname].cols,
                               dtype=torch.int64, device=device)
            self._col_indices[key] = idx
        return idx


# ---------------------------------------------------------------------------
# Naive baseline: materialize the join, then aggregate (a test oracle).
# ---------------------------------------------------------------------------

def materialize_join(schema: DatabaseSchema, tables: Mapping[str, Mapping[str, np.ndarray]],
                     order: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    """Host-side hash join of all relations (natural join), numpy columns."""
    names = list(order or schema.relations)
    joined: Dict[str, np.ndarray] = {a: np.asarray(c) for a, c in tables[names[0]].items()}
    for name in names[1:]:
        right = {a: np.asarray(c) for a, c in tables[name].items()}
        shared = sorted(set(joined) & set(right))
        if not shared:
            raise ValueError(f"cartesian product at {name}; provide a join order")
        # build hash index on right
        rkeys = list(zip(*[right[a].tolist() for a in shared]))
        index: Dict[Tuple, List[int]] = {}
        for i, k in enumerate(rkeys):
            index.setdefault(k, []).append(i)
        lkeys = list(zip(*[joined[a].tolist() for a in shared]))
        li, ri = [], []
        for i, k in enumerate(lkeys):
            for j in index.get(k, ()):
                li.append(i)
                ri.append(j)
        li = np.asarray(li, dtype=np.int64)
        ri = np.asarray(ri, dtype=np.int64)
        out = {a: c[li] for a, c in joined.items()}
        for a, c in right.items():
            if a not in out:
                out[a] = c[ri]
        joined = out
    return joined

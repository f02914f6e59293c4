"""Executable plan: IR build -> shared-scan schedule -> backend lowering;
counterpart of ``repro/core/plan.py``.
With ``PlanConfig.verify_plans`` on (auto: under pytest or ``REPRO_VERIFY``)
the static verifier checks every plan at compile time.

  * ``ir.py`` compiles each view group into a typed :class:`GroupProgram`;
  * ``schedule.py`` fuses same-relation, dependency-independent groups into
    single shared scans (``PlanConfig.fuse_scans``) and fixes execution
    order;
  * ``lowering/`` runs each fused step on the device (``cuda``: the
    hand-written kernels; ``torch``: plain torch reductions), each step in
    row blocks of its own size: ``block_size="auto"`` resolves one per step
    at bind time through ``autotune.py``.

Domain parallelism (``core/distributed.py``): a rank scans its shard of
the partitioned relation in the global window its ``offsets`` entry
shifts, and the views of a step over that relation are all-reduced on the
relation's process group (``psum_groups``, the reference's ``psum_axes``;
one collective a step) right after the step, before any later step
gathers them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.verify import verification_enabled
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
from repro_torch.obs.trace import lazy_span, span

Columns = Mapping[str, Mapping[str, torch.Tensor]]  # rel -> attr -> (n,)


def validate_blocking(block_size) -> None:
    """Shared validation of the blocking knob (PlanConfig and the session
    ExecutionConfig raise identically).  ``"auto"`` defers it to the
    bind-time autotuner (``core/autotune.py``)."""
    if block_size != "auto" and (
            not isinstance(block_size, int) or isinstance(block_size, bool)
            or block_size < 1):
        raise ValueError("block_size must be a positive int or 'auto'; "
                         f"got {block_size!r}")


@dataclasses.dataclass
class PlanConfig:
    #: rows per kernel launch (int | "auto"): each scan step walks its
    #: relation in blocks of this many rows, and every block costs one
    #: launch per reduction (fused: one) plus the eager torch ops that
    #: build its payloads
    block_size: object = 1 << 20
    backend: str = "cuda"           # lowering backend: "cuda" | "torch"
    fuse_scans: bool = True         # shared-scan fusion across view groups
    fuse_kernels: bool = True       # whole-step fused kernel launch
    autotune_cache: Optional[str] = None  # autotuner cache path override
    verify_plans: Optional[bool] = None   # static plan verification;
                                          # None = auto: on under pytest /
                                          # REPRO_VERIFY

    def __post_init__(self):
        validate_blocking(self.block_size)
        if self.verify_plans not in (None, True, False):
            raise ValueError("verify_plans must be True, False, or None "
                             f"(auto); got {self.verify_plans!r}")


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
        with span("compile.ir", n_groups=len(self.groups)):
            self.programs = build_programs(schema, result.views, self.groups)
        with span("compile.schedule", fuse=self.config.fuse_scans):
            self.schedule: Schedule = build_schedule(
                self.groups, fuse=self.config.fuse_scans)
            self.step_programs: List[StepProgram] = [
                fuse_programs([self.programs[gid] for gid in step.gids])
                for step in self.schedule.steps]
        #: :class:`~repro_torch.analysis.verify.VerificationReport` of the
        #: static plan check, or None when verification is off
        self.last_verification = None
        if verification_enabled(self.config.verify_plans):
            from repro_torch.analysis.verify import verify_plan
            with span("compile.verify"):
                self.last_verification = verify_plan(self)
        self.backend = get_backend(self.config.backend)
        # param-batch (node) axis bookkeeping
        self.batched_vids = compute_batched_vids(result.views)
        self.batched_params = batched_param_names(result.views)
        self._col_indices: Dict[Tuple[str, torch.device], torch.Tensor] = {}
        self._autotuner = None
        #: per-step record of the last blocking resolution (``bind`` fills
        #: it when the config carries "auto"); surfaced by ``explain()``
        self.last_autotune: Optional[List[Dict[str, object]]] = None
        #: same, for the IVM delta tick (``resolve_delta_configs``)
        self.last_autotune_delta: Optional[List[Dict[str, object]]] = None

    # ------------------------------------------------------------- autotune

    @property
    def autotuner(self):
        """Lazily constructed (loads the on-disk cache once per plan)."""
        if self._autotuner is None:
            from repro_torch.core.autotune import Autotuner
            self._autotuner = Autotuner(self.config.autotune_cache)
        return self._autotuner

    def resolve_step_configs(self, n_rows: Mapping[str, int],
                             n_nodes: Optional[int] = None,
                             device=None) -> List[PlanConfig]:
        """One concrete :class:`PlanConfig` per scan step.  A static
        ``block_size`` passes the session config through untouched;
        ``"auto"`` resolves through the autotuner, keyed per step on
        (relation row count, widest segment layout, total payload width,
        node axis, backend, the type of ``device``, where the relations
        lie) — at bind time, so its timing probes never land in a steady
        run."""
        steps = self.schedule.steps
        return self._resolve(
            [(step.rel, prog, n_rows[step.rel], False)
             for step, prog in zip(steps, self.step_programs)],
            n_nodes, device, delta_lane=False)

    def resolve_delta_configs(self, steps, n_rows: Sequence[int],
                              n_nodes: Optional[int] = None,
                              device=None) -> List[PlanConfig]:
        """One concrete :class:`PlanConfig` per IVM delta step (objects with
        ``.prog`` / ``.rel`` / ``.scans_delta``, see ``core/ivm.py``).
        ``n_rows[i]`` is step i's scan length: the |update| pad bucket for
        delta scans, the rescanned relation's capacity otherwise.  Delta
        scans tune under ``delta=True`` signatures, their own cache lane.
        Runs at tick-runner *build* time, so a steady tick never probes."""
        return self._resolve(
            [(st.rel, st.prog, max(int(rows), 1), st.scans_delta)
             for st, rows in zip(steps, n_rows)],
            n_nodes, device, delta_lane=True)

    def _resolve(self, items, n_nodes: Optional[int], device,
                 delta_lane: bool) -> List[PlanConfig]:
        """``items``: (relation, step program, rows, delta) per step; the
        report goes to ``last_autotune_delta`` for the delta lane, else to
        ``last_autotune``."""
        cfg = self.config
        if cfg.block_size != "auto":
            return [cfg] * len(items)
        from repro_torch.core import autotune as at

        if device is None:
            raise ValueError("block_size='auto' tunes on the relations' "
                             "device: pass device= to bind")
        platform = torch.device(device).type
        out, report = [], []
        with span("compile.autotune", n_steps=len(items),
                  **({"delta": True} if delta_lane else {})):
            for rel, prog, rows, delta in items:
                n_seg, width = self._prog_tune_dims(prog, n_nodes)
                sig = at.signature_for_step(cfg.backend, platform, rows,
                                            n_seg, width, n_nodes,
                                            delta=delta)
                res = self.autotuner.tune(sig)
                out.append(dataclasses.replace(cfg,
                                               block_size=res.block_size))
                rec = {"rel": rel, "key": sig.key(),
                       "block_size": res.block_size,
                       "from_cache": res.from_cache,
                       "fallback": res.fallback}
                if delta_lane:
                    rec["delta"] = delta
                report.append(rec)
        if delta_lane:
            self.last_autotune_delta = report
        else:
            self.last_autotune = report
        return out

    def _prog_tune_dims(self, prog: StepProgram, n_nodes: Optional[int]):
        """(widest segment layout, total payload width) of one fused step —
        the shape facts a tuning signature carries besides the row count."""
        n_seg, width = 1, 0
        for vp in prog.views:
            lead = (n_nodes or 1) if vp.batched else 1
            if vp.hist is not None:
                n_seg = max(n_seg, vp.hist.n_buckets)
                width += 3 * lead
            else:
                if vp.seg is not None:
                    n_seg = max(n_seg, vp.seg.n_segments)
                w = vp.n_aggs * lead
                for d in vp.pulled_dims:
                    w *= d
                width += w
        return n_seg, max(width, 1)

    def n_kernel_launches(self) -> int:
        """Static kernel-launch *sites* per full pass (distinct kernels one
        scan block dispatches, summed over steps); 0 for the ``torch``
        backend (no hand-written kernels)."""
        count = getattr(self.backend, "count_launches", None)
        if count is None:
            return 0
        return sum(count(prog, self.config) for prog in self.step_programs)

    # ------------------------------------------------------------------ api

    def bind(self, n_rows: Dict[str, int], n_nodes: Optional[int] = None,
             device=None):
        """Returns fn(columns, params, offsets=None, psum_groups=None) ->
        {query: tensor} for relations of ``n_rows`` valid rows on
        ``device`` (columns may be padded beyond them).  ``offsets`` shift
        a relation's validity window for a rank's shard and
        ``psum_groups`` all-reduce its steps' views on a process group
        (``core/distributed.py``).  ``n_nodes`` is the param-batch (node)
        axis size — required iff the plan has batched params, in which
        case each batched param carries a leading axis of that size and
        batched query outputs gain a leading node axis.  ``"auto"``
        blocking resolves here, once per bind, by probes on ``device``
        (required then)."""
        if self.batched_params and n_nodes is None:
            raise ValueError(
                f"plan has batched params {sorted(self.batched_params)}; "
                "bind with n_nodes (use CompiledBatch.run_batched)")
        n_rows = dict(n_rows)
        with span("compile.bind", n_steps=len(self.schedule.steps)):
            step_configs = self.resolve_step_configs(n_rows, n_nodes, device)

        def run(columns: Columns, params: Params,
                offsets: Optional[Mapping[str, int]] = None,
                psum_groups: Optional[Mapping[str, object]] = None):
            return self.extract_outputs(self._run_steps(
                columns, params, n_rows, n_nodes, step_configs, offsets,
                psum_groups))

        return run

    def bind_arrays(self, n_rows: Dict[str, int], device=None):
        """Like :meth:`bind`, but the returned fn(columns, params,
        n_valid=None, psum_groups=None) yields *every* materialized view
        tensor keyed by vid, not just the query outputs: the full scan of a
        maintained batch (``core/ivm.py``), which keeps these tensors as
        its state.  ``n_rows`` are the relations' row counts (their columns
        may run past them), which the autotuner keys on; ``n_valid``
        overrides a relation's valid rows with a 0-d device tensor (a
        shard's own count).  Maintained batches have no param-batch
        axis."""
        n_rows = dict(n_rows)
        with span("compile.bind", n_steps=len(self.schedule.steps),
                  arrays=True):
            step_configs = self.resolve_step_configs(n_rows, None, device)

        def run(columns: Columns, params: Params,
                n_valid: Optional[Mapping[str, object]] = None,
                psum_groups: Optional[Mapping[str, object]] = None):
            nv = dict(n_rows)
            if n_valid:
                nv.update(n_valid)
            return self._run_steps(columns, params, nv, None, step_configs,
                                   psum_groups=psum_groups)

        return run

    def _run_steps(self, columns: Columns, params: Params,
                   n_rows: Dict[str, object], n_nodes: Optional[int],
                   step_configs: Sequence[PlanConfig],
                   offsets: Optional[Mapping[str, int]] = None,
                   psum_groups: Optional[Mapping[str, object]] = None
                   ) -> Dict[int, torch.Tensor]:
        offsets = offsets or {}
        psum_groups = psum_groups or {}
        arrays: Dict[int, torch.Tensor] = {}
        for step, prog, cfg in zip(self.schedule.steps, self.step_programs,
                                   step_configs):
            cols = columns[step.rel]
            with lazy_span("scan.step", self.step_args, prog, cols, cfg, n_nodes):
                self.backend.run_step(prog, cols, arrays, params,
                                      n_valid=n_rows[step.rel],
                                      offset=offsets.get(step.rel, 0),
                                      config=cfg, n_nodes=n_nodes)
                if step.rel in psum_groups:
                    all_reduce_views(arrays, step.vids, psum_groups[step.rel])
        return arrays

    def step_args(self, prog: StepProgram, cols: Mapping[str, torch.Tensor],
                  cfg: PlanConfig, n_nodes: Optional[int] = None) -> Dict[str, object]:
        """A ``scan.step`` span's arguments: the step's relation, the rows
        it scans (its columns' length, pads included: host metadata, no
        sync) and their row blocks, its views, and its widest segment
        layout and total payload width."""
        n = int(next(iter(cols.values())).shape[0])
        n_seg, width = self._prog_tune_dims(prog, n_nodes)
        return {"rel": prog.rel, "n_rows": n,
                "n_blocks": max(-(-n // cfg.block_size), 1),
                "vids": [vp.vid for vp in prog.views],
                "n_segments": n_seg, "width": width}

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


def all_reduce_views(arrays: Dict[int, torch.Tensor], vids: Sequence[int],
                     group) -> None:
    """Replace each of ``arrays[vid]`` by its sum over the ranks of
    ``group`` (the reference's ``psum`` of each view), in ONE
    ``all_reduce`` of the views flattened side by side — as XLA combines
    the reference's psums of a step — so a step costs one collective
    however many views it holds.  The sums come back contiguous (a view's
    finalize may leave it permuted)."""
    if not vids:
        return
    flat = torch.cat([arrays[v].reshape(-1) for v in vids])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    o = 0
    for v in vids:
        shape = arrays[v].shape
        n = arrays[v].numel()
        arrays[v] = flat[o:o + n].view(shape)
        o += n


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

"""Engine internals: compile a batch of aggregate queries into an executable;
counterpart of ``repro/core/engine.py`` (no deprecated ``compile`` shims,
no mesh).

The public entry point is the session facade (``repro_torch.connect`` →
``Database.views``); this module is what it drives:

    eng = Engine(schema, sizes=db.sizes())
    batch = eng._compile(queries)             # layers 1-6
    results = batch(db)                       # {query name: dense tensor}
    results = batch.run_batched(db, params)   # N parameter settings at once
    mb = eng._compile_maintained(queries)     # incrementally maintained
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import roots as roots_mod
from repro_torch.core.aggregates import Params, Query
from repro_torch.core.groups import ViewGroup, group_views, independent_sets
from repro_torch.core.jointree import JoinTree
from repro_torch.core.plan import ExecutablePlan, PlanConfig
from repro_torch.core.pushdown import PushdownResult, push_down
from repro_torch.core.schema import DatabaseSchema


@dataclasses.dataclass
class BatchStats:
    """Paper Table 2 analogue.  ``n_scan_steps`` counts the relation scans
    actually executed after shared-scan fusion; ``n_fused_scans`` is how many
    of the ``n_groups`` group scans the scheduler eliminated."""

    n_app_aggregates: int
    n_intermediate_cols: int
    n_views_premerge: int
    n_views: int
    n_groups: int
    group_levels: int
    n_scan_steps: int
    n_fused_scans: int
    roots: Dict[str, str]
    #: static kernel-launch sites per full pass
    n_kernel_launches: int = 0

    def summary(self) -> str:
        return (f"A={self.n_app_aggregates} I={self.n_intermediate_cols} "
                f"V={self.n_views} (pre-merge {self.n_views_premerge}) "
                f"G={self.n_groups} levels={self.group_levels} "
                f"scans={self.n_scan_steps} (fused {self.n_fused_scans}) "
                f"launches={self.n_kernel_launches}")


class CompiledBatch:
    def __init__(self, schema: DatabaseSchema, tree: JoinTree,
                 result: PushdownResult, groups: List[ViewGroup],
                 config: PlanConfig, roots: Dict[str, str]):
        self.schema = schema
        self.tree = tree
        self.result = result
        self.groups = groups
        self.config = config
        self.roots = roots
        self.plan = ExecutablePlan(schema, tree, result, groups, config)
        #: bound runners keyed by relation sizes (and node-axis size)
        self._runners = {}
        #: passes run (``__call__`` + ``run_batched``); a frontier-batched
        #: tree fit makes one per tree level
        self.n_dispatches = 0

    @property
    def stats(self) -> BatchStats:
        s = self.result.stats
        sched = self.plan.schedule
        return BatchStats(
            n_app_aggregates=s.n_app_aggregates,
            n_intermediate_cols=s.n_intermediate_cols,
            n_views_premerge=s.n_views_premerge,
            n_views=s.n_views,
            n_groups=len(self.groups),
            group_levels=len(independent_sets(self.groups)),
            n_scan_steps=sched.n_scans,
            n_fused_scans=sched.n_fused_groups,
            roots=self.roots,
            n_kernel_launches=self.plan.n_kernel_launches(),
        )

    @property
    def schedule(self):
        """The fused scan schedule this batch executes."""
        return self.plan.schedule

    def _runner(self, db, n_nodes: Optional[int]):
        key = (n_nodes, tuple(sorted(db.sizes().items())))
        if key not in self._runners:
            self._runners[key] = self.plan.bind(db.sizes(), n_nodes=n_nodes)
        return self._runners[key]

    def __call__(self, db, params: Optional[Params] = None) -> Dict[str, torch.Tensor]:
        params = _params_on(params, db.device)
        cols = {name: dict(rel.columns) for name, rel in db.relations.items()}
        run = self._runner(db, None)
        self.n_dispatches += 1
        return run(cols, params)

    @property
    def batched_params(self):
        """Names of the batch's ``Param(batched=True)`` declarations."""
        return self.plan.batched_params

    def run_batched(self, db, params: Params, n_nodes: Optional[int] = None,
                    pad_to_pow2: bool = True) -> Dict[str, torch.Tensor]:
        """Evaluate ``N`` parameter settings of the compiled batch in one
        pass over the relations.

        Every batched param in ``params`` carries a leading axis of size
        ``N`` (read off the first batched param when ``n_nodes`` is
        omitted); batched query outputs come back as ``(N, *group_dims,
        n_aggs)``.  The scan schedule is the N=1 one: one pass over each
        relation serves all ``N`` nodes.

        ``pad_to_pow2`` (default) rounds the node axis up to the next power
        of two with zeroed param rows, sliced off the outputs, as the
        reference does; the kernels' launch plans are then cached for at
        most ``log2`` distinct widths."""
        if not self.plan.batched_params:
            raise ValueError("batch was compiled without batched params; "
                             "declare Param(..., batched=True) terms first")
        params = _params_on(params, db.device)
        if n_nodes is None:
            n_nodes = int(params[sorted(self.plan.batched_params)[0]].shape[0])
        n_run = n_nodes
        if pad_to_pow2:
            n_run = 1 << (n_nodes - 1).bit_length()
        if n_run != n_nodes:
            for name in self.plan.batched_params:
                v = params[name]
                params[name] = torch.cat(
                    [v, v.new_zeros((n_run - n_nodes,) + tuple(v.shape[1:]))])
        cols = {name: dict(rel.columns) for name, rel in db.relations.items()}
        run = self._runner(db, n_run)
        self.n_dispatches += 1
        out = run(cols, params)
        if n_run != n_nodes:
            batched_vids = self.plan.batched_vids
            out = {q: (v[:n_nodes]
                       if self.result.outputs[q].vid in batched_vids else v)
                   for q, v in out.items()}
        return out


def _params_on(params: Optional[Params], device) -> Dict[str, object]:
    """The params with every array (numpy or torch) on ``device`` (the
    relations'), moved once per call; Python scalars stay on the host."""
    out = {}
    for k, v in (params or {}).items():
        if isinstance(v, (np.ndarray, torch.Tensor)):
            v = torch.as_tensor(v, device=device)
        out[k] = v
    return out


class Engine:
    """Layer driver: join tree -> roots -> pushdown+merge -> groups -> IR ->
    schedule -> backend lowering."""

    def __init__(self, schema: DatabaseSchema,
                 edges: Optional[Sequence[Tuple[str, str]]] = None,
                 sizes: Optional[Dict[str, int]] = None):
        self.schema = schema
        self.sizes = dict(sizes or {})
        if edges is not None:
            self.tree = JoinTree(schema, edges)
        else:
            self.tree = JoinTree.build(schema, self.sizes)

    def _compile(self, queries: Sequence[Query], *,
                 block_size: int = 1 << 20, backend: str = "cuda",
                 fuse_kernels: bool = True, multi_root: bool = True,
                 root_override: Optional[Dict[str, str]] = None) -> CompiledBatch:
        """Compile a query batch: multi-root pushdown (``multi_root=False``:
        every query at the one root of ``roots.single_root``;
        ``root_override``: query name -> root relation, for every query)
        and shared-scan fusion as in the reference's defaults;
        ``fuse_kernels`` gives one fused launch per step and row block;
        ``block_size`` is the rows per launch."""
        if root_override is not None:
            roots = dict(root_override)
        elif multi_root:
            roots = roots_mod.find_roots(self.tree, queries, self.sizes)
        else:
            roots = roots_mod.single_root(self.tree, queries, self.sizes)
        result = push_down(self.tree, queries, roots)
        groups = group_views(result)
        cfg = PlanConfig(block_size=block_size, backend=backend,
                         fuse_kernels=fuse_kernels)
        return CompiledBatch(self.schema, self.tree, result, groups, cfg,
                             roots)

    def _compile_maintained(self, queries: Sequence[Query], *,
                            root_override: Optional[Dict[str, str]] = None,
                            warm_rels: Sequence[str] = (), device=None,
                            **compile_kw):
        """Compile a query batch for incremental view maintenance (the
        reference's ``Engine._compile_incremental``): returns a
        :class:`~repro_torch.core.ivm.MaintainedBatch` whose ``init(db)``
        materializes every view as state and whose ``apply`` folds a
        :class:`~repro_torch.data.relations.DeltaBatchUpdate` into it by
        delta scans.  ``warm_rels`` builds those relations' delta programs
        now instead of at their first update; ``device`` is where a state
        restored before any ``init`` lies (the session's).

        Rejects non-invertible (MIN/MAX-style) aggregates up front: signed
        multiplicities maintain SUM-like aggregates only."""
        from repro_torch.core.ivm import MaintainedBatch

        for q in queries:
            for a in q.aggregates:
                for prod in a.products:
                    for t in prod.terms:
                        if not t.is_invertible():
                            raise ValueError(
                                f"query {q.name!r}: aggregate term {t.key()!r} "
                                "is not invertible under retraction (MIN/MAX-"
                                "style UDAF) — incremental maintenance by "
                                "signed multiplicities would produce wrong "
                                "results on deletes; register a batch view "
                                "(maintain=False) instead")
        batch = self._compile(queries, root_override=root_override,
                              **compile_kw)
        mb = MaintainedBatch(batch, device=device)
        for rel in warm_rels:
            mb.delta_program(rel)
        return mb

"""Engine internals: compile a batch of aggregate queries into an executable;
counterpart of ``repro/core/engine.py`` (batch subset).

The public entry point is the session facade (``repro_torch.connect`` →
``Database.views``); this module is what it drives:

    eng = Engine(schema, sizes=db.sizes())
    batch = eng._compile(queries)             # layers 1-6
    results = batch(db)                       # {query name: dense tensor}
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

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
        #: bound runners keyed by relation sizes
        self._runners = {}

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

    def __call__(self, db, params: Optional[Params] = None) -> Dict[str, torch.Tensor]:
        params = dict(params or {})
        key = tuple(sorted(db.sizes().items()))
        if key not in self._runners:
            self._runners[key] = self.plan.bind(db.sizes())
        cols = {name: dict(rel.columns) for name, rel in db.relations.items()}
        return self._runners[key](cols, params)


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
                 fuse_kernels: bool = True) -> CompiledBatch:
        """Compile a query batch: multi-root pushdown and shared-scan fusion
        as in the reference's defaults; ``fuse_kernels`` gives one fused
        launch per step and row block; ``block_size`` is the rows per
        launch."""
        roots = roots_mod.find_roots(self.tree, queries, self.sizes)
        result = push_down(self.tree, queries, roots)
        groups = group_views(result)
        cfg = PlanConfig(block_size=block_size, backend=backend,
                         fuse_kernels=fuse_kernels)
        return CompiledBatch(self.schema, self.tree, result, groups, cfg,
                             roots)

"""Copy of ``repro/core/schedule.py`` for the PyTorch port: identical apart
from imports, so that the port compiles the same plans without importing
the JAX package.

Shared-scan scheduler: fuse view groups into relation scan steps.

``group_views`` (layer 5) buckets ready views per relation within each peel
level of the view-dependency DAG, so it already shares one scan among
same-relation views that become ready together.  What it cannot see is the
cross-level opportunity: with multi-root batches the same relation is often
scanned by several groups at *different* dependency depths (e.g. Inventory
both as a leaf feeding upward views and as an interior node consuming them),
and whenever no dependency path connects two such groups their scans can be
fused into one shared pass — the paper's multi-output optimization applied
across groups (DESIGN.md §4).

``build_schedule`` starts from :func:`independent_sets` (the group-level
report), then greedily merges same-relation groups with no directed path
between them in the group dependency DAG until fixpoint.  Merging two
unordered nodes of a DAG cannot create a cycle, so the result is always
executable; levels are recomputed as longest-path depths over the merged
steps.  The emitted :class:`Schedule` is the ordered list of fused scan
steps the executor drives; ``n_scans`` vs ``n_groups`` is the Table 2
analogue the benchmarks report.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Set, Tuple

from repro_torch.core.groups import ViewGroup, independent_sets


@dataclasses.dataclass(frozen=True)
class ScanStep:
    """One fused multi-output scan over ``rel`` computing every view of the
    fused groups ``gids``."""

    sid: int
    rel: str
    gids: Tuple[int, ...]
    vids: Tuple[int, ...]
    level: int
    deps: Tuple[int, ...]   # sids of steps that must run first


@dataclasses.dataclass
class Schedule:
    """Ordered fused scan steps (topological: deps always precede users)."""

    steps: List[ScanStep]
    n_groups: int

    @property
    def n_scans(self) -> int:
        return len(self.steps)

    @property
    def n_fused_groups(self) -> int:
        """How many relation scans the fusion pass eliminated."""
        return self.n_groups - len(self.steps)

    def levels(self) -> List[List[int]]:
        """Steps per dependency level (same-level steps are independent)."""
        by_level: Dict[int, List[int]] = {}
        for s in self.steps:
            by_level.setdefault(s.level, []).append(s.sid)
        return [by_level[lv] for lv in sorted(by_level)]

    def summary(self) -> str:
        return (f"scans={self.n_scans} (fused {self.n_fused_groups} of "
                f"{self.n_groups} groups) levels={len(self.levels())}")


def build_schedule(groups: Sequence[ViewGroup], fuse: bool = True) -> Schedule:
    """Scheduler entry point: group dependency DAG -> fused scan steps."""
    # node table keyed by representative gid; deps stored as representatives
    members: Dict[int, List[int]] = {g.gid: [g.gid] for g in groups}
    deps: Dict[int, Set[int]] = {g.gid: set(g.deps) for g in groups}
    rel = {g.gid: g.rel for g in groups}
    parent: Dict[int, int] = {}

    def find(x: int) -> int:
        while x in parent:
            x = parent[x]
        return x

    def reachable(users: Dict[int, Set[int]], src: int, dst: int) -> bool:
        """Directed path src -> dst over current (merged) dep edges."""
        seen, stack = set(), [src]
        while stack:
            x = stack.pop()
            for y in users[x]:
                if y == dst:
                    return True
                if y not in seen:
                    seen.add(y)
                    stack.append(y)
        return False

    if fuse:
        # seed candidate order from the group-level report: earlier levels
        # first, so fused steps land at the earliest feasible slot
        order = [gid for lv in independent_sets(groups) for gid in lv]
        changed = True
        while changed:
            changed = False
            # dep edges only move on a merge, and every merge restarts this
            # loop — so one reverse-adjacency build serves the whole sweep
            users: Dict[int, Set[int]] = {r: set() for r in members}
            for r, ds in deps.items():
                for d in ds:
                    users[find(d)].add(r)
            reps = [r for r in order if r in members]
            for i, a in enumerate(reps):
                for b in reps[i + 1:]:
                    if rel[a] != rel[b]:
                        continue
                    if reachable(users, a, b) or reachable(users, b, a):
                        continue
                    # merge b into a
                    members[a].extend(members.pop(b))
                    deps[a] |= deps.pop(b)
                    parent[b] = a
                    for r in deps:
                        deps[r] = {find(d) for d in deps[r]}
                    deps[a].discard(a)
                    changed = True
                    break
                if changed:
                    break

    # longest-path levels over merged nodes
    level: Dict[int, int] = {}

    def depth(r: int) -> int:
        if r not in level:
            ds = {find(d) for d in deps[r]} - {r}
            level[r] = 1 + max((depth(d) for d in ds), default=-1)
        return level[r]

    for r in members:
        depth(r)

    by_gid = {g.gid: g for g in groups}
    reps_sorted = sorted(members, key=lambda r: (level[r], min(members[r])))
    sid_of = {r: i for i, r in enumerate(reps_sorted)}
    steps = []
    for r in reps_sorted:
        gids = tuple(sorted(members[r]))
        vids = tuple(v for gid in gids for v in by_gid[gid].vids)
        step_deps = tuple(sorted({sid_of[find(d)] for d in deps[r]}
                                 - {sid_of[r]}))
        steps.append(ScanStep(sid=sid_of[r], rel=rel[r], gids=gids, vids=vids,
                              level=level[r], deps=step_deps))
    return Schedule(steps=steps, n_groups=len(groups))

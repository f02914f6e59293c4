"""Copy of ``repro/core/groups.py`` for the PyTorch port: identical apart
from imports, so that the port compiles the same plans without importing
the JAX package.

Group Views layer (paper Fig. 1 layer 5).

Views going out of the same join-tree node with no dependency between them
form a *view group* — LMFAO's computational unit: one multi-output scan of the
group's relation computes every view in the group (paper §3.4–3.5).  We build
the view dependency DAG, then peel it level by level, bucketing ready views by
their scanned relation; the resulting group dependency graph (paper Fig. 3,
right) fixes execution order and exposes task parallelism.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Set, Tuple

from repro_torch.core.pushdown import PushdownResult, ViewDef


@dataclasses.dataclass
class ViewGroup:
    gid: int
    rel: str                 # the relation scanned by this group's plan
    vids: Tuple[int, ...]    # views computed by this group
    level: int               # topological level
    deps: Tuple[int, ...]    # gids this group depends on


def view_deps(v: ViewDef) -> Set[int]:
    out: Set[int] = set()
    for col in v.agg_cols:
        for prod in col.products:
            for ref in prod.child_cols:
                out.add(ref.vid)
    return out


def group_views(result: PushdownResult) -> List[ViewGroup]:
    views = result.views
    deps: Dict[int, Set[int]] = {vid: view_deps(v) for vid, v in views.items()}
    remaining = set(views)
    done: Set[int] = set()
    vid_group: Dict[int, int] = {}
    groups: List[ViewGroup] = []
    level = 0
    while remaining:
        ready = sorted(v for v in remaining if deps[v] <= done)
        if not ready:
            raise ValueError("cyclic view dependencies (bug in pushdown)")
        buckets: Dict[str, List[int]] = {}
        for vid in ready:
            buckets.setdefault(views[vid].rel, []).append(vid)
        for rel in sorted(buckets):
            vids = tuple(buckets[rel])
            gdeps = sorted({vid_group[d] for vid in vids for d in deps[vid]})
            gid = len(groups)
            groups.append(ViewGroup(gid=gid, rel=rel, vids=vids, level=level,
                                    deps=tuple(gdeps)))
            for vid in vids:
                vid_group[vid] = gid
        done.update(ready)
        remaining.difference_update(ready)
        level += 1
    return groups


def independent_sets(groups: Sequence[ViewGroup]) -> List[List[int]]:
    """Task-parallelism report: groups at the same level with disjoint deps can
    run concurrently (on TPU, XLA schedules them as independent subgraphs)."""
    by_level: Dict[int, List[int]] = {}
    for g in groups:
        by_level.setdefault(g.level, []).append(g.gid)
    return [by_level[lv] for lv in sorted(by_level)]

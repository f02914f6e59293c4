"""Copy of ``repro/core/roots.py`` for the PyTorch port: identical apart
from imports, so that the port compiles the same plans without importing
the JAX package.

Find Roots layer (paper §3.3, Fig. 1 layer 2) — novel in LMFAO.

Each query in the batch may be evaluated over the *same* join tree rooted at a
*different* node.  Root choice follows the paper's approximation: weight each
relation by the fraction of the query's group-by attributes it holds (equal
fractions across all relations for group-by-free queries), accumulate weights
over the batch, then assign relations as roots in decreasing total weight —
each relation claims all unassigned queries that considered it a possible
root.  Ties break toward larger relations.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.aggregates import Query
from repro_torch.core.jointree import JoinTree


def find_roots(tree: JoinTree, queries: Sequence[Query],
               sizes: Optional[Dict[str, int]] = None) -> Dict[str, str]:
    """Returns query name → root relation name."""
    sizes = sizes or {}
    nodes = tree.nodes
    m = len(nodes)

    weight: Dict[str, float] = {n: 0.0 for n in nodes}
    candidates: Dict[str, List[str]] = {}
    for q in queries:
        if not q.group_by:
            for n in nodes:
                weight[n] += 1.0 / m
            candidates[q.name] = list(nodes)
        else:
            f = float(len(q.group_by))
            cand = []
            for n in nodes:
                k = len(frozenset(q.group_by) & tree.schema.relation(n).attr_set)
                if k:
                    weight[n] += k / f
                    cand.append(n)
            # a query whose group-by attrs appear nowhere is invalid upstream;
            # if none of its attrs are local to a single relation, all nodes
            # carrying at least one attr are candidates (views pull the rest).
            candidates[q.name] = cand if cand else list(nodes)

    order = sorted(nodes, key=lambda n: (weight[n], sizes.get(n, 0)), reverse=True)

    roots: Dict[str, str] = {}
    for n in order:
        for q in queries:
            if q.name not in roots and n in candidates[q.name]:
                roots[q.name] = n
    return roots


def single_root(tree: JoinTree, queries: Sequence[Query],
                sizes: Optional[Dict[str, int]] = None) -> Dict[str, str]:
    """Ablation baseline: all queries share one root (the heaviest/largest
    relation) — 'LMFAO without multi-root' in Fig. 5."""
    sizes = sizes or {}
    multi = find_roots(tree, queries, sizes)
    counts: Dict[str, int] = {}
    for r in multi.values():
        counts[r] = counts.get(r, 0) + 1
    best = max(tree.nodes, key=lambda n: (counts.get(n, 0), sizes.get(n, 0)))
    return {q.name: best for q in queries}

"""Chow-Liu tree structure learning via pairwise mutual information (paper
§2); counterpart of ``repro/ml/chowliu.py``.

The MI of every attribute pair needs the 2-D count data cube over {Xi, Xj}
(paper eq. (7)): one count per (i,j) pair, one marginal per attribute, plus
the total — all group-by aggregates over the same join, evaluated as one
LMFAO batch.  This workload is the paper's Example 3.3: multi-root evaluation
turns the O(n²)-view chain into 2n linear-time views.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api import Database, ExecutionConfig, connect
from repro_torch.core.aggregates import COUNT, query
from repro_torch.data.datasets import Dataset


@dataclasses.dataclass
class ChowLiuResult:
    attrs: List[str]
    mi: np.ndarray                    # (n, n) pairwise mutual information
    edges: List[Tuple[str, str]]      # the learned tree
    n_aggregates: int = 0


def mi_queries(attrs: Sequence[str]):
    qs = [query("mi_total", [], [COUNT])]
    for a in attrs:
        qs.append(query(f"mi_m_{a}", [a], [COUNT]))
    for i, a in enumerate(attrs):
        for b in attrs[i + 1:]:
            qs.append(query(f"mi_p_{a}_{b}", [a, b], [COUNT]))
    return qs


def mutual_information(joint: np.ndarray, ma: np.ndarray, mb: np.ndarray,
                       total: float) -> float:
    """MI from counts: Σ δ/α · log(α·δ / (β·γ))  (paper's 4-ary f)."""
    d = joint / total
    denom = np.outer(ma, mb) / (total * total)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = d * np.log(d / denom)
    return float(np.nansum(np.where(joint > 0, t, 0.0)))


def chow_liu(ds: Dataset, attrs: Optional[Sequence[str]] = None,
             multi_root: bool = True, block_size: int = 1 << 20,
             backend: str = "cuda",
             config: Optional[ExecutionConfig] = None,
             database: Optional[Database] = None,
             device="cuda") -> ChowLiuResult:
    """Learn the Chow-Liu tree.  ``multi_root``/``backend``/``block_size``
    (or a full ``config`` / an open ``database`` session, whose config and
    device win) select the execution path; an unknown ``backend`` raises
    ``ValueError``."""
    attrs = list(attrs if attrs is not None else ds.features_cat)
    qs = mi_queries(attrs)
    db = database or connect(ds, config=config or ExecutionConfig(
        multi_root=multi_root, block_size=block_size, backend=backend),
        device=device)
    out = {k: v.cpu().numpy().astype(np.float64)
           for k, v in db.views(qs).run().items()}

    n = len(attrs)
    total = float(out["mi_total"][0])
    mi = np.zeros((n, n))
    for i, a in enumerate(attrs):
        for j_, b in enumerate(attrs[i + 1:], start=i + 1):
            joint = out[f"mi_p_{a}_{b}"][..., 0]
            v = mutual_information(joint, out[f"mi_m_{a}"][..., 0],
                                   out[f"mi_m_{b}"][..., 0], total)
            mi[i, j_] = mi[j_, i] = v

    # Chow-Liu = maximum spanning tree over MI (Kruskal)
    cand = sorted(((mi[i, j], i, j) for i in range(n) for j in range(i + 1, n)),
                  reverse=True)
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    edges = []
    for w, i, j in cand:
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[ri] = rj
            edges.append((attrs[i], attrs[j]))
    return ChowLiuResult(attrs=attrs, mi=mi, edges=edges,
                         n_aggregates=len(qs))

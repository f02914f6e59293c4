"""Covar-matrix workload (paper §2, eqs. (2)-(4)); counterpart of
``repro/ml/covar.py``.

The non-centered covariance matrix over the join defines ridge (and
polynomial) regression.  Continuous×continuous entries are scalar aggregates
SUM(Xi·Xk); a categorical attribute becomes a group-by (one-hot semantics);
two categoricals become a two-attribute group-by.  One engine batch computes
every entry; this is the paper's flagship workload (814 aggregates → 34 views
for Retailer).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api import Database, ExecutionConfig, connect
from repro_torch.core.aggregates import COUNT, Query, query, sum_of, sum_prod
from repro_torch.data.datasets import Dataset


@dataclasses.dataclass
class CovarLayout:
    """Feature layout of the dense covar matrix: [intercept] + continuous +
    one-hot categorical blocks + [label]."""

    cont: Tuple[str, ...]
    cat: Tuple[str, ...]
    cat_offsets: Dict[str, int]
    cat_domains: Dict[str, int]
    label: str
    p: int

    @property
    def label_idx(self) -> int:
        return self.p - 1

    def cont_idx(self, attr: str) -> int:
        return 1 + self.cont.index(attr)

    def cat_slice(self, attr: str) -> slice:
        o = self.cat_offsets[attr]
        return slice(o, o + self.cat_domains[attr])


def covar_queries(ds: Dataset, cont: Optional[Sequence[str]] = None,
                  cat: Optional[Sequence[str]] = None) -> Tuple[List[Query], CovarLayout]:
    cont = tuple(cont if cont is not None else ds.features_cont)
    cat = tuple(cat if cat is not None else ds.features_cat)
    label = ds.label
    doms = {c: ds.schema.domain(c) for c in cat}
    offs = {}
    o = 1 + len(cont)
    for c in cat:
        offs[c] = o
        o += doms[c]
    layout = CovarLayout(cont=cont, cat=cat, cat_offsets=offs, cat_domains=doms,
                         label=label, p=o + 1)

    xs = list(cont) + [label]  # continuous block incl. label
    queries: List[Query] = []

    # scalar block: intercept row/col + all pairwise continuous sums
    aggs = [COUNT] + [sum_of(x) for x in xs]
    for i, xi in enumerate(xs):
        for xk in xs[i:]:
            aggs.append(sum_prod(xi, xk))
    queries.append(query("cm_scalar", [], aggs))

    # categorical × continuous (eq. 3): group by the categorical
    for c in cat:
        queries.append(query(f"cm_cat_{c}", [c], [COUNT] + [sum_of(x) for x in xs]))

    # categorical × categorical (eq. 4): group by both
    for i, ci in enumerate(cat):
        for ck in cat[i + 1:]:
            queries.append(query(f"cm_cat2_{ci}_{ck}", [ci, ck], [COUNT]))

    return queries, layout


def assemble_covar(outputs: Dict[str, np.ndarray], layout: CovarLayout) -> Tuple[np.ndarray, float]:
    """Dense symmetric (p, p) covar matrix + dataset size N from the batch
    outputs (the application layer is cheap: paper §1)."""
    p = layout.p
    C = np.zeros((p, p), dtype=np.float64)
    xs = list(layout.cont) + [layout.label]
    xidx = [layout.cont_idx(x) for x in layout.cont] + [layout.label_idx]

    sc = np.asarray(outputs["cm_scalar"], dtype=np.float64)
    N = float(sc[0])
    C[0, 0] = N
    for i, xi in enumerate(xs):
        C[0, xidx[i]] = C[xidx[i], 0] = sc[1 + i]
    k = 1 + len(xs)
    for i in range(len(xs)):
        for j in range(i, len(xs)):
            C[xidx[i], xidx[j]] = C[xidx[j], xidx[i]] = sc[k]
            k += 1

    for c in layout.cat:
        out = np.asarray(outputs[f"cm_cat_{c}"], dtype=np.float64)  # (D, 1+len(xs))
        sl = layout.cat_slice(c)
        cnt = out[:, 0]
        C[sl, 0] = C[0, sl] = cnt
        np.fill_diagonal(C[sl, sl], cnt)  # one-hot: Xc·Xc = diag(count)
        for i, xi in enumerate(xs):
            C[sl, xidx[i]] = out[:, 1 + i]
            C[xidx[i], sl] = out[:, 1 + i]

    for i, ci in enumerate(layout.cat):
        for ck in layout.cat[i + 1:]:
            out = np.asarray(outputs[f"cm_cat2_{ci}_{ck}"], dtype=np.float64)[..., 0]
            C[layout.cat_slice(ci), layout.cat_slice(ck)] = out
            C[layout.cat_slice(ck), layout.cat_slice(ci)] = out.T
    return C, N


def compute_covar(ds: Dataset, database: Optional[Database] = None,
                  cont: Optional[Sequence[str]] = None,
                  cat: Optional[Sequence[str]] = None,
                  config: Optional[ExecutionConfig] = None,
                  device="cuda"):
    """End-to-end: register the covar batch as views on a session, run it,
    assemble the dense covar on the host.  Pass ``database`` to reuse an
    open session (its config and device win), or ``config`` / ``device`` to
    open one."""
    qs, layout = covar_queries(ds, cont, cat)
    db = database or connect(ds, config=config, device=device)
    views = db.views(qs)
    outputs = views.run()
    C, N = assemble_covar({k: v.cpu().numpy() for k, v in outputs.items()},
                          layout)
    return C, N, layout, views.compiled

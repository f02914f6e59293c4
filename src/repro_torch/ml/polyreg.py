"""Degree-d polynomial regression over joins (paper §2, eq. (5));
counterpart of ``repro/ml/polyreg.py``.

The PR_d covar matrix needs SUM(X^{a_1}·…·X^{a_n}) for every exponent vector
with Σa_j ≤ 2d — the heaviest sharing workload in the paper: most monomial
products are common subexpressions across covar entries, which the engine's
merge layer deduplicates (observe ``batch.result.stats.n_dedup_hits``).
Degree 2 over the continuous features (categoricals enter linearly, as in
ml/covar.py's one-hot treatment) is what the experiments exercise.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api import Database, ExecutionConfig, connect
from repro_torch.core.aggregates import COUNT, Pow, Term, Var, agg, query
from repro_torch.data.datasets import Dataset

Monomial = Tuple[Tuple[str, int], ...]   # ((attr, power), ...) sorted


def monomials(attrs: Sequence[str], degree: int) -> List[Monomial]:
    """All monomials of total degree ≤ ``degree`` (incl. the constant ())."""
    out: List[Monomial] = []
    for total in range(degree + 1):
        for combo in itertools.combinations_with_replacement(sorted(attrs), total):
            powers: Dict[str, int] = {}
            for a in combo:
                powers[a] = powers.get(a, 0) + 1
            out.append(tuple(sorted(powers.items())))
    # dedupe (combinations_with_replacement already yields unique multisets)
    return list(dict.fromkeys(out))


def _mono_terms(m: Monomial) -> List[Term]:
    return [Var(attr) if p == 1 else Pow(attr, p) for attr, p in m]


def _mono_product(m1: Monomial, m2: Monomial) -> Monomial:
    powers: Dict[str, int] = {}
    for attr, p in list(m1) + list(m2):
        powers[attr] = powers.get(attr, 0) + p
    return tuple(sorted(powers.items()))


@dataclasses.dataclass
class PolyLayout:
    features: List[Monomial]        # design-matrix columns (incl. constant)
    label: str
    index: Dict[Monomial, int]


def polyreg_queries(ds: Dataset, degree: int = 2,
                    attrs: Optional[Sequence[str]] = None):
    """One query holding every SUM(monomial) the PR_d covar needs."""
    attrs = list(attrs if attrs is not None else ds.features_cont)
    feats = monomials(attrs, degree)
    layout = PolyLayout(feats, ds.label, {m: i for i, m in enumerate(feats)})

    needed: Dict[Monomial, int] = {}
    for i, f in enumerate(feats):
        for g in feats[i:]:
            needed.setdefault(_mono_product(f, g), 0)
        # label column: SUM(f · y)
        needed.setdefault(_mono_product(f, ((ds.label, 1),)), 0)
    mono_list = list(needed)
    aggs = [agg(*_mono_terms(m)) if m else COUNT for m in mono_list]
    q = query(f"pr{degree}_covar", [], aggs)
    return [q], layout, mono_list


def compute_poly_covar(ds: Dataset, degree: int = 2,
                       attrs: Optional[Sequence[str]] = None,
                       block_size: int = 1 << 20, backend: str = "cuda",
                       config: Optional[ExecutionConfig] = None,
                       database: Optional[Database] = None,
                       device="cuda"):
    """Returns (C (p,p), b (p,), N, layout, batch) for the normal equations
    C/N θ = b/N (+ ridge).  Pass ``database`` to reuse an open session (its
    config and device win)."""
    qs, layout, mono_list = polyreg_queries(ds, degree, attrs)
    db = database or connect(ds, config=config or ExecutionConfig(
        block_size=block_size, backend=backend), device=device)
    views = db.views(qs)
    out = views.run()[qs[0].name].cpu().numpy().astype(np.float64)
    val = {m: out[i] for i, m in enumerate(mono_list)}

    p = len(layout.features)
    C = np.zeros((p, p))
    b = np.zeros(p)
    for i, f in enumerate(layout.features):
        b[i] = val[_mono_product(f, ((ds.label, 1),))]
        for j in range(i, p):
            C[i, j] = C[j, i] = val[_mono_product(f, layout.features[j])]
    N = val[()]
    return C, b, N, layout, views.compiled


def solve_polyreg(C: np.ndarray, b: np.ndarray, N: float,
                  lam: float = 1e-3) -> np.ndarray:
    """θ of the ridge normal equations ``(C/N + λI) θ = b/N`` on features
    scaled to unit second moment (monomials span wild magnitudes)."""
    scale = 1.0 / np.sqrt(np.maximum(np.diag(C) / N, 1e-12))
    Cs = C * scale[:, None] * scale[None, :]
    theta_s = np.linalg.solve(Cs / N + lam * np.eye(len(b)), (b * scale) / N)
    return theta_s * scale


def fit_polyreg(ds: Dataset, degree: int = 2, lam: float = 1e-3,
                attrs: Optional[Sequence[str]] = None,
                config: Optional[ExecutionConfig] = None,
                database: Optional[Database] = None, device="cuda"):
    """Returns (θ, layout, batch); ``config``/``database``/``device`` reach
    :func:`compute_poly_covar`, so a card session is reused."""
    C, b, N, layout, batch = compute_poly_covar(
        ds, degree, attrs, config=config, database=database, device=device)
    return solve_polyreg(C, b, N, lam), layout, batch


def predict_poly(theta: np.ndarray, layout: PolyLayout,
                 rows: Dict[str, np.ndarray]) -> np.ndarray:
    n = len(next(iter(rows.values())))
    yhat = np.zeros(n)
    for i, m in enumerate(layout.features):
        col = np.ones(n)
        for attr, pw in m:
            col = col * np.asarray(rows[attr], np.float64) ** pw
        yhat += theta[i] * col
    return yhat

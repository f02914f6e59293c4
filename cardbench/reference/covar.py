"""Plain reference of the covar job: the non-centred covariance matrix
``XᵀX`` of the join's design matrix, ``X = [1 | continuous features |
one-hot categorical features | label]`` in the configuration's feature
order, summed a block of joined rows at a time on the device.

``judge`` scores a covar matrix against it: the largest
``|C - G| / sqrt(G_ii · G_jj)`` over the entries.  ``control`` is the same
reference computed in bfloat16 (the design matrix, the products and the
running sum), the precision below the configuration's float32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from cardbench.reference._join import GatheredJoin

#: values of the design matrix a block holds (2 GiB in float64)
CHUNK_VALUES = 1 << 28


def layout(tables) -> Tuple[Dict[str, int], Dict[str, int], int]:
    """Column of each continuous feature and offset of each categorical
    block in X, and X's width."""
    cont = {a: 1 + i for i, a in enumerate(tables.features_cont)}
    cat, o = {}, 1 + len(cont)
    for a in tables.features_cat:
        cat[a] = o
        o += tables.domain(a)
    return cont, cat, o + 1


def design(tables, m: int, col, dtype, device) -> torch.Tensor:
    cont, cat, p = layout(tables)
    X = torch.zeros((m, p), dtype=dtype, device=device)
    X[:, 0] = 1
    for a, j in cont.items():
        X[:, j] = col(a).to(dtype)
    for a, o in cat.items():
        X.scatter_(1, (o + col(a).long())[:, None], 1)
    X[:, p - 1] = col(tables.label).to(dtype)
    return X


def xtx(tables, fact_columns=None, dtype=torch.float64) -> np.ndarray:
    """``XᵀX`` of the join (of ``fact_columns`` in the fact's place, when
    given), accumulated in ``dtype``; returned as float64 numpy."""
    _, _, p = layout(tables)
    join = GatheredJoin(tables, fact_columns, chunk=max(1 << 16, min(1 << 22, CHUNK_VALUES // p)))
    device = next(iter(tables.columns[tables.fact].values())).device
    G = torch.zeros((p, p), dtype=dtype, device=device)
    for m, col in join.chunks():
        X = design(tables, m, col, dtype, device)
        G += X.T @ X
    return G.double().cpu().numpy()


def scaled_err(C: np.ndarray, G: np.ndarray) -> float:
    d = np.sqrt(np.maximum(np.outer(np.diag(G), np.diag(G)), 1e-300))
    return float((np.abs(C - G) / d).max())


def judge(tables, record: dict) -> Dict[str, float]:
    """``record["C"]``: the covar matrices of the jobs compared."""
    G = xtx(tables)
    return {"covar_err": max(scaled_err(C, G) for C in record["C"])}


def control(tables, traffic: dict, seed: int, units: int) -> dict:
    """The reference in bfloat16 put in the program's place: the record a
    run of the mix would hand ``judge``."""
    return {"C": [xtx(tables, dtype=torch.bfloat16)]}

"""Ridge linear regression over the covar matrix (paper §2 + §4.2);
counterpart of ``repro/ml/ridge.py``, host float64 numpy as there.

Training never touches the (never-materialized) join: batch gradient descent
runs on the (p, p) covar matrix — the paper's (and AC/DC's) optimizer with
Armijo backtracking line search and Barzilai-Borwein step sizes.  A
closed-form solve cross-checks accuracy (the MADlib comparison).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.ml.covar import CovarLayout


@dataclasses.dataclass
class RidgeResult:
    theta: np.ndarray      # (p-1,) parameters for [intercept, features...]
    iterations: int
    objective: float


def _split(C: np.ndarray, layout: CovarLayout):
    li = layout.label_idx
    f = np.arange(C.shape[0]) != li
    Cff = C[np.ix_(f, f)]
    Cfl = C[f, li]
    Cll = C[li, li]
    return Cff, Cfl, Cll


def closed_form(C: np.ndarray, N: float, layout: CovarLayout, lam: float = 1e-3) -> np.ndarray:
    Cff, Cfl, _ = _split(C, layout)
    A = Cff / N + lam * np.eye(Cff.shape[0])
    return np.linalg.solve(A, Cfl / N)


def bgd(C: np.ndarray, N: float, layout: CovarLayout, lam: float = 1e-3,
        max_iters: int = 2000, tol: float = 1e-10) -> RidgeResult:
    """BGD with Armijo backtracking + Barzilai-Borwein step sizes.

    J(θ) = 1/(2N)·θ̃ᵀCθ̃ + λ/2·‖θ‖²  with θ̃ = [θ; -1] (label coefficient
    fixed at -1, paper §2).  The covar matrix is tiny relative to the data, so
    the convergence loop runs in float64 on host — the paper's point is that
    this step is *cheap* once the engine has produced the sufficient
    statistics."""
    Cff, Cfl, Cll = _split(C, layout)
    n_f = Cff.shape[0]

    # Jacobi preconditioning: one-hot blocks make the covar badly
    # conditioned; substituting θ = D·φ with D = diag(Cff/N + λ)^{-1/2}
    # solves the *same* ridge problem in a well-scaled space
    dscale = 1.0 / np.sqrt(np.maximum(np.diag(Cff) / N + lam, 1e-12))
    Cff = Cff * dscale[:, None] * dscale[None, :]
    Cfl = Cfl * dscale
    d2 = dscale * dscale

    def obj(th):
        return (th @ Cff @ th - 2 * th @ Cfl + Cll) / (2 * N) + \
            0.5 * lam * (th * th) @ d2

    def grad(th):
        return (Cff @ th - Cfl) / N + lam * d2 * th

    th = np.zeros(n_f)
    g = grad(th)
    prev_th, prev_g = th, g
    alpha = 1e-6
    it = 0
    while it < max_iters and np.linalg.norm(g) > tol * max(1.0, np.linalg.norm(th)):
        if it > 0:
            dth, dg = th - prev_th, g - prev_g
            denom = dth @ dg
            alpha = abs((dth @ dth) / denom) if abs(denom) > 1e-300 else alpha
            alpha = float(np.clip(alpha, 1e-12, 1e6))
        j0, gg = obj(th), g @ g
        while obj(th - alpha * g) > j0 - 0.5 * alpha * gg and alpha > 1e-16:
            alpha *= 0.5
        prev_th, prev_g = th, g
        th = th - alpha * g
        g = grad(th)
        it += 1
    final_obj = float(obj(th))
    th = th * dscale          # back to the unscaled parameterization
    return RidgeResult(theta=th, iterations=it, objective=final_obj)


def predict(theta: np.ndarray, layout: CovarLayout, rows: dict) -> np.ndarray:
    """Apply the model to materialized rows (test-time only; numpy)."""
    n = len(next(iter(rows.values())))
    yhat = np.full(n, theta[0], dtype=np.float64)
    for x in layout.cont:
        yhat += theta[layout.cont_idx(x)] * np.asarray(rows[x], dtype=np.float64)
    for c in layout.cat:
        sl = layout.cat_slice(c)
        yhat += theta[np.arange(sl.start, sl.stop)[np.asarray(rows[c])] ]
    return yhat


def rmse(theta: np.ndarray, layout: CovarLayout, rows: dict) -> float:
    y = np.asarray(rows[layout.label], dtype=np.float64)
    return float(np.sqrt(np.mean((predict(theta, layout, rows) - y) ** 2)))

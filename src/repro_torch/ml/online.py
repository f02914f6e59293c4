"""Streaming model refresh over maintained aggregates; counterpart of
``repro/ml/online.py``.

:class:`OnlineRidge` keeps the covar-matrix batch (paper §2) **live** under
data changes: the engine maintains every covar view incrementally
(``core/ivm.py``), and each update batch triggers a closed-form re-solve
over the refreshed (p, p) sufficient statistics.  Refresh cost is the delta
scans plus one small host solve — proportional to the update, not the
database.

All covar queries are rooted at the fact table, so a fact-only
update touches *only* views scanned over the fact, and its delta program
scans just the delta tuples.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from repro_torch.api import Database, ExecutionConfig, connect
from repro_torch.data.relations import DeltaBatchUpdate
from repro_torch.ml import ridge
from repro_torch.ml.covar import assemble_covar, covar_queries


class OnlineRidge:
    """Ridge regression with incrementally maintained sufficient statistics.

        olr = OnlineRidge(ds)                      # on the card
        olr.fit()                                  # full scan once
        olr.update(DeltaBatchUpdate().insert(...)) # work ∝ |update|
        olr.theta, olr.rmse(rows)

    Pass ``database`` to reuse an open session (its config and device win),
    or ``config`` / ``device`` to open one."""

    def __init__(self, ds, lam: float = 1e-3,
                 cont: Optional[Sequence[str]] = None,
                 cat: Optional[Sequence[str]] = None,
                 backend: str = "cuda", block_size: int = 1 << 20,
                 config: Optional[ExecutionConfig] = None,
                 database: Optional[Database] = None, device="cuda"):
        self.ds = ds
        self.lam = lam
        qs, self.layout = covar_queries(ds, cont, cat)
        self.database = database or connect(ds, config=config or ExecutionConfig(
            backend=backend, block_size=block_size), device=device)
        self.view = self.database.views(qs, maintain=True,
                                        roots={q.name: ds.fact for q in qs},
                                        warm_rels=(ds.fact,))
        self.maintained = self.view.maintained
        self.theta: Optional[np.ndarray] = None
        self.C: Optional[np.ndarray] = None
        self.N = 0.0

    def fit(self, db=None) -> np.ndarray:
        """Materialize the covar batch (full scan of the session's tables,
        or of the relations ``db``) and solve.  Re-fitting rescans and
        publishes a fresh epoch."""
        self.maintained.init(db if db is not None else self.database.data)
        return self.refresh()

    def update(self, update: DeltaBatchUpdate) -> np.ndarray:
        """Fold an update batch into the maintained views and re-solve."""
        self.view.apply(update)
        return self.refresh()

    def update_fact(self, inserts: Optional[Mapping[str, np.ndarray]] = None,
                    delete_idx: Optional[np.ndarray] = None) -> np.ndarray:
        """An update touching only the fact table: ``inserts`` (attribute →
        column) and the fact rows ``delete_idx``; folds and re-solves."""
        upd = DeltaBatchUpdate()
        if inserts is not None:
            upd.insert(self.ds.fact, inserts)
        if delete_idx is not None:
            upd.delete(self.ds.fact, delete_idx)
        return self.update(upd)

    def refresh(self, outputs: Optional[Dict[str, np.ndarray]] = None) -> np.ndarray:
        """Re-solve from the current epoch's results, copied to the host,
        or from ``outputs`` already there."""
        if outputs is None:
            outputs = {k: v.cpu().numpy()
                       for k, v in self.maintained.results().items()}
        self.C, self.N = assemble_covar(outputs, self.layout)
        self.theta = ridge.closed_form(self.C, self.N, self.layout, self.lam)
        return self.theta

    def predict(self, rows: dict) -> np.ndarray:
        return ridge.predict(self.theta, self.layout, rows)

    def rmse(self, rows: dict) -> float:
        return ridge.rmse(self.theta, self.layout, rows)

"""Data cubes (paper §2, eq. (6)): 2^k group-by aggregates, v measures each;
counterpart of ``repro/ml/cubes.py``.

Three evaluation paths:
  * ``cube_via_engine`` — all 2^k subset queries as one LMFAO batch (the
    paper's path; view merging shares the per-edge count views across cells);
  * ``cube_rollup`` — beyond-paper: compute only the finest cell with the
    engine, then roll coarser cells up the lattice by marginalizing axes
    (classic Harinarayan-style reuse, exact for SUM measures);
  * ``StreamingCube`` — incremental mode: every cell stays live under
    insert/delete batches through maintained views (``core/ivm.py``),
    exact for the SUM measures the cube is built from.
Tests assert the paths agree.

All three thread the session's :class:`~repro_torch.api.ExecutionConfig`:
``backend``/``block_size``/``multi_root`` select the execution path, or an
open ``database`` session is reused (its config and device win).
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.api import Database, ExecutionConfig, connect
from repro_torch.core.aggregates import query, sum_of
from repro_torch.data.datasets import Dataset
from repro_torch.data.relations import DeltaBatchUpdate


def cube_name(subset: Sequence[str]) -> str:
    return "cube_" + ("_".join(subset) if subset else "ALL")


def cube_queries(dims: Sequence[str], measures: Sequence[str]):
    qs = []
    for r in range(len(dims) + 1):
        for subset in itertools.combinations(dims, r):
            qs.append(query(cube_name(subset), list(subset),
                            [sum_of(m) for m in measures]))
    return qs


def _session(ds: Dataset, database: Optional[Database],
             config: Optional[ExecutionConfig], multi_root: bool,
             block_size: int, backend: str, device) -> Database:
    if database is not None:
        return database
    return connect(ds, config=config or ExecutionConfig(
        multi_root=multi_root, block_size=block_size, backend=backend),
        device=device)


def _run(db: Database, qs) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy().astype(np.float64)
            for k, v in db.views(qs).run().items()}


def cube_via_engine(ds: Dataset, dims: Sequence[str], measures: Sequence[str],
                    multi_root: bool = True, block_size: int = 1 << 20,
                    backend: str = "cuda",
                    config: Optional[ExecutionConfig] = None,
                    database: Optional[Database] = None,
                    device="cuda") -> Dict[str, np.ndarray]:
    return _run(_session(ds, database, config, multi_root, block_size,
                         backend, device), cube_queries(dims, measures))


class StreamingCube:
    """All 2^k cube cells maintained incrementally under data changes.

        cube = StreamingCube(ds, dims, measures)   # full scan once
        cube.update(DeltaBatchUpdate().insert(...))
        cube.cells()[cube_name(("city",))]

    Queries are rooted at the fact table, so fact-only streams maintain every
    cell by scanning just the delta tuples."""

    def __init__(self, ds: Dataset, dims: Sequence[str], measures: Sequence[str],
                 backend: str = "cuda", block_size: int = 1 << 20,
                 config: Optional[ExecutionConfig] = None,
                 database: Optional[Database] = None, device="cuda"):
        qs = cube_queries(dims, measures)
        db = _session(ds, database, config, True, block_size, backend, device)
        self.view = db.views(qs, maintain=True,
                             roots={q.name: ds.fact for q in qs},
                             warm_rels=(ds.fact,))
        self.maintained = self.view.maintained
        self.view.run()                        # full scan -> epoch 0

    def update(self, update: DeltaBatchUpdate) -> Dict[str, np.ndarray]:
        self.view.apply(update)
        return self.cells()

    def cells(self) -> Dict[str, np.ndarray]:
        return {k: v.cpu().numpy().astype(np.float64)
                for k, v in self.view.results().items()}


def cube_rollup(ds: Dataset, dims: Sequence[str], measures: Sequence[str],
                block_size: int = 1 << 20, backend: str = "cuda",
                config: Optional[ExecutionConfig] = None,
                database: Optional[Database] = None,
                device="cuda") -> Dict[str, np.ndarray]:
    """Only the finest cell runs on the engine (the reference runs the
    whole cube batch and keeps its finest cell: the same numbers)."""
    name = cube_name(dims)
    db = _session(ds, database, config, True, block_size, backend, device)
    finest = _run(db, [query(name, list(dims),
                             [sum_of(m) for m in measures])])[name]
    out: Dict[str, np.ndarray] = {}
    for r in range(len(dims) + 1):
        for subset in itertools.combinations(dims, r):
            axes = tuple(i for i, d in enumerate(dims) if d not in subset)
            arr = finest.sum(axis=axes) if axes else finest
            # finest axes order == dims order; subset keeps relative order
            out[cube_name(subset)] = arr
    return out

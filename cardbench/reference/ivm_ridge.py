"""Plain reference of the maintained covar under a stream of fact updates.

It replays the run's ticks from the initial tables: each tick deletes its
positions from the fact as it stands (the survivors keep their order), then
appends its inserted rows, which are rows of the initial fact picked by
position.  The replay carries one index per live row into the initial fact,
so the updated fact is a gather.  It judges the program's maintained state
after the last tick two ways:

- ``rows_off``: values of the program's resident fact that differ from the
  replayed fact, row by row (an exact comparison);
- ``covar_err``: the maintained covar against the float64 ``XᵀX`` of the
  join with the replayed fact, as the covar job is judged.
"""

from __future__ import annotations

from typing import Dict

import torch

from cardbench.harness.traffic import fact_deltas
from cardbench.reference import covar


def replay(tables, ticks) -> Dict[str, torch.Tensor]:
    """The fact after ``ticks`` (each a dict with ``pick``, the inserted
    rows' positions in the initial fact, and ``dels``, the positions
    deleted)."""
    fact = tables.columns[tables.fact]
    src = torch.arange(tables.n_rows(tables.fact),
                       device=next(iter(fact.values())).device)
    for t in ticks:
        keep = torch.ones(src.shape[0], dtype=torch.bool, device=src.device)
        keep[t["dels"]] = False
        src = torch.cat([src[keep], t["pick"]])
    return {a: c[src] for a, c in fact.items()}


def judge(tables, record: dict) -> Dict[str, float]:
    """``record``: ``ticks`` applied in order, the final covar ``C`` and
    the program's ``resident`` fact columns."""
    final = replay(tables, record["ticks"])
    res = record["resident"]
    off = 0
    for a, want in final.items():
        got = res[a]
        if got.shape != want.shape:
            off += max(got.shape[0], want.shape[0])
        else:
            off += int((got != want).sum())
    G = covar.xtx(tables, final)
    return {"covar_err": covar.scaled_err(record["C"], G), "rows_off": float(off)}


def control(tables, traffic: dict, seed: int, units: int) -> dict:
    """The reference in bfloat16 put in the program's place over ``units``
    ticks of the mix, cycled from its pool as a run cycles them: the
    replayed fact (exact copies of rows) and its covar in bfloat16."""
    pool = fact_deltas(traffic, tables, seed)
    ticks = [pool[i % len(pool)] for i in range(units)]
    final = replay(tables, ticks)
    return {"ticks": ticks, "resident": final,
            "C": covar.xtx(tables, final, dtype=torch.bfloat16)}

"""A live ridge model: ``OnlineRidge`` over the covar batch, every query
rooted at the fact, fitted in set-up; each tick folds one delta of the pool
(cycled in order) and re-solves, to ``theta`` on the host."""

from __future__ import annotations

from repro_torch.data.relations import DeltaBatchUpdate
from repro_torch.ml.online import OnlineRidge
from torch.profiler import record_function

from cardbench.harness.traffic import fact_deltas

UNIT = "tick"


class Job:
    def __init__(self, db, ds, tables, traffic: dict, seed: int):
        fact = tables.columns[tables.fact]
        self.pool = fact_deltas(traffic, tables, seed)
        self.updates = [
            DeltaBatchUpdate()
            .insert(tables.fact, {a: c[d["pick"]].cpu().numpy() for a, c in fact.items()})
            .delete(tables.fact, d["dels"].cpu().numpy())
            for d in self.pool]
        self.fact = tables.fact
        self.olr = OnlineRidge(ds, database=db)
        self.olr.fit()
        self.applied = []

    def step(self) -> None:
        i = len(self.applied) % len(self.pool)
        with record_function("ivm.update"):
            self.olr.update(self.updates[i])
        self.applied.append(i)

    def info(self) -> dict:
        return {}

    def record(self) -> dict:
        rr = self.olr.maintained.epoch_state().relations[self.fact]
        return {"ticks": [self.pool[i] for i in self.applied],
                "C": self.olr.C, "resident": rr.columns()}

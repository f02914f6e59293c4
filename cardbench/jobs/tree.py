"""A regression tree fit as a user runs it: ``DecisionTree`` built once on
the session in set-up (its batch compiled); each job is one ``fit()``,
level by level, each level's statistics on the host."""

from __future__ import annotations

from repro_torch.ml.trees import DecisionTree
from torch.profiler import record_function

UNIT = "job"


class Job:
    def __init__(self, db, ds, tables, traffic: dict, seed: int):
        self.params = {k: traffic[k] for k in ("max_depth", "min_instances", "max_nodes")}
        self.dt = DecisionTree(ds, task=traffic["task"], database=db,
                               node_batch=traffic["node_batch"], **self.params)
        self.trees = []
        advance = self.dt.advance

        def recording(stats):           # each level's statistics, as fit() reads them
            self.trees[-1]["levels"].append(stats)
            with record_function("tree.advance"):
                advance(stats)

        self.dt.advance = recording

    def step(self) -> None:
        self.trees.append({"levels": []})
        self.dt.fit()
        self.trees[-1]["nodes"] = [
            dict(depth=n.depth, feature=n.feature, kind=n.kind,
                 threshold=n.threshold, left=n.left, right=n.right)
            for n in self.dt.nodes]

    def info(self) -> dict:
        last = self.trees[-1]
        return {"levels": len(last["levels"]),
                "frontier": [next(iter(s.values())).shape[0] for s in last["levels"]]}

    def record(self) -> dict:
        return {"params": self.params, "trees": self.trees}

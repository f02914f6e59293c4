"""The covar batch as a user runs it: the views registered once in set-up;
each job runs them, copies every output to the host and assembles the
covariance matrix."""

from __future__ import annotations

from repro_torch.ml.covar import assemble_covar, covar_queries
from torch.profiler import record_function

UNIT = "job"


class Job:
    def __init__(self, db, ds, tables, traffic: dict, seed: int):
        qs, self.layout = covar_queries(ds)
        self.view = db.views(qs)
        self.C = []

    def step(self) -> None:
        with record_function("covar.run"):
            out = self.view.run()
        with record_function("covar.to_host"):
            host = {k: v.cpu().numpy() for k, v in out.items()}
        with record_function("covar.assemble"):
            C, _ = assemble_covar(host, self.layout)
        self.C.append(C)

    def info(self) -> dict:
        return {}

    def record(self) -> dict:
        return {"C": self.C}

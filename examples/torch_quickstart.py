"""Quickstart on the PyTorch port: a batch of group-by aggregates over a
join, the LMFAO way; counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py              # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Builds a small Favorita-like database (6 relations, star schema — paper
Fig. 3), opens a session with ``repro_torch.connect``, declares a batch of
aggregate queries in the paper's Q(F; α) form, registers them as named
views and runs them; then the same queries maintained under a 64-row
insert.  The session's :class:`repro_torch.ExecutionConfig` is the one
place execution policy lives: the reference's ``backend="xla"`` is the
port's ``"torch"`` (its ``"pallas"`` is ``"cuda"``, the hand-written
kernels).  ``EXAMPLES_SCALE`` sets the data size and ``EXAMPLES_DEVICE``
the default device; ``main()`` returns the printed numbers.
"""

import argparse
import os

import numpy as np

import repro_torch
from repro_torch.core.aggregates import (COUNT, Delta, Var, agg, query,
                                         sum_of, sum_prod)
from repro_torch.data import DeltaBatchUpdate
from repro_torch.data import datasets as D

SCALE = float(os.environ.get("EXAMPLES_SCALE", "0.1"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=os.environ.get("EXAMPLES_DEVICE", "cuda"))
    device = ap.parse_args(argv).device

    ds = D.make("favorita", scale=SCALE)
    # one session: schema + join tree + resident relations + frozen config
    db = repro_torch.connect(ds, config=repro_torch.ExecutionConfig(
        backend="torch", block_size=4096), device=device)
    n_tuples = sum(db.sizes().values())
    print(f"database: {n_tuples:,} tuples across {len(ds.tables)} relations")

    queries = [
        # Q1: total units sold (paper Example 3.1 shape)
        query("total_units", [], [sum_of("units")]),
        # Q2: per-family oil-price-weighted sales (Example 3.2 shape)
        query("by_family", ["family"], [COUNT, sum_of("units"),
                                        sum_prod("units", "price")]),
        # Q3: covar-style entries (eq. 2-4)
        query("cm_units_txns", [], [sum_prod("units", "txns")]),
        query("cm_by_city", ["city"], [sum_of("units")]),
        query("cm_city_family", ["city", "family"], [COUNT]),
        # Q4: a decision-tree-node aggregate (eq. 8): promo items only
        query("rt_node", [], [agg(Delta("promo", "==", 1)),
                              agg(Var("units"), Delta("promo", "==", 1))]),
    ]

    views = db.views(queries)                 # compile once, names = queries
    print("registered views:", ", ".join(views.names))
    print(views.explain().summary())

    out = {k: v.cpu().numpy() for k, v in views.run().items()}
    res = {"tuples": n_tuples,
           "total_units": float(out["total_units"][0]),
           "families": out["by_family"].shape[0],
           "busiest_family_units": float(out["by_family"][:, 1].max()),
           "covar_units_txns": float(out["cm_units_txns"][0]),
           "promo_rows": float(out["rt_node"][..., 0]),
           "promo_units": float(out["rt_node"][..., 1])}
    print(f"total_units = {res['total_units']:,.0f}")
    print(f"by_family: {res['families']} families; "
          f"busiest family sold {res['busiest_family_units']:,.0f} units")
    print(f"covar(units, txns) = {res['covar_units_txns']:,.0f}")
    print(f"promo rows = {res['promo_rows']:,.0f}, "
          f"promo units = {res['promo_units']:,.0f}")

    # same queries, same session — but live under updates: maintain=True
    live = db.views(queries, maintain=True)
    live.run()                                # full scan -> epoch 0
    fact = ds.tables[ds.fact]
    pick = np.random.default_rng(0).integers(0, len(fact["units"]), 64)
    live.apply(DeltaBatchUpdate().insert(
        ds.fact, {a: np.asarray(c)[pick] for a, c in fact.items()}))
    res["epoch"] = live.maintained.epoch
    res["total_units_after_insert"] = float(live.results()["total_units"][0])
    res["inserted_units"] = float(np.asarray(fact["units"])[pick].sum())
    print(f"after one 64-row insert batch: epoch={res['epoch']}, "
          f"total_units = {res['total_units_after_insert']:,.0f}")
    print(live.explain().summary())
    return res


if __name__ == "__main__":
    main()

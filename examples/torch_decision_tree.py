"""CART decision trees over joins via dynamic aggregate batches (paper §2),
on the PyTorch port; counterpart of ``examples/decision_tree.py``.

    PYTHONPATH=src python examples/torch_decision_tree.py [--device cpu]

One compiled batch serves every node of the tree: node conditions are mask
parameters of dynamic UDAFs, and each level of the frontier is one pass.
``main()`` returns the printed numbers.
"""

import argparse
import os
import time

import numpy as np

import repro_torch
from repro_torch.core.plan import materialize_join
from repro_torch.data import datasets as D
from repro_torch.ml.trees import DecisionTree

SCALE = float(os.environ.get("EXAMPLES_SCALE", "0.2"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=os.environ.get("EXAMPLES_DEVICE", "cuda"))
    device = ap.parse_args(argv).device

    ds = D.make("favorita", scale=SCALE)
    t0 = time.time()
    dt = DecisionTree(ds, task="regression", max_depth=4, min_instances=100,
                      max_nodes=31, database=repro_torch.connect(ds, device=device)).fit()
    t = time.time() - t0
    print(f"regression tree: {len(dt.nodes)} nodes ({dt.n_split_nodes()} splits) "
          f"in {t:.1f}s — one compiled batch, {dt.n_aggregates} aggregates/node")

    J = materialize_join(ds.schema, ds.tables,
                         order=["Oil", "Transactions", "Stores", "Sales",
                                "Holiday", "Items"])
    y = np.asarray(J[ds.label], np.float64)
    pred = dt.predict(J)
    out = {"nodes": len(dt.nodes), "splits": dt.n_split_nodes(),
           "aggregates_per_node": dt.n_aggregates, "fit_s": t,
           "rmse": float(np.sqrt(np.mean((pred - y) ** 2))),
           "rmse_predict_mean": float(np.std(y))}
    print(f"rmse={out['rmse']:.4f} vs predict-mean={out['rmse_predict_mean']:.4f}")

    print("tree structure:")
    for node in dt.nodes:
        ind = "  " * node.depth
        if node.is_leaf:
            print(f"{ind}leaf n={node.n:,.0f} pred={node.prediction:.2f}")
        else:
            print(f"{ind}{node.feature} {'<=' if node.kind == 'ordered' else '=='} "
                  f"bucket {node.threshold}")

    # classification over TPC-DS (paper Table 5)
    ds2 = D.make("tpcds", scale=min(SCALE, 0.1))
    ct = DecisionTree(ds2, task="classification", label="c_preferred",
                      max_depth=3, min_instances=100, max_nodes=15,
                      database=repro_torch.connect(ds2, device=device)).fit()
    J2 = materialize_join(ds2.schema, ds2.tables,
                          order=["customer_demographics", "customer",
                                 "household_demographics", "customer_address",
                                 "store_sales", "date_dim", "time_dim", "item",
                                 "store", "promotion"])
    label = np.asarray(J2["c_preferred"])
    out["accuracy"] = float((ct.predict(J2).astype(int) == label).mean())
    out["majority"] = float(max(label.mean(), 1 - label.mean()))
    print(f"classification tree accuracy={out['accuracy']:.3f} "
          f"(majority={out['majority']:.3f})")
    return out


if __name__ == "__main__":
    main()

"""Ridge regression over a join without materializing it (paper §4.2), on
the PyTorch port; counterpart of ``examples/ridge_over_joins.py``.

    PYTHONPATH=src python examples/torch_ridge_over_joins.py [--device cpu]

Computes the covar-matrix batch with the engine (on the card by default),
trains by BGD with Armijo/Barzilai-Borwein over the (tiny) sufficient
statistics, cross-checks against the closed-form solution, and evaluates
RMSE on the materialized join.  ``main()`` returns the printed numbers.
"""

import argparse
import os
import time

import numpy as np

from repro_torch.core.plan import materialize_join
from repro_torch.data import datasets as D
from repro_torch.ml import ridge
from repro_torch.ml.covar import compute_covar

SCALE = float(os.environ.get("EXAMPLES_SCALE", "0.2"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=os.environ.get("EXAMPLES_DEVICE", "cuda"))
    device = ap.parse_args(argv).device

    ds = D.make("retailer", scale=SCALE)
    t0 = time.time()
    C, N, layout, batch = compute_covar(ds, device=device)
    t_agg = time.time() - t0
    print(f"covar: p={layout.p} features, N={N:,.0f} join rows, "
          f"{batch.stats.summary()}  [{t_agg:.2f}s]")

    t0 = time.time()
    res = ridge.bgd(C, N, layout, lam=1e-3)
    t_opt = time.time() - t0
    th_cf = ridge.closed_form(C, N, layout, lam=1e-3)
    print(f"BGD: {res.iterations} iters in {t_opt:.3f}s "
          f"(convergence is ~free next to the aggregates — the paper's point)")

    J = materialize_join(ds.schema, ds.tables,
                         order=["Census", "Location", "Weather", "Inventory",
                                "Items"])
    out = {"p": layout.p, "N": float(N), "bgd_iterations": res.iterations,
           "rmse_bgd": ridge.rmse(res.theta, layout, J),
           "rmse_closed_form": ridge.rmse(th_cf, layout, J),
           "rmse_predict_mean": float(np.std(np.asarray(J[ds.label]))),
           "covar_s": t_agg}
    print(f"rmse: bgd={out['rmse_bgd']:.4f} "
          f"closed-form={out['rmse_closed_form']:.4f} "
          f"predict-mean-baseline={out['rmse_predict_mean']:.4f}")
    return out


if __name__ == "__main__":
    main()

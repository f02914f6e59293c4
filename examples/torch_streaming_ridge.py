"""Streaming ridge regression: model refresh that scales with the update,
on the PyTorch port; counterpart of ``examples/streaming_ridge.py``.

    PYTHONPATH=src python examples/torch_streaming_ridge.py [--device cpu]

Fits ridge over the Favorita join once (full scan), then streams insert/
delete batches against the fact table.  Each tick folds the delta into the
maintained covar views (``core/ivm.py``) and re-solves the closed form —
compare the per-tick cost against recomputing the whole aggregate batch.
``main()`` returns the printed numbers.
"""

import argparse
import os
import time

import numpy as np

from repro_torch.data import datasets as D
from repro_torch.ml.online import OnlineRidge

SCALE = float(os.environ.get("EXAMPLES_SCALE", "0.2"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=os.environ.get("EXAMPLES_DEVICE", "cuda"))
    device = ap.parse_args(argv).device

    ds = D.make("favorita", scale=SCALE)
    olr = OnlineRidge(ds, device=device)

    t0 = time.time()
    olr.fit()
    t_fit = time.time() - t0
    mb = olr.maintained
    print(f"fit: N={olr.N:,.0f}, p={olr.layout.p} features, "
          f"{mb.batch.stats.summary()}  [{t_fit:.2f}s]")
    dp = mb.delta_program(ds.fact)
    print(f"delta program for {ds.fact}: {dp.summary()}")

    rng = np.random.default_rng(0)
    fact = ds.tables[ds.fact]
    n = len(fact[ds.label])
    k = max(n // 100, 1)          # 1% churn per tick

    out = {"N_fit": float(olr.N), "p": olr.layout.p, "tick_ms": [], "steps": []}
    for tick in range(5):
        t0 = time.time()
        pick = rng.integers(0, n, k)
        olr.update_fact(
            inserts={a: np.asarray(c)[pick] for a, c in fact.items()},
            delete_idx=rng.choice(n, k, replace=False))
        t_up = time.time() - t0
        drift = float(np.linalg.norm(olr.theta))
        out["tick_ms"].append(t_up * 1e3)
        out["steps"].append(mb.step)
        print(f"tick {tick}: {2 * k} delta tuples folded in {t_up * 1e3:.1f}ms "
              f"(‖θ‖={drift:.4f}, step={mb.step})")
    out["theta_norm"] = float(np.linalg.norm(olr.theta))
    out["N"] = float(olr.N)

    t0 = time.time()
    full = {q: v.cpu().numpy().astype(np.float64) for q, v in mb.batch(mb.db).items()}
    t_full = time.time() - t0
    got = {q: v.cpu().numpy().astype(np.float64) for q, v in mb.results().items()}
    worst = max(float(np.max(np.abs(got[q] - full[q]))
                      / max(np.max(np.abs(full[q])), 1.0)) for q in got)
    out["full_recompute_ms"] = t_full * 1e3
    out["maintained_vs_fresh_rel"] = worst
    print(f"full recompute for comparison: {t_full * 1e3:.1f}ms "
          f"(maintained vs fresh max rel err={worst:.2e})")

    # serving: pin an epoch, fold an update behind the pinned reader, and
    # show the snapshot stays frozen while fresh reads see the new epoch
    with mb.pinned() as epoch:
        pinned = mb.results(epoch=epoch)["cm_scalar"].cpu().numpy().copy()
        pick = rng.integers(0, n, k)
        olr.update_fact(
            inserts={a: np.asarray(c)[pick] for a, c in fact.items()},
            delete_idx=rng.choice(n, k, replace=False))
        drift = float(np.max(np.abs(
            mb.results()["cm_scalar"].cpu().numpy() - pinned)))
        frozen = bool(np.array_equal(
            pinned, mb.results(epoch=epoch)["cm_scalar"].cpu().numpy()))
        out.update(pinned_epoch=epoch, published_epoch=mb.epoch,
                   snapshot_frozen=frozen, current_drift=drift)
        print(f"epoch {epoch} pinned while epoch {mb.epoch} published: "
              f"snapshot frozen={frozen}, current drifted by {drift:.3g}")
    return out


if __name__ == "__main__":
    main()

"""Chow-Liu structure learning + data cubes from one engine (paper §2), on
the PyTorch port; counterpart of ``examples/chow_liu_cubes.py``.

    PYTHONPATH=src python examples/torch_chow_liu_cubes.py [--device cpu]

``main()`` returns the printed numbers.
"""

import argparse
import os
import time

import numpy as np

from repro_torch.data import datasets as D
from repro_torch.ml.chowliu import chow_liu
from repro_torch.ml.cubes import cube_name, cube_rollup, cube_via_engine

SCALE = float(os.environ.get("EXAMPLES_SCALE", "0.1"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=os.environ.get("EXAMPLES_DEVICE", "cuda"))
    device = ap.parse_args(argv).device

    ds = D.make("favorita", scale=SCALE)

    t0 = time.time()
    res = chow_liu(ds, attrs=["city", "state", "stype", "cluster", "family",
                              "htype", "locale"], device=device)
    print(f"chow-liu over {len(res.attrs)} attributes "
          f"({res.n_aggregates} count queries) in {time.time() - t0:.1f}s")
    print("learned tree edges (by mutual information):")
    edges = []
    for a, b in res.edges:
        i, j = res.attrs.index(a), res.attrs.index(b)
        edges.append((a, b, float(res.mi[i, j])))
        print(f"  {a} -- {b}   MI={res.mi[i, j]:.4f}")

    dims, meas = ["stype", "locale", "family"], ["units", "txns"]
    t0 = time.time()
    cube = cube_via_engine(ds, dims, meas, device=device)
    t_engine = time.time() - t0
    t0 = time.time()
    rolled = cube_rollup(ds, dims, meas, device=device)
    t_roll = time.time() - t0
    print(f"\n3-d data cube ({2 ** len(dims)} group-bys x {len(meas)} measures): "
          f"engine={t_engine:.2f}s lattice-rollup={t_roll:.2f}s")
    total = cube[cube_name([])]
    print(f"ALL cell: units={total[0]:,.0f} txns={total[1]:,.0f}")
    print(f"finest cell shape: {cube[cube_name(dims)].shape}")
    same = all(np.allclose(cube[k], rolled[k], rtol=1e-4, atol=1e-3) for k in cube)
    if not same:
        raise AssertionError("engine cube differs from the lattice rollup")
    print("engine path == lattice rollup ✓")
    return {"edges": edges, "n_aggregates": res.n_aggregates,
            "all_units": float(total[0]), "all_txns": float(total[1]),
            "finest_shape": tuple(cube[cube_name(dims)].shape),
            "cube_equals_rollup": same}


if __name__ == "__main__":
    main()

"""The port's batch workloads — Chow-Liu, data cubes, polynomial regression
and dataset statistics — against the reference on the CPU.

Both packages build their datasets from the same generators and seeds; the
port runs on CPU tensors (the kernels' plain versions), the reference on its
``xla`` backend.  Tolerances are the reference's own tests' for the same
workloads (tests/test_database_api.py, tests/test_ml.py).
"""

import numpy as np
import pytest

import repro
import repro_torch
from repro.data import datasets as JD
from repro.data import statistics as jstats
from repro.ml import chowliu as jcl
from repro.ml import cubes as jcubes
from repro.ml import polyreg as jpoly
from repro_torch.core.plan import materialize_join
from repro_torch.data import datasets as TD
from repro_torch.data import statistics as tstats
from repro_torch.kernels import ops
from repro_torch.ml import chowliu as tcl
from repro_torch.ml import cubes as tcubes
from repro_torch.ml import polyreg as tpoly

ORDERS = {"favorita": ["Oil", "Transactions", "Stores", "Sales", "Holiday",
                       "Items"],
          "retailer": ["Census", "Location", "Weather", "Inventory", "Items"]}
CL_ATTRS = ["city", "stype", "family", "htype", "locale"]


@pytest.fixture(scope="module")
def fav():
    ds = TD.make("favorita", scale=0.02)
    return ds, JD.make("favorita", scale=0.02), materialize_join(
        ds.schema, ds.tables, order=ORDERS["favorita"])


@pytest.mark.parametrize("multi_root", [True, False])
def test_chow_liu_matches_reference(fav, multi_root):
    ds, jds, _ = fav
    got = tcl.chow_liu(ds, attrs=CL_ATTRS, multi_root=multi_root,
                       block_size=512, device="cpu")
    want = jcl.chow_liu(jds, attrs=CL_ATTRS, multi_root=multi_root,
                        block_size=512)
    np.testing.assert_allclose(got.mi, want.mi, rtol=1e-6, atol=1e-8)
    assert got.edges == want.edges and got.attrs == want.attrs
    assert got.n_aggregates == want.n_aggregates == 1 + 5 + 10
    # the find-roots layer (or its single-root ablation) picks the
    # reference's roots
    qs = tcl.mi_queries(CL_ATTRS)
    roots = repro_torch.connect(ds, device="cpu", config=repro_torch.ExecutionConfig(
        multi_root=multi_root)).views(qs).stats.roots
    want_roots = repro.connect(jds, config=repro.ExecutionConfig(
        multi_root=multi_root)).views(jcl.mi_queries(CL_ATTRS)).stats.roots
    assert roots == want_roots
    assert (len(set(roots.values())) == 1) == (not multi_root)


def test_chow_liu_recovers_dependence(fav):
    ds, _, _ = fav
    res = tcl.chow_liu(ds, attrs=["city", "state", "htype"], device="cpu")
    i, j, k = (res.attrs.index(a) for a in ("city", "state", "htype"))
    assert res.mi[i, j] > res.mi[i, k]
    assert len(res.edges) == 2


def test_cubes_match_reference_and_oracle(fav):
    ds, jds, J = fav
    dims, meas = ["stype", "locale", "family"], ["units", "txns"]
    a = tcubes.cube_via_engine(ds, dims, meas, block_size=512, device="cpu")
    b = tcubes.cube_rollup(ds, dims, meas, block_size=512, device="cpu")
    ja = jcubes.cube_via_engine(jds, dims, meas)
    jb = jcubes.cube_rollup(jds, dims, meas)
    assert set(a) == set(b) == set(ja) == set(jb) and len(a) == 8
    for k in a:
        for other in (b, ja, jb):
            np.testing.assert_allclose(a[k], other[k], rtol=1e-4, atol=1e-3,
                                       err_msg=k)
    fin = np.zeros((5, 3, 33, 2))
    np.add.at(fin, (J["stype"], J["locale"], J["family"]),
              np.stack([J["units"], J["txns"]], -1))
    np.testing.assert_allclose(a[tcubes.cube_name(dims)], fin, rtol=1e-4,
                               atol=1e-2)
    np.testing.assert_allclose(a[tcubes.cube_name([])], fin.sum((0, 1, 2)),
                               rtol=1e-4)


def _design(J, layout):
    n = len(J[layout.label])
    X = np.stack([np.prod([np.asarray(J[a], np.float64) ** p for a, p in m],
                          axis=0) if m else np.ones(n)
                  for m in layout.features], axis=1)
    return X, np.asarray(J[layout.label], np.float64)


def test_polyreg_matches_reference_and_oracle(fav):
    ds, jds, J = fav
    attrs = ["txns", "price"]
    C, b, N, layout, batch = tpoly.compute_poly_covar(ds, 2, attrs,
                                                      device="cpu")
    Cr, br, Nr, layout_r, batch_r = jpoly.compute_poly_covar(jds, 2, attrs)
    assert layout.features == layout_r.features and N == Nr
    assert batch.result.stats.n_dedup_hits == batch_r.result.stats.n_dedup_hits > 0
    np.testing.assert_allclose(C, Cr, rtol=1e-5)
    np.testing.assert_allclose(b, br, rtol=1e-5)
    X, y = _design(J, layout)
    np.testing.assert_allclose(C, X.T @ X, rtol=1e-5)
    np.testing.assert_allclose(b, X.T @ y, rtol=1e-5)
    assert N == len(y)

    theta, layout2, _ = tpoly.fit_polyreg(ds, 2, attrs=attrs, device="cpu")
    theta_r, _, _ = jpoly.fit_polyreg(jds, 2, attrs=attrs)
    np.testing.assert_allclose(theta, theta_r, rtol=1e-3,
                               atol=1e-3 * np.abs(theta_r).max())
    rmse = np.sqrt(np.mean((tpoly.predict_poly(theta, layout2, J) - y) ** 2))
    rmse_r = np.sqrt(np.mean((jpoly.predict_poly(theta_r, layout2, J) - y) ** 2))
    assert abs(rmse / rmse_r - 1) < 1e-5 and rmse < np.std(y)
    assert len(tpoly.monomials(attrs, 2)) == 6


def test_polyreg_defaults_match_oracle():
    """Degree 2 over all eight Retailer features: 45 design columns, 540
    aggregates in one query, against the float64 design matrix."""
    ds = TD.make("retailer", scale=0.02)
    C, b, N, layout, batch = tpoly.compute_poly_covar(ds, device="cpu")
    assert len(layout.features) == 45 and batch.stats.n_app_aggregates == 540
    X, y = _design(materialize_join(ds.schema, ds.tables,
                                    order=ORDERS["retailer"]), layout)
    np.testing.assert_allclose(C, X.T @ X, rtol=1e-5)
    np.testing.assert_allclose(b, X.T @ y, rtol=1e-5)
    assert N == len(y)


def test_fit_polyreg_reuses_a_session(fav):
    ds, _, _ = fav
    db = repro_torch.connect(ds, device="cpu", config=repro_torch.ExecutionConfig(
        block_size=256, fuse_kernels=False))
    theta, _, batch = tpoly.fit_polyreg(ds, 2, attrs=["txns"], database=db)
    assert batch.config.block_size == 256 and not batch.config.fuse_kernels
    assert np.isfinite(theta).all()


def test_statistics_match_reference(fav):
    ds, jds, J = fav
    got = tstats.feature_moments(ds, attrs=["txns", "price"], device="cpu")
    want = jstats.feature_moments(jds, attrs=["txns", "price"])
    for a in ("txns", "price"):
        col = np.asarray(J[a], np.float64)
        assert got[a]["count"] == want[a]["count"] == len(col)
        np.testing.assert_allclose(got[a]["mean"], want[a]["mean"], rtol=1e-5)
        # var = E[x²] − mean² cancels: its float32 error scales with E[x²]
        second = want[a]["var"] + want[a]["mean"] ** 2
        assert abs(got[a]["var"] - want[a]["var"]) <= 1e-5 * second
        assert abs(got[a]["mean"] - col.mean()) < 1e-3 * max(1, abs(col.mean()))
        assert abs(got[a]["var"] - col.var()) < 1e-2 * max(1.0, col.var())
    ids = np.random.default_rng(0).integers(0, 8, 1000)
    load = tstats.expert_load_aggregate(ids, 8, device="cpu")
    np.testing.assert_array_equal(load, jstats.expert_load_aggregate(ids, 8))
    np.testing.assert_array_equal(load, np.bincount(ids, minlength=8))


def test_apps_reject_unknown_backend(fav):
    ds, _, _ = fav
    with pytest.raises(ValueError, match="backend"):
        tcubes.cube_via_engine(ds, ["promo"], ["units"], backend="xla",
                               device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tcl.chow_liu(ds, attrs=["city", "stype"], backend="pallas",
                     device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tpoly.compute_poly_covar(ds, attrs=["txns"], backend="xla",
                                 device="cpu")


def test_apps_run_plain_versions_on_the_cpu(fav):
    ds, _, _ = fav
    ops.reset_launches()
    tcl.chow_liu(ds, attrs=["city", "stype"], device="cpu")
    tcubes.cube_rollup(ds, ["promo"], ["units"], device="cpu")
    assert sum(ops.LAUNCHES.values()) == 0

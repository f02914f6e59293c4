"""The port's engine end to end against the reference on the CPU.

The same numpy tables go through ``repro`` (xla, and pallas in interpret
mode) and ``repro_torch`` (cuda backend; on CPU tensors its kernel wrappers
run the plain versions), fused and unfused.  Tolerance: rtol/atol 1e-4, the
reference's own between its backends (tests/test_backends.py): float32
sums taken in different orders.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import aggregates as J
from repro.core.schema import schema as jschema
from repro.data import datasets as JD
from repro.ml import covar as jcovar
from repro.ml import ridge as jridge
from repro_torch.core import aggregates as T
from repro_torch.core.plan import materialize_join
from repro_torch.core.schema import schema as tschema
from repro_torch.data import datasets as TD
from repro_torch.kernels import ops
from repro_torch.ml import covar as tcovar
from repro_torch.ml import ridge as tridge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
ORDER = ["Census", "Location", "Weather", "Inventory", "Items"]


def _assert_outputs_close(got, want):
    assert got.keys() == want.keys()
    for k in want:
        g = got[k].numpy()
        w = np.asarray(want[k])
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, err_msg=k, **TOL)


def _chain(mod):
    """The chain batch of tests/test_backends.py, built in either package."""
    return [mod.query("q_count", [], [mod.COUNT]),
            mod.query("q_sums", [], [mod.sum_of("u"), mod.agg(mod.Pow("u", 2))]),
            mod.query("q_g", ["x1", "x4"], [mod.COUNT, mod.sum_of("u")]),
            mod.query("q_delta", ["x4"],
                      [mod.agg(mod.Var("u"), mod.Delta("x1", "==", 1))])]


@pytest.mark.parametrize("fuse_kernels", [True, False])
def test_chain_batch_matches_reference_xla(fuse_kernels):
    spec = ([("x1", "categorical", 3), ("x2", "key", 4), ("x3", "key", 5),
             ("x4", "categorical", 3), ("u", "continuous", 0)],
            [("R1", ["x1", "x2"]), ("R2", ["x2", "x3", "u"]),
             ("R3", ["x3", "x4"])])
    rng = np.random.default_rng(3)
    tables = {"R1": {"x1": rng.integers(0, 3, 21), "x2": rng.integers(0, 4, 21)},
              "R2": {"x2": rng.integers(0, 4, 33), "x3": rng.integers(0, 5, 33),
                     "u": rng.normal(size=33).astype(np.float32)},
              "R3": {"x3": rng.integers(0, 5, 11), "x4": rng.integers(0, 3, 11)}}
    want = repro.connect(jschema(*spec), tables=tables,
                         config=repro.ExecutionConfig(block_size=16)).views(
        _chain(J)).run()
    got = repro_torch.connect(
        tschema(*spec), tables=tables, device="cpu",
        config=repro_torch.ExecutionConfig(block_size=16,
                                           fuse_kernels=fuse_kernels)).views(
        _chain(T)).run()
    _assert_outputs_close(got, want)


@pytest.fixture(scope="module")
def retailer():
    """Reference covar outputs (xla, pallas-interpret) on Retailer 0.02."""
    jds = JD.make("retailer", scale=0.02)
    qs, _ = jcovar.covar_queries(jds)
    want = {be: repro.connect(jds, config=repro.ExecutionConfig(backend=be))
            .views(qs).run() for be in ("xla", "pallas")}
    return TD.make("retailer", scale=0.02), want


@pytest.mark.parametrize("fuse_kernels,launches", [(True, 8), (False, 28)])
def test_retailer_covar_matches_reference(retailer, fuse_kernels, launches):
    ds, want = retailer
    qs, _ = tcovar.covar_queries(ds)
    # 256-row blocks: several blocks per relation, a ragged last block
    db = repro_torch.connect(ds, device="cpu", config=repro_torch.ExecutionConfig(
        block_size=256, fuse_kernels=fuse_kernels))
    handle = db.views(qs)
    got = handle.run()
    assert handle.stats.n_kernel_launches == launches
    assert handle.stats.n_scan_steps == 8 and handle.stats.n_views == 56
    for be in ("xla", "pallas"):
        _assert_outputs_close(got, want[be])


def test_ridge_over_port_covar_matches_reference(retailer):
    ds, want = retailer
    C, N, layout, _ = tcovar.compute_covar(ds, device="cpu")
    _, layout_r = jcovar.covar_queries(JD.make("retailer", scale=0.02))
    Cr, Nr = jcovar.assemble_covar(
        {k: np.asarray(v) for k, v in want["xla"].items()}, layout_r)
    assert N == Nr and layout.p == layout_r.p == 70
    np.testing.assert_allclose(C, Cr, rtol=1e-5, atol=1e-3)
    th, thr = tridge.closed_form(C, N, layout), jridge.closed_form(Cr, Nr, layout_r)
    # θ itself is ill-conditioned (one-hot blocks collinear with the
    # intercept, λ = 1e-3); the fit it gives is not
    J_rows = materialize_join(ds.schema, ds.tables, order=ORDER)
    r, rr = tridge.rmse(th, layout, J_rows), jridge.rmse(thr, layout_r, J_rows)
    assert abs(r / rr - 1) < 1e-5
    np.testing.assert_allclose(th, thr, rtol=1e-2, atol=1e-2 * np.abs(thr).max())
    b, br = tridge.bgd(C, N, layout), jridge.bgd(Cr, Nr, layout_r)
    assert abs(tridge.rmse(b.theta, layout, J_rows)
               / jridge.rmse(br.theta, layout_r, J_rows) - 1) < 1e-5


def test_connect_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: connect() would succeed")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.connect(TD.make("retailer", scale=0.02))


def test_port_imports_neither_jax_nor_the_reference(tmp_path):
    code = textwrap.dedent("""
        import sys
        import repro_torch
        from repro_torch.data import datasets
        from repro_torch.ml import covar, forest, ridge, trees
        ds = datasets.make("retailer", scale=0.02)
        C, N, layout, _ = covar.compute_covar(ds, device="cpu")
        ridge.closed_form(C, N, layout)
        db = repro_torch.connect(ds, device="cpu")
        dt = trees.DecisionTree(ds, max_depth=2, min_instances=50,
                                database=db).fit()
        assert dt.n_split_nodes() > 0
        from repro_torch.data import statistics
        from repro_torch.ml import chowliu, covar_fused, cubes, polyreg
        Cf, Nf, _ = covar_fused.compute_covar_fused(ds, database=db)
        assert Nf == N and abs(Cf - C).max() <= 1e-4 * abs(C).max()
        assert len(chowliu.chow_liu(ds, database=db).edges) == 7
        assert len(cubes.cube_rollup(ds, ["rain", "category"],
                                     ["inventoryunits"], database=db)) == 4
        polyreg.fit_polyreg(ds, attrs=["maxtemp", "prize"], database=db)
        statistics.feature_moments(ds, database=db)
        import numpy as np
        import torch
        from repro_torch import configs
        from repro_torch.models import model as M
        from repro_torch.models.layers import init_params
        from repro_torch.serve.engine import BatchedServer
        cfg = configs.get_smoke("internlm2-1.8b")
        gen = torch.Generator().manual_seed(0)
        params = init_params(M.model_specs(cfg), gen, cfg.torch_dtype, "cpu")
        toks = torch.randint(0, cfg.vocab, (2, 12), generator=gen)
        logits, _ = M.forward(params, {"tokens": toks}, cfg)
        assert tuple(logits.shape) == (2, 12, cfg.vocab)
        out = BatchedServer(cfg, params, max_len=12, batch=2, device="cpu"
                            ).generate(toks[:, :4].numpy(), 8)
        assert out.shape == (2, 12)
        from repro_torch import COUNT, query, sum_of
        from repro_torch.data.relations import DeltaBatchUpdate
        wide = query("wide", ["date", "locn", "sku"],
                     [COUNT, sum_of("inventoryunits"), sum_of("maxtemp")])
        sdb = repro_torch.connect(db.data, edges=ds.edges)   # same tables
        srv = sdb.views([wide], maintain=True).serve(max_pinned_epochs=4)
        tiers = [sdb.route(query(n, g, [COUNT])).tier
                 for n, g in (("q_locn", ["locn"]), ("q_rgn", ["rgn_cd"]))]
        assert tiers == ["subsumed", "compiled"], tiers
        fact = ds.tables[ds.fact]
        srv.apply(DeltaBatchUpdate().insert(ds.fact, {a: c[:5] for a, c in fact.items()}))
        with srv.snapshot() as snap:
            assert snap.epoch == 1 and snap["wide"].shape == (124, 40, 60, 3)
        Ct, Nt, _, bt = covar.compute_covar(
            ds, database=db.with_config(backend="torch"))
        assert Nt == N and bt.stats.n_kernel_launches == 0
        Ca, Na, _, ba = covar.compute_covar(
            ds, database=db.with_config(block_size="auto"))
        assert Na == N and ba.plan.last_autotune
        assert ba.plan.autotuner.n_timed > 0
        from repro_torch.core import distributed
        from repro_torch.launch import mesh
        assert distributed.GID_SENTINEL == 2**31 - 1
        assert callable(mesh.make_host_mesh)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print("N", N)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               REPRO_TORCH_AUTOTUNE_CACHE=str(tmp_path / "autotune.json"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "N 1200.0" in out.stdout
    assert (tmp_path / "autotune.json").exists()


def test_cpu_run_launches_no_kernel():
    ops.reset_launches()
    tcovar.compute_covar(TD.make("retailer", scale=0.02), device="cpu")
    assert sum(ops.LAUNCHES.values()) == 0

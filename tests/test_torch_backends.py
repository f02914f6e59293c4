"""The port's ``torch`` lowering backend against the reference, on the CPU.

The same numpy tables go through ``repro`` (the ``xla`` backend, its
``pallas`` backend in interpret mode for the param-batched node axis) and
``repro_torch`` (``backend="torch"``: the blocked scan reduced by
``index_add_``).  Tolerance: rtol/atol 1e-4, the reference's own between
its backends (tests/test_backends.py:36): float32 sums taken in different
orders.  The reference's ``xla`` frontier tree has a known failure
(ROADMAP Queue 3), so the node axis is held against ``pallas``.
"""

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import aggregates as J
from repro.core.schema import schema as jschema
from repro.data import datasets as JD
from repro.data import relations as JR
from repro.ml import covar as jcovar
from repro.ml import trees as jtrees
from repro_torch.core import aggregates as T
from repro_torch.core.schema import schema as tschema
from repro_torch.data import datasets as TD
from repro_torch.data import relations as TR
from repro_torch.kernels import ops
from repro_torch.ml import covar as tcovar
from repro_torch.ml import trees as ttrees

TOL = dict(rtol=1e-4, atol=1e-4)
SCALE = 0.02

# the chain schema of tests/test_backends.py
SPEC = ([("x1", "categorical", 3), ("x2", "key", 4), ("x3", "key", 5),
         ("x4", "categorical", 3), ("u", "continuous", 0)],
        [("R1", ["x1", "x2"]), ("R2", ["x2", "x3", "u"]), ("R3", ["x3", "x4"])])


def chain_tables(seed=3):
    rng = np.random.default_rng(seed)
    return {"R1": {"x1": rng.integers(0, 3, 21), "x2": rng.integers(0, 4, 21)},
            "R2": {"x2": rng.integers(0, 4, 33), "x3": rng.integers(0, 5, 33),
                   "u": rng.normal(size=33).astype(np.float32)},
            "R3": {"x3": rng.integers(0, 5, 11), "x4": rng.integers(0, 3, 11)}}


def chain_queries(mod):
    """The chain batch of tests/test_backends.py, in either package."""
    return [mod.query("q_count", [], [mod.COUNT]),
            mod.query("q_sums", [], [mod.sum_of("u"), mod.agg(mod.Pow("u", 2))]),
            mod.query("q_g", ["x1", "x4"], [mod.COUNT, mod.sum_of("u")]),
            mod.query("q_delta", ["x4"],
                      [mod.agg(mod.Var("u"), mod.Delta("x1", "==", 1))])]


def host(outputs):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in outputs.items()}


def assert_close(got, want):
    got, want = host(got), host(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def port(tables, **cfg):
    return repro_torch.connect(tschema(*SPEC), tables=tables, device="cpu",
                               config=repro_torch.ExecutionConfig(**cfg))


def ref(tables, **cfg):
    return repro.connect(jschema(*SPEC), tables=tables,
                         config=repro.ExecutionConfig(**cfg))


@pytest.mark.parametrize("fuse_scans", [True, False])
@pytest.mark.parametrize("block_size", [16, 1 << 20])
def test_torch_backend_matches_xla_chain_batch(fuse_scans, block_size):
    """Ragged 16-row blocks and one block, with and without shared-scan
    fusion: the same schedule as the reference's, the same results."""
    tables = chain_tables()
    v = port(tables, backend="torch", block_size=block_size,
             fuse_scans=fuse_scans).views(chain_queries(T))
    r = ref(tables, block_size=16, fuse_scans=fuse_scans).views(
        chain_queries(J))
    assert v.stats.n_kernel_launches == 0
    assert v.stats.n_scan_steps == r.stats.n_scan_steps
    assert ([(s.rel, s.gids) for s in v.schedule.steps]
            == [(s.rel, s.gids) for s in r.schedule.steps])
    ops.reset_launches()
    assert_close(v.run(), r.run())
    assert sum(ops.LAUNCHES.values()) == 0


def test_fuse_scans_off_matches_reference_on_both_backends():
    """``fuse_scans=False`` (the paper's Fig. 5 ablation) on Retailer's
    covar batch: one scan per view group in the port as in the reference,
    on the kernels' plain versions and on the torch backend alike."""
    jds = JD.make("retailer", scale=SCALE)
    qs, _ = jcovar.covar_queries(jds)
    r = repro.connect(jds, config=repro.ExecutionConfig(
        fuse_scans=False)).views(qs)
    want = r.run()
    ds = TD.make("retailer", scale=SCALE)
    tqs, _ = tcovar.covar_queries(ds)
    fused = repro_torch.connect(ds, device="cpu").views(tqs)
    for backend in ("cuda", "torch"):
        db = repro_torch.connect(ds, device="cpu",
                                 config=repro_torch.ExecutionConfig(
                                     backend=backend, fuse_scans=False))
        v = db.views(tqs)
        assert v.compiled.plan.config.fuse_scans is False
        assert v.stats.n_fused_scans == r.stats.n_fused_scans == 0
        assert v.stats.n_scan_steps == r.stats.n_scan_steps
        assert v.stats.n_scan_steps > fused.stats.n_scan_steps
        assert_close(v.run(), want)


def test_torch_backend_matches_xla_retailer_covar():
    jds = JD.make("retailer", scale=SCALE)
    want = jcovar.compute_covar(jds, backend="xla")
    ds = TD.make("retailer", scale=SCALE)
    db = repro_torch.connect(ds, device="cpu",
                             config=repro_torch.ExecutionConfig(
                                 backend="torch", block_size=256))
    got = tcovar.compute_covar(ds, database=db)
    assert got[1] == want[1]                        # N
    np.testing.assert_allclose(got[0], np.asarray(want[0]), **TOL)
    assert got[3].stats.n_kernel_launches == 0
    assert got[3].stats.n_scan_steps == want[3].stats.n_scan_steps


def _masks(features, n, seed):
    rng = np.random.default_rng(seed)
    return [{f.attr: (rng.random(f.domain) < 0.7).astype(np.float32)
             for f in features} for _ in range(n)]


def test_torch_run_batched_matches_reference_pallas():
    """The param-batch (node) axis: N = 3 random masks (padded to 4) in one
    pass, index_add_ behind the node axis, against the reference's pallas
    run_batched in interpret mode."""
    jds = JD.make("favorita", scale=SCALE)
    jdt = jtrees.DecisionTree(jds, max_depth=1, min_instances=10,
                              backend="pallas")
    masks = _masks(jdt.features, 3, seed=11)
    params = jtrees.stack_mask_params(jdt.features, masks)
    want = jdt.view.run_batched(params)
    ds = TD.make("favorita", scale=SCALE)
    db = repro_torch.connect(ds, device="cpu",
                             config=repro_torch.ExecutionConfig(
                                 backend="torch", block_size=256))
    dt = ttrees.DecisionTree(ds, max_depth=1, min_instances=10, database=db)
    assert dt.view.batched_params == jdt.view.batched_params
    got = dt.view.run_batched(params)
    assert all(v.shape[0] == 3 for v in got.values())
    assert_close(got, want)


def test_torch_tree_fit_equals_kernel_fit():
    """A frontier-batched fit on the torch backend grows the same tree as
    on the kernels' plain versions (held against the reference in
    tests/test_torch_trees.py)."""
    ds = TD.make("favorita", scale=SCALE)
    fits = {}
    for backend in ("cuda", "torch"):
        db = repro_torch.connect(ds, device="cpu",
                                 config=repro_torch.ExecutionConfig(
                                     backend=backend))
        fits[backend] = ttrees.DecisionTree(
            ds, max_depth=2, min_instances=50, database=db).fit()
    a, b = fits["cuda"].nodes, fits["torch"].nodes
    assert len(a) == len(b) > 1
    for g, w in zip(b, a):
        assert (g.feature, g.kind, g.threshold) == (w.feature, w.kind,
                                                     w.threshold)
        np.testing.assert_allclose(g.prediction, w.prediction, **TOL)


ROW_MAKERS = {
    "R1": lambda rng, k: {"x1": rng.integers(0, 3, k), "x2": rng.integers(0, 4, k)},
    "R2": lambda rng, k: {"x2": rng.integers(0, 4, k), "x3": rng.integers(0, 5, k),
                          "u": rng.normal(size=k).astype(np.float32)},
    "R3": lambda rng, k: {"x3": rng.integers(0, 5, k), "x4": rng.integers(0, 3, k)},
}


def _update(rel_mod, spec):
    upd = rel_mod.DeltaBatchUpdate()
    for rel, ins, dels in spec:
        if ins is not None:
            upd.insert(rel, ins)
        if dels is not None:
            upd.delete(rel, dels)
    return upd


@pytest.mark.parametrize("fuse_scans", [True, False])
def test_torch_maintained_view_matches_reference(fuse_scans):
    """A maintained view on the torch backend: weighted delta scans and
    rescans against the reference's after each apply, the same delta
    programs (with and without shared-scan fusion) and scan counts."""
    tables = chain_tables(seed=0)
    r = ref(tables, block_size=8, fuse_scans=fuse_scans).views(
        chain_queries(J), maintain=True)
    v = port(tables, backend="torch", block_size=8,
             fuse_scans=fuse_scans).views(chain_queries(T), maintain=True)
    assert_close(v.run(), r.run())
    rng = np.random.default_rng(7)
    specs = [[("R2", ROW_MAKERS["R2"](rng, 5), np.array([0, 7, 11]))],
             [("R1", ROW_MAKERS["R1"](rng, 4), None),
              ("R3", None, np.array([2, 5]))],
             [("R3", None, np.arange(9))]]
    for spec in specs:
        assert_close(v.apply(_update(TR, spec)), r.apply(_update(JR, spec)))
    mb, mr = v.maintained, r.maintained
    for rel in ("R1", "R2", "R3"):
        assert ([(s.rel, s.scans_delta) for s in mb.delta_program(rel).steps]
                == [(s.rel, s.scans_delta)
                    for s in mr.delta_program(rel).steps])
    assert mb.n_delta_scan_steps == mr.n_delta_scan_steps


def test_unknown_backend_is_rejected():
    with pytest.raises(ValueError, match="cuda.*torch"):
        repro_torch.ExecutionConfig(backend="xla")


def test_torch_run_step_offset_matches_xla():
    """``run_step``'s validity window ``[offset, offset + n_valid)`` (the
    reference's sharded scans): every step of the chain plan, R2's rows
    read from offset 3, against the reference's ``XlaBackend``."""
    from repro.core.lowering.xla import XlaBackend
    from repro.core.plan import PlanConfig as JPlanConfig
    from repro_torch.core.lowering.torch import TorchBackend
    from repro_torch.core.plan import PlanConfig

    tables = chain_tables(seed=9)
    tplan = port(tables).views(chain_queries(T)).compiled.plan
    jplan = ref(tables).views(chain_queries(J)).compiled.plan
    tcols = {r: rel.columns for r, rel in port(tables).data.relations.items()}
    jcols = {r: rel.columns for r, rel in ref(tables).data.relations.items()}
    tarr, jarr = {}, {}
    for step, tprog, jprog in zip(tplan.schedule.steps, tplan.step_programs,
                                  jplan.step_programs):
        n = len(next(iter(tables[step.rel].values())))
        off = 3 if step.rel == "R2" else 0
        TorchBackend().run_step(tprog, tcols[step.rel], tarr, {}, n_valid=n,
                                offset=off, config=PlanConfig(block_size=8))
        XlaBackend().run_step(jprog, jcols[step.rel], jarr, {}, n_valid=n,
                              offset=off, config=JPlanConfig(block_size=8))
    assert tarr.keys() == jarr.keys()
    for vid in jarr:
        np.testing.assert_allclose(tarr[vid].numpy(), np.asarray(jarr[vid]),
                                   err_msg=f"v{vid}", **TOL)
    full = {}
    for step, prog in zip(tplan.schedule.steps, tplan.step_programs):
        n = len(next(iter(tables[step.rel].values())))
        TorchBackend().run_step(prog, tcols[step.rel], full, {}, n_valid=n,
                                config=PlanConfig(block_size=8))
    assert any(not torch.equal(full[v], tarr[v]) for v in full)


@pytest.mark.parametrize("case", ["copies", "one_copy", "node_axis"])
def test_segment_sum_matches_reference_segment_sum(case, monkeypatch):
    """The backend's float32 segment sum (a copy of the segments per 4,096
    rows, then a sum over the copies) against the reference's
    ``jax.ops.segment_sum`` and a float64 sum, on 3 × 4,096 + 5 rows: in
    copies, in one copy where the copies' byte budget holds one, and
    behind a node axis."""
    import jax
    import jax.numpy as jnp

    from repro_torch.core.lowering import torch as LT

    if case == "one_copy":
        monkeypatch.setattr(LT, "MAX_COPIES_BYTES", 1)
    rng = np.random.default_rng(4)
    n, n_seg = 3 * LT.CHUNK_ROWS + 5, 7
    ids = rng.integers(0, n_seg, n)
    pay = rng.normal(1.0, 1.0, (2, n, 3) if case == "node_axis" else (n, 3)
                     ).astype(np.float32)
    axis = 1 if case == "node_axis" else 0
    got = LT.segment_sum(torch.from_numpy(ids), torch.from_numpy(pay), n_seg,
                         axis).numpy()
    want = np.zeros_like(np.moveaxis(pay, axis, 0)[:n_seg], dtype=np.float64)
    np.add.at(want, ids, np.moveaxis(pay, axis, 0).astype(np.float64))
    want = np.moveaxis(want, 0, axis)
    jsum = jax.ops.segment_sum(jnp.moveaxis(jnp.asarray(pay), axis, 0),
                               jnp.asarray(ids), num_segments=n_seg)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.moveaxis(np.asarray(jsum), 0, axis),
                               **TOL)

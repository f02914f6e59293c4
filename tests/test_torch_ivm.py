"""The port's maintained views against the reference's, on the CPU.

The same numpy tables and update batches go through ``repro`` (maintained
views on the ``xla`` backend) and ``repro_torch`` (the cuda backend; on CPU
tensors its kernel wrappers run the plain versions), fused and unfused;
data passes between the packages only as numpy.  Tolerances: the port's
maintained results against the reference's at rtol/atol 1e-4, the rule
between backends (tests/test_backends.py: float32 sums in different
orders); against the port's own fresh compile at 1e-3, the reference's
rule between maintained and fresh results (tests/test_ivm.py).
"""

import json
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
from repro.data import relations as JR
from repro.ml import cubes as jcubes
from repro.ml import online as jonline
from repro_torch.core import aggregates as T
from repro_torch.core.plan import materialize_join
from repro_torch.core.schema import schema as tschema
from repro_torch.data import datasets as TD
from repro_torch.data import relations as TR
from repro_torch.kernels import ops
from repro_torch.ml import cubes as tcubes
from repro_torch.ml import online as tonline
from repro_torch.ml import ridge as tridge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
FRESH_TOL = dict(rtol=1e-3, atol=1e-3)

# the chain schema, tables and row makers of tests/test_ivm.py
SPEC = ([("x1", "categorical", 3), ("x2", "key", 4), ("x3", "key", 5),
         ("x4", "categorical", 3), ("u", "continuous", 0)],
        [("R1", ["x1", "x2"]), ("R2", ["x2", "x3", "u"]), ("R3", ["x3", "x4"])])


def chain_db(seed=0, n1=17, n2=29, n3=13):
    rng = np.random.default_rng(seed)
    return {"R1": {"x1": rng.integers(0, 3, n1), "x2": rng.integers(0, 4, n1)},
            "R2": {"x2": rng.integers(0, 4, n2), "x3": rng.integers(0, 5, n2),
                   "u": rng.normal(size=n2).astype(np.float32)},
            "R3": {"x3": rng.integers(0, 5, n3), "x4": rng.integers(0, 3, n3)}}


ROW_MAKERS = {
    "R1": lambda rng, k: {"x1": rng.integers(0, 3, k), "x2": rng.integers(0, 4, k)},
    "R2": lambda rng, k: {"x2": rng.integers(0, 4, k), "x3": rng.integers(0, 5, k),
                          "u": rng.normal(size=k).astype(np.float32)},
    "R3": lambda rng, k: {"x3": rng.integers(0, 5, k), "x4": rng.integers(0, 3, k)},
}


def queries(mod):
    """The batch of tests/test_ivm.py, built in either package."""
    return [mod.query("q_count", [], [mod.COUNT]),
            mod.query("q_sums", [], [mod.sum_of("u"), mod.agg(mod.Pow("u", 2))]),
            mod.query("q_g1", ["x1"], [mod.COUNT, mod.sum_of("u")]),
            mod.query("q_g2", ["x1", "x4"], [mod.COUNT]),
            mod.query("q_delta", ["x4"],
                      [mod.agg(mod.Var("u"), mod.Delta("x1", "==", 1))])]


def make_update(rel_mod, spec):
    """One package's DeltaBatchUpdate from ``[(rel, inserts | None,
    delete idx | None), ...]`` of numpy arrays."""
    upd = rel_mod.DeltaBatchUpdate()
    for rel, ins, dels in spec:
        if ins is not None:
            upd.insert(rel, ins)
        if dels is not None:
            upd.delete(rel, dels)
    return upd


def port_session(tables, fuse_kernels=True, block_size=8):
    return repro_torch.connect(
        tschema(*SPEC), tables=tables, device="cpu",
        config=repro_torch.ExecutionConfig(block_size=block_size,
                                           fuse_kernels=fuse_kernels))


def ref_session(tables):
    return repro.connect(jschema(*SPEC), tables=tables,
                         config=repro.ExecutionConfig(block_size=8))


def host(outputs):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in outputs.items()}


def assert_close(got, want, tol):
    got, want = host(got), host(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def fresh_port(tdb, fuse_kernels=True):
    """The port's from-scratch results over a relations Database."""
    sess = repro_torch.connect(tdb, config=repro_torch.ExecutionConfig(
        block_size=8, fuse_kernels=fuse_kernels))
    return sess.views(queries(T)).run()


def sequence_specs():
    """tests/test_ivm.py's fixed sequence: inserts and deletes, two
    relations at once, R3 emptied and refilled."""
    rng = np.random.default_rng(3)
    return [
        [("R2", ROW_MAKERS["R2"](rng, 5), np.array([0, 7, 11]))],
        [("R1", ROW_MAKERS["R1"](rng, 4), None), ("R3", None, np.array([2, 5]))],
        [("R3", None, np.arange(11))],
        [("R3", ROW_MAKERS["R3"](rng, 6), None)],
    ]


@pytest.mark.parametrize("fuse_kernels", [True, False])
def test_ivm_sequence_matches_reference(fuse_kernels):
    tables = chain_db()
    ref = ref_session(tables).views(queries(J), maintain=True)
    port = port_session(tables, fuse_kernels).views(queries(T), maintain=True)
    assert_close(port.run(), ref.run(), TOL)
    tdb = port_session(tables).data
    ops.reset_launches()
    for spec in sequence_specs():
        want = ref.apply(make_update(JR, spec))
        upd = make_update(TR, spec)
        got = port.apply(upd)
        tdb = TR.apply_delta(tdb, upd)
        assert_close(got, want, TOL)
        assert_close(got, fresh_port(tdb, fuse_kernels), FRESH_TOL)
    mb = port.maintained
    assert mb.step == 4 and mb.n_delta_scan_steps > 0
    assert mb.n_delta_scan_steps == ref.maintained.n_delta_scan_steps
    assert sum(ops.LAUNCHES.values()) == 0      # CPU tensors: plain versions


def test_delta_program_structure():
    """The same steps, relations and vids as the reference's DeltaProgram,
    and cached."""
    tables = chain_db()
    ref = ref_session(tables).views(queries(J), maintain=True).maintained
    mb = port_session(tables).views(queries(T), maintain=True).maintained
    for rel in ("R1", "R2", "R3"):
        dp, dr = mb.delta_program(rel), ref.delta_program(rel)
        assert dp is mb.delta_program(rel)
        assert dp.affected == dr.affected and dp.state_vids == dr.state_vids
        assert dp.base_rels == dr.base_rels
        assert ([(s.rel, s.scans_delta, tuple(v.vid for v in s.prog.views))
                 for s in dp.steps]
                == [(s.rel, s.scans_delta, tuple(v.vid for v in s.prog.views))
                    for s in dr.steps])
        assert dp.summary() == dr.summary()
        tp, tr = mb.tick_program(rel), ref.tick_program(rel)
        assert tp.fold_vids == tr.fold_vids and tp.summary() == tr.summary()
    dp = mb.delta_program("R2")
    assert any(s.scans_delta for s in dp.steps)
    assert all(s.rel == "R2" for s in dp.steps if s.scans_delta)
    assert set(dp.affected) <= set(dp.state_vids) <= set(mb.plan.views)


ADVANCE_CASES = {
    # (rows, deletes, inserts)
    "both_ends": (11, [0, 4, 10], 2),
    "growth_past_pow2": (11, [0, 10], 9),
    "delete_all": (5, [0, 1, 2, 3, 4], 0),
    "into_empty": (0, [], 3),
    "no_delete": (16, [], 1),
}


@pytest.mark.parametrize("case", sorted(ADVANCE_CASES))
def test_resident_advance_matches_reference_apply_delta(case):
    """ResidentRelation.advance, with padded inserts and deletes padded at
    the capacity, row for row against the reference's apply_delta."""
    n, dels, n_ins = ADVANCE_CASES[case]
    spec = ([("a", "categorical", 9), ("u", "continuous", 0)], [("T", ["a", "u"])])
    rng = np.random.default_rng(n + n_ins)
    cols = {"a": rng.integers(0, 9, n).astype(np.int32),
            "u": rng.normal(size=n).astype(np.float32)}
    ins = {"a": rng.integers(0, 9, n_ins).astype(np.int32),
           "u": rng.normal(size=n_ins).astype(np.float32)}
    upd = JR.DeltaBatchUpdate()
    if dels:
        upd.delete("T", np.array(dels))
    if n_ins:
        upd.insert("T", ins)
    want = JR.apply_delta(JR.from_numpy(jschema(*spec), {"T": cols}), upd)
    rr = TR.ResidentRelation.from_relation(
        TR.Relation("T", {a: torch.from_numpy(c) for a, c in cols.items()}))
    ins_pad = TR.next_pow2(n_ins) if n_ins else 0
    del_pad = TR.next_pow2(len(dels)) if dels else 0
    got = rr.advance(
        {a: torch.from_numpy(np.pad(c, (0, ins_pad - n_ins))) for a, c in ins.items()},
        torch.from_numpy(np.pad(np.array(dels, np.int64), (0, del_pad - len(dels)),
                                constant_values=rr.capacity)),
        n_ins, len(dels))
    n_new = n - len(dels) + n_ins
    assert got.n_valid == n_new
    assert got.capacity == max(rr.capacity, TR.next_pow2(max(n_new, 1)))
    for a in cols:
        np.testing.assert_array_equal(got.to_relation().columns[a].numpy(),
                                      np.asarray(want.relation("T").columns[a]))
    # the input buffers are untouched (an epoch keeps them)
    for a in cols:
        np.testing.assert_array_equal(rr.columns()[a].numpy(), cols[a])


def _fact_updates(tables, fact, seed, n_ticks, frac=0.01):
    """benchmarks/bench_ivm.py's _fact_update: ``frac`` of the fact rows
    inserted (drawn with replacement) and as many distinct rows deleted."""
    rng = np.random.default_rng(seed)
    cols = tables[fact]
    n = len(next(iter(cols.values())))
    k = max(int(n * frac), 1)
    out = []
    for _ in range(n_ticks):
        pick = rng.integers(0, n, k)
        out.append([(fact, {a: np.asarray(c)[pick] for a, c in cols.items()},
                     rng.choice(n, k, replace=False))])
    return out


@pytest.fixture(scope="module")
def retailer():
    return JD.make("retailer", scale=0.02), TD.make("retailer", scale=0.02)


def test_online_ridge_matches_reference(retailer):
    """OnlineRidge over three 1% fact updates at Retailer 0.02: N exact and
    C at 1e-4 against the reference's; fact updates maintain delta-only.
    θ is ill-conditioned (one-hot blocks collinear with the intercept,
    cond(C) about 1e28, λ = 1e-3): the two packages' batch fits differ by
    3.37e-3 in relative L2, and the same solve of the reference's C gives
    the reference's θ, so the whole gap is C's float32 summation order.
    θ is held just above that reading, at 5e-3, and by the fit it gives:
    training RMSE over the post-update join within 1e-5."""
    jds, tds = retailer
    ref = jonline.OnlineRidge(jds)
    ref.fit()
    olr = tonline.OnlineRidge(tds, device="cpu")
    olr.fit()
    dp = olr.maintained.delta_program(tds.fact)
    assert dp.steps and all(s.scans_delta for s in dp.steps)

    def theta_gap():
        return (np.linalg.norm(olr.theta - ref.theta)
                / np.linalg.norm(ref.theta))

    assert theta_gap() <= 5e-3                      # the batch fits
    for spec in _fact_updates(tds.tables, tds.fact, seed=9, n_ticks=3):
        ref.update(make_update(JR, spec))
        olr.update(make_update(TR, spec))
        assert olr.N == ref.N
        np.testing.assert_allclose(olr.C, ref.C, **TOL)
        assert theta_gap() <= 5e-3
        np.testing.assert_allclose(
            tridge.closed_form(ref.C, ref.N, olr.layout, olr.lam), ref.theta,
            rtol=1e-12, atol=0)
    db = olr.maintained.db
    assert db.sizes()[tds.fact] == 1200
    rows = materialize_join(tds.schema, {n: {a: c.numpy() for a, c in r.columns.items()}
                                         for n, r in db.relations.items()},
                            order=["Census", "Location", "Weather", "Inventory", "Items"])
    assert abs(tridge.rmse(olr.theta, olr.layout, rows)
               / tridge.rmse(ref.theta, olr.layout, rows) - 1) < 1e-5


def test_streaming_cube_matches_reference(retailer):
    jds, tds = retailer
    dims, measures = ["rain", "rgn_cd", "category"], ["inventoryunits", "maxtemp"]
    ref = jcubes.StreamingCube(jds, dims, measures)
    cube = tcubes.StreamingCube(tds, dims, measures, device="cpu")
    for spec in _fact_updates(tds.tables, tds.fact, seed=2, n_ticks=2):
        want = ref.update(make_update(JR, spec))
        got = cube.update(make_update(TR, spec))
        assert_close(got, want, TOL)


def _manifest(path):
    step = sorted(d for d in os.listdir(path) if d.startswith("step_"))[-1]
    with open(os.path.join(path, step, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("saver", ["reference", "port"])
def test_snapshots_restore_across_packages(saver, tmp_path):
    """A snapshot written by one package restores in the other with equal
    results, bitwise; saved again, it gives the same manifest (leaf names,
    shapes, dtypes, sha)."""
    tables = chain_db()
    spec = [("R2", ROW_MAKERS["R2"](np.random.default_rng(5), 3), None),
            ("R1", None, np.array([1]))]
    handles = {"reference": ref_session(tables).views(queries(J), maintain=True),
               "port": port_session(tables).views(queries(T), maintain=True)}
    mods = {"reference": JR, "port": TR}
    loader = "port" if saver == "reference" else "reference"
    src = handles[saver]
    src.run()
    src.apply(make_update(mods[saver], spec))
    src.snapshot(str(tmp_path / "a"))
    dst = handles[loader]
    assert dst.restore(str(tmp_path / "a")) == 1
    assert dst.maintained.step == 1
    want, got = host(src.results()), host(dst.results())
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    dst.snapshot(str(tmp_path / "b"))
    assert _manifest(tmp_path / "b") == _manifest(tmp_path / "a")
    # the restored state keeps maintaining: one more update, both packages
    more = [("R3", ROW_MAKERS["R3"](np.random.default_rng(6), 4), None)]
    assert_close(dst.apply(make_update(mods[loader], more)),
                 src.apply(make_update(mods[saver], more)), TOL)


def test_rejected_batch_is_clean_noop():
    """A batch whose second relation (sorted order) is invalid leaves
    results, epoch and stored relations untouched."""
    tables = chain_db()
    h = port_session(tables).views(queries(T), maintain=True)
    mb = h.maintained
    before = host(h.run())
    epoch0, step0 = mb.epoch, mb.step
    rng = np.random.default_rng(0)
    bad = (TR.DeltaBatchUpdate()
           .insert("R1", ROW_MAKERS["R1"](rng, 4))
           .insert("R3", {"x3": np.array([0]), "x4": np.array([99])}))
    with pytest.raises(ValueError, match="outside"):
        mb.apply(bad)
    assert (mb.epoch, mb.step) == (epoch0, step0)
    after = host(mb.results())
    for k in before:
        np.testing.assert_array_equal(before[k], after[k], err_msg=k)
    good = TR.DeltaBatchUpdate().insert("R1", ROW_MAKERS["R1"](rng, 2))
    tdb = TR.apply_delta(port_session(tables).data, good)
    assert_close(mb.apply(good), fresh_port(tdb), FRESH_TOL)
    with pytest.raises(ValueError, match="outside"):
        mb.apply(TR.DeltaBatchUpdate().insert("R1", ROW_MAKERS["R1"](rng, 1))
                 .delete("R3", np.array([999])))
    assert mb.step == step0 + 1


def test_pinned_epoch_frozen_across_apply():
    """A reader pinned to epoch e sees bitwise the same results, and the
    same relation buffers, after an apply publishes e+1."""
    tables = chain_db()
    h = port_session(tables).views(queries(T), maintain=True)
    mb = h.maintained
    h.run()
    rng = np.random.default_rng(7)
    with mb.pinned() as e:
        before = {k: v.clone() for k, v in mb.results(epoch=e).items()}
        bufs = {name: {a: c.clone() for a, c in rr.buffers.items()}
                for name, rr in mb.epoch_state(e).relations.items()}
        upd = (TR.DeltaBatchUpdate().insert("R2", ROW_MAKERS["R2"](rng, 4))
               .delete("R2", np.array([0, 2])).delete("R1", np.array([0, 2])))
        mb.apply(upd)
        assert mb.epoch == e + 1
        for k, v in mb.results(epoch=e).items():
            assert torch.equal(v, before[k]), k
        for name, rr in mb.epoch_state(e).relations.items():
            for a, c in rr.buffers.items():
                assert torch.equal(c, bufs[name][a]), (name, a)
        tdb = TR.apply_delta(port_session(tables).data, upd)
        assert_close(mb.results(), fresh_port(tdb), FRESH_TOL)
    with pytest.raises(KeyError, match="pinned"):
        mb.results(epoch=e)


def test_pin_budget_evicts_the_least_recently_used_epoch():
    """With max_pinned_epochs = 2, a third pin force-releases the coldest
    pinned epoch: its reads raise EpochEvictedError and its unpin is a
    no-op; the others stay readable."""
    from repro_torch.core.ivm import EpochEvictedError

    h = port_session(chain_db()).views(queries(T), maintain=True)
    mb = h.maintained
    mb.max_pinned_epochs = 2
    h.run()
    rng = np.random.default_rng(11)
    pins = []
    for _ in range(3):
        pins.append(mb.pin())
        mb.apply(TR.DeltaBatchUpdate().insert("R1", ROW_MAKERS["R1"](rng, 2)))
    assert pins == [0, 1, 2] and mb.n_pinned_epochs == 2 and mb.n_evicted_pins == 1
    with pytest.raises(EpochEvictedError, match="evicted"):
        mb.results(epoch=0)
    mb.unpin(0)
    for e in pins[1:]:
        assert set(mb.results(epoch=e)) == {q.name for q in queries(T)}
        mb.unpin(e)
    assert mb.n_pinned_epochs == 0
    with pytest.raises(KeyError, match="not pinned"):
        mb.unpin(1)


def test_sort_by_matches_reference():
    S = chain_db()
    got = TR.sort_by(TR.from_numpy(tschema(*SPEC), S, "cpu").relation("R2"), ["x3", "x2"])
    want = JR.sort_by(JR.from_numpy(jschema(*SPEC), S).relation("R2"), ["x3", "x2"])
    for a, c in want.columns.items():
        np.testing.assert_array_equal(got.columns[a].numpy(), np.asarray(c), err_msg=a)


def test_steady_state_builds_no_runner():
    """Four equal-shape ticks after a warm one build no tick runner."""
    tables = chain_db()
    h = port_session(tables).views(queries(T), maintain=True)
    mb = h.maintained
    h.run()
    rng = np.random.default_rng(13)
    tdb = port_session(tables).data

    def tick():
        return (TR.DeltaBatchUpdate().insert("R2", ROW_MAKERS["R2"](rng, 3))
                .delete("R2", rng.choice(29, 3, replace=False)))

    for _ in range(5):
        if _ == 1:
            builds = mb.n_fold_traces
        upd = tick()
        mb.apply(upd)
        tdb = TR.apply_delta(tdb, upd)
    assert builds == 1 and mb.n_fold_traces == builds
    assert len(mb._runners) == 1
    assert_close(mb.results(), fresh_port(tdb), FRESH_TOL)


def test_non_invertible_aggregate_rejected():
    tables = chain_db()
    sess = port_session(tables)
    qs = [T.query("q_softmax_max", [], [T.agg(T.Lambda(
        ("u",), lambda u, p: u, tag="running_max", invertible=False))])]
    with pytest.raises(ValueError, match="not invertible"):
        sess.views(qs, maintain=True)
    sess.views(qs)                                    # batch path: fine
    sess.views(queries(T), maintain=True)             # SUM-like: fine


def test_maintained_handle_api():
    """run() publishes epoch 0 then reads it; params are refused after;
    batch handles refuse apply; apply initializes if run() has not."""
    tables = chain_db()
    sess = port_session(tables)
    h = sess.views(queries(T), maintain=True)
    assert h.is_maintained and not sess.views(queries(T)).is_maintained
    with pytest.raises(ValueError, match="maintain=True"):
        sess.views(queries(T)).apply(TR.DeltaBatchUpdate())
    with pytest.raises(ValueError, match="param-batch"):
        h.run_batched({})
    with pytest.raises(ValueError, match="init"):
        h.maintained.apply(TR.DeltaBatchUpdate())
    first = host(h.run())
    assert h.maintained.epoch == 0
    assert_close(h.run(), first, dict(rtol=0, atol=0))
    with pytest.raises(ValueError, match="full scan"):
        h.run(params={"x": 1.0})
    v = sess.view(queries(T)[0], maintain=True)
    upd = TR.DeltaBatchUpdate().insert("R1", ROW_MAKERS["R1"](np.random.default_rng(1), 2))
    out = v.apply(upd)
    assert v.maintained.step == 1 and set(out) == {"q_count"}


def test_append_delete_validation():
    S = tschema(*SPEC)
    db = TR.from_numpy(S, chain_db(), "cpu")
    r1 = db.relation("R1")
    assert r1.append({"x1": np.array([1]), "x2": np.array([2])}, S).n_rows == 18
    assert r1.delete_rows(np.array([0, 3])).n_rows == 15
    with pytest.raises(ValueError, match="outside"):
        r1.append({"x1": np.array([99]), "x2": np.array([0])}, S)
    with pytest.raises(ValueError, match="integer"):
        r1.append({"x1": np.array([0.5]), "x2": np.array([0])}, S)
    with pytest.raises(ValueError, match="columns"):
        r1.append({"x1": np.array([0])}, S)
    with pytest.raises(ValueError, match="shape"):
        r1.append({"x1": np.array([0, 1]), "x2": np.array([0])}, S)
    with pytest.raises(ValueError, match="dtype"):
        r1.append({"x1": np.array([0.5]), "x2": np.array([0])})
    with pytest.raises(ValueError, match="schema"):
        r1.append({"x1": np.array([1]), "x2": np.array([2])})
    with pytest.raises(ValueError, match="duplicate"):
        r1.delete_rows(np.array([1, 1]))
    with pytest.raises(ValueError, match="outside"):
        r1.delete_rows(np.array([99]))
    r2 = db.relation("R2")
    assert r2.append({"x2": np.array([1]), "x3": np.array([2]),
                      "u": np.array([0.5])}, S).columns["u"].dtype == torch.float32


def test_delta_batch_update_validation():
    db = TR.from_numpy(tschema(*SPEC), chain_db(), "cpu")
    with pytest.raises(ValueError, match="unknown relation"):
        TR.apply_delta(db, TR.DeltaBatchUpdate().insert(
            "Nope", {"x1": np.array([0])}))
    with pytest.raises(ValueError, match="outside"):
        TR.apply_delta(db, TR.DeltaBatchUpdate().delete("R1", np.array([99])))
    with pytest.raises(ValueError, match="already has inserts"):
        TR.DeltaBatchUpdate().insert("R1", {}).insert("R1", {})


def test_maintained_path_imports_neither_jax_nor_the_reference(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        from repro_torch.data import datasets
        from repro_torch.data.relations import DeltaBatchUpdate
        from repro_torch.ml.online import OnlineRidge
        ds = datasets.make("retailer", scale=0.02)
        olr = OnlineRidge(ds, device="cpu")
        olr.fit()
        fact = ds.tables[ds.fact]
        rng = np.random.default_rng(0)
        pick = rng.integers(0, 1200, 12)
        olr.update(DeltaBatchUpdate()
                   .insert(ds.fact, {{a: c[pick] for a, c in fact.items()}})
                   .delete(ds.fact, rng.choice(1200, 12, replace=False)))
        olr.view.snapshot({str(tmp_path)!r})
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        print("N", olr.N)
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "N 1200.0" in out.stdout

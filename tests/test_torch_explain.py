"""The port's unified ``explain()`` report, the rest of the session API and
IVM's verifier hooks, against the reference on the CPU.

The same numpy tables, queries and update batches go through ``repro``
and ``repro_torch``; what is compared is host bookkeeping (modes,
counters, schedules, rule ids and check counts), so it must be equal, not
close.  Results, where compared, hold at rtol/atol 1e-4, the reference's
rule between its backends (tests/test_backends.py:36).
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.analysis import verify as JV
from repro.core import aggregates as J
from repro.core import ivm as JI
from repro.core.schema import schema as jschema
from repro.data import relations as JR
from repro_torch.analysis import verify as TV
from repro_torch.core import aggregates as T
from repro_torch.core import ivm as TI
from repro_torch.core.schema import schema as tschema
from repro_torch.data import relations as TR

TOL = dict(rtol=1e-4, atol=1e-4)

# the chain schema, tables and queries of tests/test_database_api.py and
# tests/test_analysis.py
SPEC = ([("x1", "categorical", 3), ("x2", "key", 4), ("x3", "key", 5),
         ("x4", "categorical", 3), ("u", "continuous", 0)],
        [("R1", ["x1", "x2"]), ("R2", ["x2", "x3", "u"]), ("R3", ["x3", "x4"])])


def make_tables(seed=0, n1=17, n2=29, n3=13):
    rng = np.random.default_rng(seed)
    return {"R1": {"x1": rng.integers(0, 3, n1), "x2": rng.integers(0, 4, n1)},
            "R2": {"x2": rng.integers(0, 4, n2), "x3": rng.integers(0, 5, n2),
                   "u": rng.normal(size=n2).astype(np.float32)},
            "R3": {"x3": rng.integers(0, 5, n3), "x4": rng.integers(0, 3, n3)}}


def api_queries(m):
    """tests/test_database_api.py's QUERIES."""
    return [m.query("q_count", [], [m.COUNT]),
            m.query("q_g1", ["x1"], [m.COUNT, m.sum_of("u")]),
            m.query("q_delta", ["x4"], [m.agg(m.Var("u"), m.Delta("x1", "==", 1))])]


def analysis_queries(m):
    """tests/test_analysis.py's QUERIES."""
    return [m.query("q_count", [], [m.COUNT]),
            m.query("q_sums", [], [m.sum_of("u"), m.agg(m.Pow("u", 2))]),
            m.query("q_g1", ["x1"], [m.COUNT, m.sum_of("u")]),
            m.query("q_g2", ["x1", "x4"], [m.COUNT]),
            m.query("q_delta", ["x4"], [m.agg(m.Var("u"), m.Delta("x1", "==", 1))])]


def sessions(backend="cuda", **cfg):
    """(port, reference) sessions over the same tables; the reference's on
    its default ``xla`` backend."""
    tcfg = repro_torch.ExecutionConfig(block_size=8, backend=backend, **cfg)
    jcfg = repro.ExecutionConfig(block_size=8, **cfg)
    return (repro_torch.connect(tschema(*SPEC), tables=make_tables(),
                                device="cpu", config=tcfg),
            repro.connect(jschema(*SPEC), tables=make_tables(), config=jcfg))


def host(out):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in out.items()}


def assert_close(got, want):
    got, want = host(got), host(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


REPORT_FIELDS = ("mode", "backend", "n_dispatches", "epoch", "step",
                 "n_delta_scan_steps", "n_fold_traces", "n_pinned_epochs",
                 "n_evicted_pins", "max_pinned_epochs", "verification")
SERVING_KEYS = ("epoch", "step", "n_reads", "n_updates", "n_rejected_updates",
                "n_pinned_epochs", "n_evicted_pins", "max_pinned_epochs",
                "n_delta_scan_steps", "epoch_lag", "n_lag_warnings")


def assert_same_report(got, want):
    """Equal but for the backend's name: the port's ``torch`` against the
    reference's ``xla``, both without hand-written kernels (0 launches);
    the tick reports whole, mesh checks included."""
    for f in REPORT_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if f == "backend":
            assert (g, w) == ("torch", "xla")
        else:
            assert g == w, f
    assert dataclasses.asdict(got.batch) == dataclasses.asdict(want.batch)
    assert (got.serving is None) == (want.serving is None)
    if want.serving is not None:
        assert ({k: got.serving[k] for k in SERVING_KEYS}
                == {k: want.serving[k] for k in SERVING_KEYS})


def test_explain_unified_report_matches_reference():
    """tests/test_database_api.py:328 in both packages, report for report:
    batch, maintained after an apply, served after a read."""
    ts, js = sessions(backend="torch")
    v, r = ts.views(api_queries(T)), js.views(api_queries(J))
    assert_same_report(v.explain(), r.explain())
    assert v.explain().mode == "batch" and v.explain().n_dispatches == 0
    v.run()
    r.run()
    assert_same_report(v.explain(), r.explain())
    assert v.explain().n_dispatches == 1
    assert "scans=" in v.explain().summary()
    assert isinstance(v.explain(), repro_torch.ViewReport)

    live, jlive = (ts.views(api_queries(T), maintain=True),
                   js.views(api_queries(J), maintain=True))
    assert_same_report(live.explain(), jlive.explain())     # before init
    live.run()
    jlive.run()
    live.apply(TR.DeltaBatchUpdate().delete("R1", np.array([2])))
    jlive.apply(JR.DeltaBatchUpdate().delete("R1", np.array([2])))
    rep = live.explain()
    assert_same_report(rep, jlive.explain())
    assert rep.mode == "maintained" and rep.epoch == 1 and rep.step == 1
    assert rep.n_delta_scan_steps > 0
    srv, jsrv = live.serve(max_pinned_epochs=4), jlive.serve(max_pinned_epochs=4)
    srv.read("q_count")
    jsrv.read("q_count")
    rep = live.explain()
    assert_same_report(rep, jlive.explain())
    assert rep.mode == "served" and rep.serving["n_reads"] == 1
    assert rep.max_pinned_epochs == 4
    s = rep.summary()
    assert "serve:" in s and "ivm:" in s and "verify:" in s
    # the summary's lines are the reference's but for the backend's name
    # and the latencies; a routed query adds the routing line to both
    ts.route(T.query("q_x1", ["x1"], [T.COUNT]))
    js.route(J.query("q_x1", ["x1"], [J.COUNT]))
    got, want = live.explain(), jlive.explain()
    assert got.routing["tiers"] == want.routing["tiers"]
    lines = [ln.split(" read_p50")[0] for ln in got.summary().splitlines()]
    jlines = [ln.split(" read_p50")[0] for ln in want.summary().splitlines()]
    assert lines == [ln.replace("backend=xla", "backend=torch")
                     for ln in jlines]
    assert any(ln.startswith("  routing:") for ln in lines)


def test_with_config_shares_engine_and_tensors():
    ts, js = sessions()
    alt = ts.with_config(backend="torch", fuse_kernels=False)
    jalt = js.with_config(fuse_kernels=False)
    assert alt.data is ts.data and alt._engine is ts._engine
    assert alt.tree is ts.tree and alt.edges == ts.edges
    assert all(alt.relation(n).columns[a] is ts.relation(n).columns[a]
               for n in ts.sizes() for a in ts.relation(n).columns)
    assert alt.config.backend == "torch" and ts.config.backend == "cuda"
    assert alt.config.fuse_kernels is False and alt.config.block_size == 8
    assert_close(alt.views(api_queries(T)).run(),
                 jalt.views(api_queries(J)).run())
    assert alt.routing_stats() is None and alt.workload is not ts.workload
    with pytest.raises(ValueError, match="block_size"):
        ts.with_config(block_size=0)


def test_tree_relation_schedule_batched_params_match_reference():
    ts, js = sessions()
    assert ([e.as_tuple() for e in ts.tree.edges]
            == [e.as_tuple() for e in js.tree.edges])
    assert ts.tree.nodes == js.tree.nodes
    for name in ("R1", "R2", "R3"):
        got, want = ts.relation(name), js.relation(name)
        assert got.n_rows == want.n_rows
        for a in want.columns:
            np.testing.assert_array_equal(got.columns[a].numpy(),
                                          np.asarray(want.columns[a]))
    thr = T.Param("t", batched=True)
    qs = api_queries(T) + [T.query("qb", ["x4"], [T.agg(T.Var("u"),
                                                          T.Delta("x1", "==", thr))])]
    jqs = api_queries(J) + [J.query("qb", ["x4"], [J.agg(J.Var("u"), J.Delta(
        "x1", "==", J.Param("t", batched=True)))])]
    v, r = ts.views(qs), js.views(jqs)
    assert v.batched_params == r.batched_params == {"t"}
    assert ts.views(api_queries(T)).batched_params == frozenset()
    assert ([(s.sid, s.rel, s.gids, s.vids, s.level, s.deps)
             for s in v.schedule.steps]
            == [(s.sid, s.rel, s.gids, s.vids, s.level, s.deps)
                for s in r.schedule.steps])
    assert v.schedule.n_fused_groups == r.schedule.n_fused_groups


# ------------------------------------------------------- IVM verifier hooks

@pytest.fixture(scope="module")
def maintained_pair():
    """Both packages' maintained batches over the analysis queries, warm
    for every relation, after one insert into R2."""
    ts, js = sessions()
    h = ts.views(analysis_queries(T), maintain=True,
                 warm_rels=["R1", "R2", "R3"])
    jh = js.views(analysis_queries(J), maintain=True,
                  warm_rels=["R1", "R2", "R3"])
    h.run()
    jh.run()
    rng = np.random.default_rng(0)
    rows = {"x2": rng.integers(0, 4, 3), "x3": rng.integers(0, 5, 3),
            "u": rng.normal(size=3).astype(np.float32)}
    h.apply(TR.DeltaBatchUpdate().insert("R2", rows))
    jh.apply(JR.DeltaBatchUpdate().insert("R2", rows))
    return h, jh, ts, js


def same_report(got, want):
    assert (got.artifact, got.n_checks, got.invariants) == \
        (want.artifact, want.n_checks, want.invariants)


def test_ivm_verifier_reports_match_reference(maintained_pair):
    """Rule ids and check counts of every delta program, tick program and
    resident relation equal the reference's on the same single-device
    artifacts; so do the reports the maintained batches kept."""
    h, jh, ts, js = maintained_pair
    mb, jb = h.maintained, jh.maintained
    for rel in ("R1", "R2", "R3"):
        dp, jdp = mb.delta_program(rel), jb.delta_program(rel)
        same_report(TV.verify_delta_program(mb.plan, dp),
                    JV.verify_delta_program(jb.plan, jdp))
        tp, jtp = mb.tick_program(rel), jb.tick_program(rel)
        assert [(s.rel, s.scans_delta) for s in tp.steps] \
            == [(s.rel, s.weighted) for s in jtp.steps]
        rep = TV.verify_tick_program(tp, dp)
        same_report(rep, JV.verify_tick_program(jtp, jdp))
        assert rep.invariants == ("psum-before-fold", "weight-compat")
        rep = TV.verify_resident(TR.ResidentRelation.from_relation(
            ts.relation(rel)))
        same_report(rep, JV.verify_resident(JR.ResidentRelation.from_relation(
            js.relation(rel))))
        assert rep.invariants == ("resident-capacity",)
    assert mb.last_verifications.keys() == jb.last_verifications.keys()
    for k, rep in mb.last_verifications.items():
        same_report(rep, jb.last_verifications[k])
    assert h.explain().verification == jh.explain().verification
    assert set(TV.ALL_INVARIANTS) == set(JV.ALL_INVARIANTS)


def test_verification_off_keeps_nothing():
    ts, _ = sessions(verify_plans=False)
    h = ts.views(analysis_queries(T), maintain=True, warm_rels=["R2"])
    h.run()
    assert h.maintained.last_verifications == {}
    assert h.explain().verification is None


def _expect(invariant, fn, *args):
    with pytest.raises(Exception) as ei:
        fn(*args)
    assert ei.value.invariant == invariant, ei.value
    return ei.value


def _first(seq, pred):
    return next(x for x in seq if pred(x))


def _mutate_product(prog, pred, fn):
    """tests/test_analysis.py's helper: replace the first product matching
    ``pred`` inside a frozen scan program."""
    for vi, vp in enumerate(prog.views):
        for ci, col in enumerate(vp.cols):
            for pi, pr in enumerate(col.products):
                if pred(pr):
                    new_col = dataclasses.replace(col, products=tuple(
                        fn(p) if i == pi else p
                        for i, p in enumerate(col.products)))
                    new_vp = dataclasses.replace(vp, cols=tuple(
                        new_col if i == ci else c
                        for i, c in enumerate(vp.cols)))
                    return dataclasses.replace(prog, views=tuple(
                        new_vp if i == vi else v
                        for i, v in enumerate(prog.views)))
    raise AssertionError("no product matched")


def _both(maintained_pair):
    h, jh, _, _ = maintained_pair
    return ((h.maintained, TV, TI, TR), (jh.maintained, JV, JI, JR))


def test_planted_weight_compat_in_delta_program(maintained_pair):
    """tests/test_analysis.py:298."""
    for mb, V, _, _ in _both(maintained_pair):
        dp = mb.delta_program("R2")
        st0 = dp.steps[0]
        bad = dataclasses.replace(dp, steps=(dataclasses.replace(
            st0, scans_delta=not st0.scans_delta),) + dp.steps[1:])
        _expect("weight-compat", V.verify_delta_program, mb.plan, bad)


def test_planted_second_order_product(maintained_pair):
    """tests/test_analysis.py:308: a duplicated affected child factor makes
    a tier-2 product second-order."""
    for mb, V, _, _ in _both(maintained_pair):
        dp = _first([mb.delta_program(r) for r in ("R1", "R2", "R3")],
                    lambda d: any(not s.scans_delta for s in d.steps))
        idx, st = _first(list(enumerate(dp.steps)),
                         lambda t: not t[1].scans_delta)

        def dup(p, dp=dp):
            ref = _first(p.child_refs, lambda r: r.vid in dp.affected)
            return dataclasses.replace(p, child_refs=p.child_refs + (ref,))

        bad_prog = _mutate_product(
            st.prog, lambda p: any(r.vid in dp.affected for r in p.child_refs),
            dup)
        bad = dataclasses.replace(dp, steps=tuple(
            dataclasses.replace(s, prog=bad_prog) if i == idx else s
            for i, s in enumerate(dp.steps)))
        err = _expect("delta-first-order", V.verify_delta_program, mb.plan, bad)
        assert "first-order" in err.detail


def test_planted_unweighted_delta_scan_in_tick(maintained_pair):
    """tests/test_analysis.py:353: the tick's delta-tuple scan loses its
    signed weights (``weighted=False``, a field of its own in both)."""
    for mb, V, I, _ in _both(maintained_pair):
        dp = mb.delta_program("R2")
        tp = I.build_tick_program(dp)
        idx = _first(range(len(tp.steps)), lambda i: tp.steps[i].scans_delta)
        bad = dataclasses.replace(tp, steps=tuple(
            dataclasses.replace(s, weighted=False) if i == idx else s
            for i, s in enumerate(tp.steps)))
        _expect("weight-compat", V.verify_tick_program, bad, dp)


def test_sharded_tick_program_verifies_clean(maintained_pair):
    """tests/test_analysis.py:146: the sharded placement verifies without a
    mesh — a tick built for a synthetic shard choice, its partitioned steps
    all-reducing their views — with the reference's checks and counts."""
    for rel in ("R1", "R2", "R3"):
        reps = []
        for mb, V, I, _ in _both(maintained_pair):
            dp = mb.delta_program(rel)
            tp = I.build_tick_program(dp, shard_rel="R2", axis="data")
            rep = V.verify_tick_program(tp, dp)
            assert "psum-before-fold" in rep.invariants
            assert [(ts.partitioned, len(ts.psum_vids)) for ts in tp.steps] \
                == [(ts.rel == "R2", len(ts.prog.views) if ts.rel == "R2"
                     else 0) for ts in tp.steps]
            reps.append(rep)
            if rel == "R1":
                assert any(ts.partitioned and ts.psum_vids
                           for ts in tp.steps)
        same_report(*reps)
        assert reps[0].artifact == f"tick Δ{rel} (shard R2@data)"


def test_planted_missing_psum_in_sharded_tick(maintained_pair):
    """A partitioned step whose ``psum_vids`` were left empty would fold
    one rank's partial delta: psum-before-fold, in both packages; so would
    an axis without a relation."""
    for mb, V, I, _ in _both(maintained_pair):
        dp = mb.delta_program("R2")
        tp = I.build_tick_program(dp, shard_rel="R2", axis="data")
        idx = _first(range(len(tp.steps)), lambda i: tp.steps[i].partitioned)
        bad = dataclasses.replace(tp, steps=tuple(
            dataclasses.replace(s, psum_vids=()) if i == idx else s
            for i, s in enumerate(tp.steps)))
        err = _expect("psum-before-fold", V.verify_tick_program, bad, dp)
        assert "partial per-shard deltas" in err.detail
        half = dataclasses.replace(tp, shard_rel=None)
        _expect("psum-before-fold", V.verify_tick_program, half, dp)


def test_planted_tick_divergence_and_short_fold(maintained_pair):
    """A tick whose step is not its delta step's, or whose fold misses an
    affected view: the same rule id in both packages."""
    for mb, V, I, _ in _both(maintained_pair):
        dp = mb.delta_program("R1")
        tp = I.build_tick_program(dp)
        other = mb.delta_program("R3").steps[-1].prog
        swapped = dataclasses.replace(tp, steps=(dataclasses.replace(
            tp.steps[0], prog=other),) + tp.steps[1:])
        _expect("psum-before-fold", V.verify_tick_program, swapped, dp)
        short = dataclasses.replace(tp, fold_vids=tp.fold_vids[1:])
        _expect("psum-before-fold", V.verify_tick_program, short, dp)


def test_planted_resident_capacity(maintained_pair):
    """tests/test_analysis.py:364: a row count past the capacity, ragged
    buffers, a capacity off a power of two."""
    _, _, ts, js = maintained_pair
    for sess, V, R in ((ts, TV, TR), (js, JV, JR)):
        rr = R.ResidentRelation.from_relation(sess.relation("R1"))
        _expect("resident-capacity", V.verify_resident,
                dataclasses.replace(rr, n_valid=rr.capacity + 1))
        ragged = dataclasses.replace(rr, buffers={
            a: (c[:-1] if i == 0 else c)
            for i, (a, c) in enumerate(rr.buffers.items())})
        _expect("resident-capacity", V.verify_resident, ragged)
        odd = dataclasses.replace(rr, buffers={a: c[:-1]
                                               for a, c in rr.buffers.items()})
        _expect("resident-capacity", V.verify_resident, odd)


def test_resident_checked_at_publish_and_restore(tmp_path):
    """The port re-checks resident relations where the reference does: at
    init, at each publish and at a restore; a broken relation raises."""
    ts, _ = sessions()
    h = ts.views(analysis_queries(T), maintain=True)
    h.run()
    h.apply(TR.DeltaBatchUpdate().delete("R3", np.array([0, 1])))
    h.snapshot(str(tmp_path))
    assert h.restore(str(tmp_path)) == 1
    mb = h.maintained
    es = mb.epoch_state()
    rr = es.relations["R1"]
    broken = dataclasses.replace(rr, n_valid=rr.capacity + 1)
    with pytest.raises(TV.PlanInvariantError, match="resident-capacity"):
        TV.verify_resident(broken)

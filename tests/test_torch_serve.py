"""The port's ad-hoc query serving against the reference's, on the CPU: the
plan and route verifier, the subsumption lattice and its lowered
re-aggregation, the signature router, and the epoch-pinned view server.

The same numpy tables and request sequence go through ``repro`` (the
``xla`` backend, as tests/test_router.py runs it) and ``repro_torch`` (the
cuda backend on CPU tensors, whose kernel wrappers run their plain
versions); data passes between the packages only as numpy.  Tolerances:
routed answers against the reference's at rtol/atol 1e-4, the rule between
backends (tests/test_backends.py: float32 sums in different orders); the
port's answers against its own from-scratch compile at 1e-3, the
reference's rule in tests/test_router.py and tests/test_serve_views.py.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.analysis import verify as JV
from repro.core import aggregates as J
from repro.core import subsume as JS
from repro.core.schema import schema as jschema
from repro.data import datasets as JD
from repro.data import relations as JR
from repro.ml import covar as jcovar
from repro.serve.router import QueryRouter as JQueryRouter
from repro_torch.analysis import verify as TV
from repro_torch.core import aggregates as T
from repro_torch.core import subsume as TS
from repro_torch.core.schema import schema as tschema
from repro_torch.data import datasets as TD
from repro_torch.data import relations as TR
from repro_torch.kernels import ops
from repro_torch.ml import covar as tcovar
from repro_torch.serve.router import QueryRouter as TQueryRouter
from repro_torch.serve.views import ViewServer

TOL = dict(rtol=1e-4, atol=1e-4)
FRESH_TOL = dict(rtol=1e-3, atol=1e-3)

# the chain schema and tables of tests/test_router.py
SPEC = ([("x1", "categorical", 3), ("x2", "key", 4), ("x3", "key", 5),
         ("x4", "categorical", 3), ("u", "continuous", 0)],
        [("R1", ["x1", "x2"]), ("R2", ["x2", "x3", "u"]), ("R3", ["x3", "x4"])])


def chain_db(seed=0, n1=17, n2=29, n3=13):
    rng = np.random.default_rng(seed)
    return {"R1": {"x1": rng.integers(0, 3, n1), "x2": rng.integers(0, 4, n1)},
            "R2": {"x2": rng.integers(0, 4, n2), "x3": rng.integers(0, 5, n2),
                   "u": rng.normal(size=n2).astype(np.float32)},
            "R3": {"x3": rng.integers(0, 5, n3), "x4": rng.integers(0, 3, n3)}}


def r2_rows(rng, k):
    return {"x2": rng.integers(0, 4, k), "x3": rng.integers(0, 5, k),
            "u": rng.normal(size=k).astype(np.float32)}


class Pkg:
    """One package's entry points, so that one driver runs either."""

    def __init__(self, name):
        self.name = name
        self.port = name == "port"
        self.agg = T if self.port else J
        self.rel = TR if self.port else JR
        self.verify = TV if self.port else JV
        self.subsume = TS if self.port else JS
        self.router_cls = TQueryRouter if self.port else JQueryRouter

    def schema(self):
        return (tschema if self.port else jschema)(*SPEC)

    def data(self, tables):
        if self.port:
            return TR.from_numpy(self.schema(), tables, "cpu")
        return JR.from_numpy(self.schema(), tables)

    def connect(self, source, capacity=32, **cfg):
        if self.port:
            return repro_torch.connect(source, config=repro_torch.ExecutionConfig(
                block_size=8, route_cache_capacity=capacity, **cfg))
        return repro.connect(source, config=repro.ExecutionConfig(
            block_size=8, route_cache_capacity=capacity, **cfg))

    def session(self, tables, capacity=32, **cfg):
        return self.connect(self.data(tables), capacity, **cfg)

    def udaf(self, tag=""):
        if self.port:
            fn = lambda a, p: (a * 2).to(torch.float32)    # noqa: E731
        else:
            fn = lambda a, p: (a * 2).astype(np.float32)   # noqa: E731
        return self.agg.Lambda(("x1",), fn, tag=tag)

    def mask_udaf(self):
        m = self.agg
        return m.Lambda(("x1",), lambda a, p: p["m"][..., a], tag="mask",
                        param_refs=(m.Param("m", batched=True),))


PORT, REF = Pkg("port"), Pkg("reference")


def host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def cube(m):
    """tests/test_router.py's maintained cube."""
    return [m.query("cube_g14", ["x1", "x4"], [m.COUNT, m.sum_of("u")]),
            m.query("cube_g2", ["x2"], [m.sum_of("u")])]


def probes(m):
    return {"exact": m.query("q_exact", ["x4", "x1"], [m.sum_of("u"), m.COUNT]),
            "sub": m.query("q_sub", ["x4"], [m.COUNT]),
            "total": m.query("q_total", [], [m.sum_of("u"), m.COUNT]),
            "miss": m.query("q_miss", ["x3"], [m.COUNT]),
            "miss_b": m.query("q_miss_b", ["x2"], [m.COUNT]),
            "miss_c": m.query("q_miss_c", ["x3"], [m.sum_of("u")])}


def fresh(pkg, data, q):
    """From-scratch oracle: an independent session compiling exactly q."""
    return host(pkg.connect(data).views([q]).run()[q.name])


# -------------------------------------------------------------- the verifier

def chain_queries(m):
    return [m.query("q_count", [], [m.COUNT]),
            m.query("q_sums", [], [m.sum_of("u"), m.agg(m.Pow("u", 2))]),
            m.query("q_g1", ["x1"], [m.COUNT, m.sum_of("u")]),
            m.query("q_g2", ["x1", "x4"], [m.COUNT]),
            m.query("q_delta", ["x4"], [m.agg(m.Var("u"), m.Delta("x1", "==", 1))]),
            m.query("q_b", ["x4"], [m.agg(m.Var("u"),
                                          m.Delta("x1", "==", m.Param("t", batched=True)))])]


@pytest.fixture(scope="module")
def retailer():
    return JD.make("retailer", scale=0.02), TD.make("retailer", scale=0.02)


def _plans(kind, retailer):
    """The same batch compiled in both packages: (port plan, reference plan)."""
    if kind == "chain":
        tables = chain_db()
        return tuple(p.session(tables).views(chain_queries(p.agg)).compiled.plan
                     for p in (PORT, REF))
    jds, tds = retailer
    tq, _ = tcovar.covar_queries(tds)
    jq, _ = jcovar.covar_queries(jds)
    return (repro_torch.connect(tds, device="cpu").views(tq).compiled.plan,
            repro.connect(jds).views(jq).compiled.plan)


@pytest.mark.parametrize("kind", ["chain", "retailer_covar"])
def test_verify_plan_clean_and_same_coverage(kind, retailer):
    """The port's plans of the chain batch (batched params included) and
    the Retailer covar batch verify clean, with the reference's check count
    and rule set; the compile itself ran the verifier (auto-on under
    pytest)."""
    tp, jp = _plans(kind, retailer)
    tr, jr = TV.verify_plan(tp), JV.verify_plan(jp)
    assert tr.n_checks == jr.n_checks > 0
    assert tr.invariants == jr.invariants
    assert set(tr.invariants) <= set(TV.ALL_INVARIANTS)
    assert tr.summary() == jr.summary()
    assert tp.last_verification is not None


class _Mutant:
    """A plan stand-in for verify_plan (tests/test_analysis.py's): copies
    the plan's artifacts so a witness can corrupt one."""

    def __init__(self, plan, **over):
        self.schema = plan.schema
        self.views = plan.views
        self.programs = dict(plan.programs)
        self.groups = list(plan.groups)
        self.schedule = plan.schedule
        self.step_programs = list(plan.step_programs)
        for k, v in over.items():
            setattr(self, k, v)


def _first_prog(plan, pred):
    gid = next(g for g in sorted(plan.programs) if pred(plan.programs[g]))
    return gid, plan.programs[gid]


def _replace_view(plan, pred, fn):
    gid, prog = _first_prog(plan, lambda p: any(pred(v) for v in p.views))
    vp = next(v for v in prog.views if pred(v))
    m = _Mutant(plan)
    m.programs[gid] = dataclasses.replace(
        prog, views=tuple(fn(v) if v is vp else v for v in prog.views))
    return m


def _replace_product(plan, pred, fn):
    def hit(vp):
        return any(pred(pr) for c in vp.cols for pr in c.products)

    def rebuild(vp):
        cols, done = [], False
        for c in vp.cols:
            prods = []
            for pr in c.products:
                if not done and pred(pr):
                    pr, done = fn(pr), True
                prods.append(pr)
            cols.append(dataclasses.replace(c, products=tuple(prods)))
        return dataclasses.replace(vp, cols=tuple(cols))

    return _replace_view(plan, hit, rebuild)


def _gather_prefix(plan):
    gid, prog = _first_prog(plan, lambda p: any(g.gather for g in p.gathers))
    gs = next(g for g in prog.gathers if g.gather)
    bad = dataclasses.replace(gs, gather=(), rest=gs.gather + gs.rest)
    m = _Mutant(plan)
    m.programs[gid] = dataclasses.replace(
        prog, gathers=tuple(bad if g is gs else g for g in prog.gathers))
    return m


def _schedule_topo(plan):
    steps = list(plan.schedule.steps)
    steps[0] = dataclasses.replace(steps[0], rel="NoSuchRel")
    return _Mutant(plan, schedule=dataclasses.replace(plan.schedule, steps=steps))


#: tests/test_analysis.py's mutation witnesses of the plan half
MUTATIONS = {
    "gather-prefix": _gather_prefix,
    "segment-layout": lambda p: _replace_view(
        p, lambda v: v.seg is not None,
        lambda v: dataclasses.replace(v, seg=dataclasses.replace(
            v.seg, n_segments=v.seg.n_segments + 1))),
    "acc-shape": lambda p: _replace_view(
        p, lambda v: True,
        lambda v: dataclasses.replace(v, acc_shape=v.acc_shape[:-1] + (v.acc_shape[-1] + 1,))),
    "axis-frame": lambda p: _replace_product(
        p, lambda pr: True, lambda pr: dataclasses.replace(pr, n_keep=pr.n_keep + 1)),
    "dtype-flow": lambda p: _replace_product(
        p, lambda pr: pr.child_refs,
        lambda pr: dataclasses.replace(
            pr, child_refs=(dataclasses.replace(pr.child_refs[0], col=999),)
            + pr.child_refs[1:])),
    "schedule-topo": _schedule_topo,
    "batched-flag": lambda p: _replace_view(
        p, lambda v: v.batched, lambda v: dataclasses.replace(v, batched=False)),
}


@pytest.mark.parametrize("rule", sorted(MUTATIONS))
def test_corrupted_plan_raises_the_same_rule(rule):
    """The same corruption of the same plan raises PlanInvariantError with
    the same rule id in both packages."""
    tp, jp = _plans("chain", None)
    errs = []
    for plan, verify in ((tp, TV), (jp, JV)):
        with pytest.raises(verify.PlanInvariantError) as ei:
            verify.verify_plan(MUTATIONS[rule](plan))
        errs.append(ei.value)
    assert errs[0].invariant == errs[1].invariant == rule
    assert errs[0].artifact == errs[1].artifact


SHAPES = [  # (wide dims, domains, aggs) -> (narrow dims, aggs)
    ((("x1", "x4"), (3, 3), ("1", "u")), (("x4",), ("u",))),
    ((("x1", "x4"), (3, 3), ("1", "u")), (("x4", "x1"), ("u", "1"))),
    ((("x1", "x2", "x4"), (3, 4, 3), ("1", "u", "u^2")), (("x4", "x1"), ("u^2", "1"))),
    ((("x1", "x2", "x4"), (3, 4, 3), ("1", "u", "u^2")), ((), ("u",))),
    ((("x2", "x1"), (4, 3), ("u", "1", "u")), (("x1",), ("u", "u"))),
]


@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_secondary_program_and_lowering_match_reference(case):
    """build_secondary_program gives the same (col_idx, sum_axes, perm) in
    both packages; the lowered re-aggregation agrees on the same numpy
    tensor at 1e-4, and against a numpy float64 re-aggregation; a wrong
    column pick is rejected by both verifiers."""
    (wd, wdom, wa), (nd, na) = SHAPES[case]
    dom = dict(zip(wd, wdom))
    progs = []
    for p in (PORT, REF):
        wide = p.subsume.ViewShape("wide", wd, wdom, wa)
        narrow = p.subsume.ViewShape("narrow", nd, tuple(dom[d] for d in nd), na)
        assert p.subsume.subsumes(wide, narrow)
        progs.append(p.subsume.build_secondary_program(wide, narrow))
    tsp, jsp = progs
    assert (tsp.col_idx, tsp.sum_axes, tsp.perm, tsp.is_exact) == \
        (jsp.col_idx, jsp.sum_axes, jsp.perm, jsp.is_exact)
    assert TV.verify_secondary_program(tsp).n_checks == JV.verify_secondary_program(jsp).n_checks
    arr = np.random.default_rng(case).normal(size=wdom + (len(wa),)).astype(np.float32)
    got = TS.lower_secondary(tsp)(torch.from_numpy(arr))
    want = np.asarray(JS.lower_secondary(jsp)(arr))
    np.testing.assert_allclose(host(got), want, **TOL)
    exp = arr.astype(np.float64)[..., list(jsp.col_idx)].sum(axis=jsp.sum_axes)
    exp = exp.transpose(tuple(jsp.perm) + (len(jsp.perm),))
    np.testing.assert_allclose(host(got), exp, **TOL)
    # a permuted (non-contiguous) source reads the same
    view = torch.from_numpy(np.ascontiguousarray(np.moveaxis(arr, 0, -2))).movedim(-2, 0)
    assert not view.is_contiguous()
    np.testing.assert_allclose(host(TS.lower_secondary(tsp)(view)), want, **TOL)
    wrong = tuple(len(wa) - 1 - i if len(set(wa)) > 1 else i for i in tsp.col_idx)
    if any(wa[w] != wa[i] for w, i in zip(wrong, tsp.col_idx)):
        for sp, v in ((tsp, TV), (jsp, JV)):
            with pytest.raises(v.PlanInvariantError) as ei:
                v.verify_secondary_program(dataclasses.replace(sp, col_idx=wrong))
            assert ei.value.invariant == "route-subsume"


def test_secondary_program_rejects_what_it_cannot_answer():
    for p in (PORT, REF):
        wide = p.subsume.ViewShape("wide", ("x1", "x4"), (3, 3), ("1", "u"))
        with pytest.raises(ValueError, match="group-by attrs"):
            p.subsume.build_secondary_program(
                wide, p.subsume.ViewShape("n", ("x3",), (5,), ("1",)))
        with pytest.raises(ValueError, match="not materialized"):
            p.subsume.build_secondary_program(
                wide, p.subsume.ViewShape("n", ("x4",), (3,), ("u^2",)))


# ------------------------------------------------------------------ the router

def drive(pkg):
    """tests/test_router.py's requests, in one sequence through one
    package: exact, subsumed, compiled, a cached repeat, eviction and
    re-admission (capacity 2), an untagged UDAF, params skipping a
    maintained source, batched params rejected, a route after an update,
    and a capacity-0 session.  Returns the routed results and stats."""
    m = pkg.agg
    tables = chain_db()
    data = pkg.data(tables)
    sess = pkg.connect(data, capacity=2)
    h = sess.views(cube(m), maintain=True)
    h.run()
    dispatches = h.compiled.n_dispatches
    p = probes(m)
    t_q = m.query("q_t", ["x4"], [m.agg(m.Var("u"), m.Delta("x1", "==", m.Param("t")))])
    rows = []

    def ask(q, params=None):
        r = sess.route(q, params=params)
        rows.append((q.name, r.tier, r.source, r.epoch, r.scanned, host(r.value)))
        return r

    for key in ("exact", "sub", "total", "miss", "miss", "miss_b", "miss_c",
                "miss", "miss"):
        ask(p[key])
    anon = m.query("q_anon", ["x2"], [m.agg(pkg.udaf())])
    ask(anon)
    ask(anon)
    assert h.compiled.n_dispatches == dispatches     # hit tiers scanned nothing
    ht = sess.views([m.query("cube_t", ["x4"], [m.agg(m.Var("u"),
                                                      m.Delta("x1", "==", m.Param("t")))])],
                    maintain=True)
    ht.run(params={"t": 1.0})
    ask(t_q, {"t": 1.0})
    ask(t_q, {"t": 2.0})
    ask(t_q)
    with pytest.raises(ValueError, match="run_batched"):
        sess.route(m.query("q_b", [], [m.agg(pkg.mask_udaf())]),
                   params={"m": np.ones((2, 3), np.float32)})
    upd = pkg.rel.DeltaBatchUpdate().insert("R2", r2_rows(np.random.default_rng(11), 4))
    h.apply(upd)
    ask(p["sub"])
    ask(p["exact"])
    zero = pkg.connect(data, capacity=0)
    for _ in range(2):
        r = zero.route(p["miss"])
        rows.append(("zero", r.tier, r.source, r.epoch, r.scanned, host(r.value)))
    stats = {k: v for k, v in sess.routing_stats().items() if k != "route_us"}
    zstats = {k: v for k, v in zero.routing_stats().items() if k != "route_us"}
    return rows, stats, zstats, sess


def test_router_sequence_matches_reference():
    """Every request lands in the same tier, with the same source, epoch
    and scan flag, in both packages; the answers agree at 1e-4; the
    routing stats are equal apart from the latency histogram."""
    ops.reset_launches()
    trows, tstats, tz, sess = drive(PORT)
    jrows, jstats, jz, _ = drive(REF)
    assert sum(ops.LAUNCHES.values()) == 0          # CPU tensors: plain versions
    assert [r[:5] for r in trows] == [r[:5] for r in jrows]
    for t, j in zip(trows, jrows):
        assert t[5].shape == j[5].shape, t[0]
        np.testing.assert_allclose(t[5], j[5], err_msg=f"{t[0]} {t[1]}", **TOL)
    assert tstats == jstats and tz == jz
    tiers = [r[1] for r in trows]
    assert tiers[:9] == ["exact", "subsumed", "subsumed", "compiled", "exact",
                         "compiled", "compiled", "compiled", "exact"]
    assert tiers[9:11] == ["fallback_scan"] * 2
    assert tiers[11:14] == ["compiled", "exact", "exact"]
    assert [r[4] for r in trows[11:14]] == [True, True, False]
    assert tiers[14:16] == ["subsumed", "exact"] and [r[3] for r in trows[14:16]] == [1, 1]
    assert tiers[16:] == ["fallback_scan"] * 2
    assert tstats["n_evictions"] >= 2 and tstats["n_admission_failures"] == 0
    assert tz["cache_size"] == 0 and tz["n_plans_compiled"] == 2
    # every routed query landed in the workload, with its tier
    routes = {}
    for e in sess.workload.by_signature().values():
        for tier, n in e["routes"].items():
            routes[tier] = routes.get(tier, 0) + n
    assert routes == tstats["tiers"]


def test_routed_answers_match_a_fresh_compile():
    """The port's routed answers equal its own from-scratch compile of the
    same query (tests/test_router.py's oracle), tier by tier."""
    tables = chain_db()
    data = PORT.data(tables)
    sess = PORT.connect(data)
    sess.views(cube(T), maintain=True).run()
    for key, q in probes(T).items():
        r = sess.route(q)
        assert r.value.device.type == "cpu"
        np.testing.assert_allclose(host(r.value), fresh(PORT, data, q),
                                   err_msg=key, **FRESH_TOL)


@pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "reference"])
def test_admission_rejects_corrupted_plan(pkg, monkeypatch):
    """A corrupted serving-time compile raises the same structured error in
    both packages and is not cached; the gate admits after."""
    sess = pkg.session(chain_db())
    cls = pkg.router_cls
    orig = cls._compile_fresh

    def corrupting(self, q):
        handle = orig(self, q)
        plan = handle.compiled.plan
        steps = list(plan.schedule.steps)
        steps[0] = dataclasses.replace(steps[0], rel="NoSuchRel")
        plan.schedule = dataclasses.replace(plan.schedule, steps=tuple(steps))
        return handle

    monkeypatch.setattr(cls, "_compile_fresh", corrupting)
    q = probes(pkg.agg)["miss"]
    with pytest.raises(pkg.verify.PlanInvariantError) as ei:
        sess.route(q)
    assert ei.value.invariant == "schedule-topo"
    assert sess.router.n_admission_failures == 1
    assert sess.routing_stats()["cache_size"] == 0
    monkeypatch.setattr(cls, "_compile_fresh", orig)
    assert sess.route(q).tier == "compiled"


def test_subsumption_tracks_updates_without_scanning():
    tables = chain_db()
    data = PORT.data(tables)
    sess = PORT.connect(data)
    h = sess.views(cube(T), maintain=True)
    h.run()
    rng = np.random.default_rng(11)
    q = probes(T)["sub"]
    for i in range(3):
        upd = TR.DeltaBatchUpdate().insert("R2", r2_rows(rng, 4))
        if i == 1:
            upd.delete("R1", np.array([0, 3]))
        h.apply(upd)
        data = TR.apply_delta(data, upd)
        r = sess.route(q)
        assert r.tier == "subsumed" and not r.scanned and r.epoch == i + 1
        np.testing.assert_allclose(host(r.value), fresh(PORT, data, q), **FRESH_TOL)
    assert sess.router.n_base_scans == 0


def test_epoch_consistency_under_concurrent_updater():
    """With an updater folding batches through the server, every routed
    maintained answer equals the oracle at exactly the epoch it reports."""
    tables = chain_db()
    data = PORT.data(tables)
    sess = PORT.connect(data)
    srv = sess.views(cube(T), maintain=True).serve()
    rng = np.random.default_rng(23)
    updates = [TR.DeltaBatchUpdate().insert("R2", r2_rows(rng, 3)) for _ in range(5)]
    db_at = [data]
    for upd in updates:
        db_at.append(TR.apply_delta(db_at[-1], upd))
    q = probes(T)["sub"]
    got, done, errors = [], threading.Event(), []

    def reader():
        try:
            while not done.is_set():
                r = sess.route(q)
                got.append((r.epoch, host(r.value).copy()))
            r = sess.route(q)
            got.append((r.epoch, host(r.value).copy()))
        except Exception as exc:             # surface in the main thread
            errors.append(exc)

    t = threading.Thread(target=reader)
    t.start()
    try:
        for upd in updates:
            srv.apply(upd)
            time.sleep(0.01)
    finally:
        done.set()
        t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    assert len(got) >= 2 and {e for e, _ in got} <= set(range(6))
    assert got[-1][0] == 5
    for epoch, value in got:
        np.testing.assert_allclose(value, fresh(PORT, db_at[epoch], q),
                                   err_msg=f"epoch {epoch}", **FRESH_TOL)


def test_front_doors():
    """Database.query and ViewServer.query return the same tensor; a
    server built without a router says how to get one."""
    sess = PORT.session(chain_db())
    h = sess.views(cube(T), maintain=True)
    srv = h.serve()
    q = probes(T)["sub"]
    assert torch.equal(sess.query(q), srv.query(q))
    with pytest.raises(ValueError, match="router"):
        ViewServer(h.maintained).query(q)
    with pytest.raises(ValueError, match="capacity"):
        TQueryRouter(sess, capacity=True)
    assert PORT.session(chain_db()).routing_stats() is None


# ------------------------------------------------------------- the view server

def queries(m):
    return [m.query("q_count", [], [m.COUNT]),
            m.query("q_g1", ["x1"], [m.COUNT, m.sum_of("u")]),
            m.query("q_delta", ["x4"], [m.agg(m.Var("u"), m.Delta("x1", "==", 1))])]


def results_equal(a, b):
    for q in queries(T):
        assert torch.equal(a[q.name], b[q.name]), q.name


def test_background_updater_foreground_reader():
    """A reader pins an epoch while a background thread applies update
    batches through the server: every re-read through the pin is bitwise
    the first; afterwards the current epoch matches a fresh compile over
    the post-update database, and every pin is released."""
    tables = chain_db()
    data = PORT.data(tables)
    sess = PORT.connect(data)
    srv = sess.views(queries(T), maintain=True).serve()
    rng = np.random.default_rng(21)
    updates = [TR.DeltaBatchUpdate().insert("R2", r2_rows(rng, 3))
               .delete("R2", rng.choice(29, 3, replace=False)),
               TR.DeltaBatchUpdate().delete("R1", np.array([0, 5])),
               TR.DeltaBatchUpdate().insert("R2", r2_rows(rng, 6))]
    oracle, errors = [data], []
    with srv.snapshot() as snap:
        first = {k: v.clone() for k, v in snap.results().items()}
        e0 = snap.epoch

        def updater():
            try:
                for upd in updates:
                    srv.apply(upd)
                    oracle[0] = TR.apply_delta(oracle[0], upd)
            except Exception as exc:
                errors.append(exc)

        t = threading.Thread(target=updater)
        t.start()
        for _ in range(6):
            results_equal(first, srv.maintained.results(epoch=snap.epoch))
        t.join(timeout=60)
        assert not t.is_alive() and not errors, errors
        assert srv.epoch == e0 + len(updates)
        results_equal(first, srv.maintained.results(epoch=snap.epoch))
        results_equal(first, snap.results())
    got = srv.read()
    for q in queries(T):
        np.testing.assert_allclose(host(got[q.name]), fresh(PORT, oracle[0], q),
                                   err_msg=q.name, **FRESH_TOL)
    st = srv.stats()
    assert st["n_updates"] == len(updates) and st["n_pinned_epochs"] == 0
    assert st["tick_us"]["count"] == len(updates)


def test_rejected_update_leaves_served_epoch():
    srv = PORT.session(chain_db(seed=9)).views(queries(T), maintain=True).serve()
    e0 = srv.epoch
    before = srv.read()
    with pytest.raises(ValueError, match="outside"):
        srv.apply(TR.DeltaBatchUpdate()
                  .insert("R1", {"x1": np.array([0]), "x2": np.array([1])})
                  .insert("R3", {"x3": np.array([0]), "x4": np.array([77])}))
    assert srv.epoch == e0
    results_equal(before, srv.read())
    st = srv.stats()
    assert st["n_rejected_updates"] == 1 and st["n_updates"] == 0


@pytest.mark.parametrize("saver", ["port", "reference"])
def test_checkpoint_mid_stream_restores_across_packages(saver, tmp_path):
    """A ViewServer.checkpoint taken while an updater thread publishes is
    one clean epoch: restored into the other package's fresh maintained
    handle it equals that package's from-scratch results at the captured
    step, and keeps maintaining."""
    src, dst = (PORT, REF) if saver == "port" else (REF, PORT)
    tables = chain_db(seed=3)
    srv = src.session(tables).views(queries(src.agg), maintain=True).serve()
    rng = np.random.default_rng(5)
    specs = [(r2_rows(rng, 2), np.array([i])) for i in range(4)]
    errors = []

    def updater():
        try:
            for ins, dels in specs:
                srv.apply(src.rel.DeltaBatchUpdate().insert("R2", ins).delete("R3", dels))
        except Exception as exc:
            errors.append(exc)

    t = threading.Thread(target=updater)
    t.start()
    path = srv.checkpoint(str(tmp_path))
    t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    other = dst.session(tables).views(queries(dst.agg), maintain=True)
    step = other.restore(str(tmp_path))
    assert 0 <= step <= len(specs) and other.maintained.step == step, path
    data = dst.data(tables)
    for ins, dels in specs[:step]:
        data = dst.rel.apply_delta(
            data, dst.rel.DeltaBatchUpdate().insert("R2", ins).delete("R3", dels))
    got = other.results()
    for q in queries(dst.agg):
        np.testing.assert_allclose(host(got[q.name]), fresh(dst, data, q),
                                   err_msg=q.name, **FRESH_TOL)
    more = r2_rows(rng, 3)
    got = other.apply(dst.rel.DeltaBatchUpdate().insert("R2", more))
    data = dst.rel.apply_delta(data, dst.rel.DeltaBatchUpdate().insert("R2", more))
    for q in queries(dst.agg):
        np.testing.assert_allclose(host(got[q.name]), fresh(dst, data, q),
                                   err_msg=q.name, **FRESH_TOL)

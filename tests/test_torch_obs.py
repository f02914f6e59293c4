"""The port's telemetry (``repro_torch.obs``) on the CPU: metrics, spans and
their chrome export, structured logging, workload records, the span names
the engine and the serving layer emit, and the query signatures, which must
render to the same ``key()`` as the reference's for the same query (the
router's cache key and the workload export's join key).  Both packages are
imported; queries are built in each from the same spec.
"""

import json
import logging
import threading
import time

import numpy as np
import pytest
import torch

import repro_torch
from repro.core import aggregates as J
from repro.obs import workload as JW
from repro_torch import obs
from repro_torch.core import aggregates as T
from repro_torch.core.schema import schema as tschema
from repro_torch.data.relations import DeltaBatchUpdate
from repro_torch.obs.metrics import Counter, Histogram, Registry
from repro_torch.obs.workload import WorkloadRecorder, routable, signature_of
from repro_torch.serve.views import ViewServer

# the chain schema and tables of tests/test_obs.py
SPEC = ([("x1", "categorical", 3), ("x2", "key", 4), ("x3", "key", 5),
         ("x4", "categorical", 3), ("u", "continuous", 0)],
        [("R1", ["x1", "x2"]), ("R2", ["x2", "x3", "u"]), ("R3", ["x3", "x4"])])


def make_tables(seed=0):
    rng = np.random.default_rng(seed)
    return {"R1": {"x1": rng.integers(0, 3, 17), "x2": rng.integers(0, 4, 17)},
            "R2": {"x2": rng.integers(0, 4, 29), "x3": rng.integers(0, 5, 29),
                   "u": rng.normal(size=29).astype(np.float32)},
            "R3": {"x3": rng.integers(0, 5, 13), "x4": rng.integers(0, 3, 13)}}


def queries():
    return [T.query("q_count", [], [T.COUNT]),
            T.query("q_g1", ["x1"], [T.COUNT, T.sum_of("u")]),
            T.query("q_delta", ["x4"], [T.agg(T.Var("u"), T.Delta("x1", "==", 1))])]


def r2_rows(rng, k):
    return {"x2": rng.integers(0, 4, k), "x3": rng.integers(0, 5, k),
            "u": rng.normal(size=k).astype(np.float32)}


def session(**cfg):
    return repro_torch.connect(tschema(*SPEC), tables=make_tables(), device="cpu",
                               config=repro_torch.ExecutionConfig(block_size=8, **cfg))


@pytest.fixture
def tracing():
    """Tracing enabled for the test, state restored after."""
    obs.clear_trace()
    obs.enable_tracing()
    yield obs.get_tracer()
    obs.disable_tracing()
    obs.clear_trace()


# ------------------------------------------------------------------- metrics

def test_histogram_percentiles_without_samples():
    h = Histogram("t", bounds=(10.0, 100.0, 1000.0))
    for v in (5, 5, 50, 50, 50, 500, 5000):
        h.observe(v)
    s = h.snapshot()
    assert s["count"] == 7 and s["min"] == 5 and s["max"] == 5000
    assert s["mean"] == pytest.approx(sum((5, 5, 50, 50, 50, 500, 5000)) / 7)
    assert 10 <= s["p50"] <= 100
    assert 1000 <= s["p99"] <= 5000
    assert s["p50"] <= s["p95"] <= s["p99"]


def test_histogram_degenerate_cases():
    h = Histogram("t")
    assert h.snapshot()["p99"] == 0.0
    h.observe(42.0)
    s = h.snapshot()
    assert s["p50"] == pytest.approx(42.0) and s["p99"] == pytest.approx(42.0)
    with pytest.raises(ValueError):
        Histogram("bad", bounds=(5.0, 1.0))


def test_counter_gauge_registry():
    r = Registry()
    c = r.counter("n")
    c.inc()
    c.inc(2)
    assert c.value == 3
    g = r.gauge("hwm")
    g.set(2.0)
    g.max(5.0)
    g.max(1.0)
    assert g.value == 5.0
    assert r.counter("n") is c
    with pytest.raises(TypeError):
        r.gauge("n")
    snap = r.snapshot()
    assert snap["n"] == 3 and snap["hwm"] == 5.0


def test_metrics_are_thread_safe():
    h = Histogram("t")
    c = Counter("c")

    def work():
        for _ in range(500):
            h.observe(7.0)
            c.inc()

    ts = [threading.Thread(target=work) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    assert h.count == 2000 and c.value == 2000


# -------------------------------------------------------------------- tracing

def test_span_noop_when_disabled():
    obs.disable_tracing()
    obs.clear_trace()
    with obs.span("never.recorded", x=1):
        pass
    assert obs.get_tracer().events() == []


def test_spans_nest_and_export_chrome(tracing, tmp_path):
    with obs.span("outer", step=1):
        with obs.span("inner"):
            time.sleep(0.001)
    evs = tracing.events()
    assert {e["name"] for e in evs} == {"outer", "inner"}
    outer = next(e for e in evs if e["name"] == "outer")
    inner = next(e for e in evs if e["name"] == "inner")
    assert outer["ph"] == "X" and outer["args"] == {"step": 1}
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1
    assert inner["dur"] >= 1000
    path = tmp_path / "trace.json"
    obs.export_chrome(str(path))
    blob = json.loads(path.read_text())
    assert len(blob["traceEvents"]) == 2 and blob["displayTimeUnit"] == "ms"


def test_tracer_bounds_memory():
    t = obs.Tracer(max_events=4)
    for i in range(10):
        t._record(f"e{i}", 0.0, 1e-6, {})
    assert len(t.events()) == 4 and t.n_dropped == 6
    t.clear()
    assert t.events() == [] and t.n_dropped == 0


def test_structured_logger_rate_limits(caplog):
    log = obs.get_logger("repro_torch.test_obs")
    with caplog.at_level(logging.WARNING, logger="repro_torch.test_obs"):
        assert log.warning_every(60.0, "k", "lagging", lag=3)
        assert not log.warning_every(60.0, "k", "lagging", lag=4)
        assert log.warning_every(60.0, "k2", "other key passes")
    assert sum("lagging lag=3" in r.message for r in caplog.records) == 1
    assert not any("lag=4" in r.message for r in caplog.records)


# ----------------------------------------------- signatures across packages

def _udaf(m, tag):
    if m is T:
        fn = lambda a, p: (a * 2).to(torch.float32)    # noqa: E731
    else:
        fn = lambda a, p: (a * 2).astype(np.float32)   # noqa: E731
    return m.Lambda(("x1",), fn, tag=tag)


#: tests/test_obs.py's signature cases, each a query built in either package
SIGNATURE_CASES = {
    "count": lambda m: m.query("q", [], [m.COUNT]),
    "dims_order_a": lambda m: m.query("qa", ["x1", "x4"], [m.COUNT, m.sum_of("u")]),
    "dims_and_aggs_permuted": lambda m: m.query("qb", ["x4", "x1"],
                                                [m.sum_of("u"), m.COUNT]),
    "term_order_a": lambda m: m.query("qc", ["x4"], [m.agg(m.Var("u"), m.Delta("x1", "==", 1))]),
    "term_order_b": lambda m: m.query("qd", ["x4"], [m.agg(m.Delta("x1", "==", 1), m.Var("u"))]),
    "const_int": lambda m: m.query("qe", [], [m.agg(m.Var("u"), m.Delta("x2", "<", 2))]),
    "const_float": lambda m: m.query("qf", [], [m.agg(m.Var("u"), m.Delta("x2", "<", 2.0))]),
    "const_np": lambda m: m.query("qg", [], [m.agg(m.Var("u"),
                                                   m.Delta("x2", "<", np.float32(2)))]),
    "const_other": lambda m: m.query("qh", [], [m.agg(m.Var("u"), m.Delta("x2", "<", 3))]),
    "var": lambda m: m.query("qi", [], [m.sum_of("u")]),
    "pow": lambda m: m.query("qj", [], [m.agg(m.Pow("u", 2))]),
    "agg_order": lambda m: m.query("qk", [], [m.sum_of("u"), m.COUNT]),
    "filter_on_one": lambda m: m.query("qm", [], [m.agg(m.Var("u"), m.Delta("x1", "==", 1)),
                                                  m.COUNT]),
    "filter_on_both": lambda m: m.query("qn", [], [m.agg(m.Var("u"), m.Delta("x1", "==", 1)),
                                                   m.agg(m.Delta("x1", "==", 1))]),
    "param_threshold": lambda m: m.query("qp", ["x4"], [m.agg(m.Var("u"),
                                                              m.Delta("x1", "==", m.Param("t")))]),
    "tagged_udaf": lambda m: m.query("qt", ["x2"], [m.agg(_udaf(m, "twice"))]),
    "untagged_udaf": lambda m: m.query("qu", ["x2"], [m.agg(_udaf(m, ""))]),
}


@pytest.mark.parametrize("case", sorted(SIGNATURE_CASES))
def test_signature_key_matches_reference(case):
    """signature_of(q).key(), its filters, agg_renders(q) and routable(q)
    are the same in both packages."""
    tq, jq = SIGNATURE_CASES[case](T), SIGNATURE_CASES[case](J)
    ts, js = signature_of(tq), JW.signature_of(jq)
    assert ts.key() == js.key() and ts.to_dict() == js.to_dict()
    assert obs.agg_renders(tq) == JW.agg_renders(jq)
    assert routable(tq) == JW.routable(jq) == (case != "untagged_udaf")


def test_signature_canonicalization_commutes():
    """Within the port: the orders that only permute axes or columns, and
    the spellings of a constant, share a key; different structure does
    not (tests/test_obs.py)."""
    key = {c: signature_of(f(T)).key() for c, f in SIGNATURE_CASES.items()}
    assert key["dims_order_a"] == key["dims_and_aggs_permuted"]
    assert key["term_order_a"] == key["term_order_b"]
    assert key["const_int"] == key["const_float"] == key["const_np"]
    assert key["const_int"] != key["const_other"]
    assert key["dims_order_a"] != key["term_order_a"]
    assert key["var"] != key["pow"]
    assert key["filter_on_one"] != key["filter_on_both"]
    k = SIGNATURE_CASES["agg_order"](T)
    assert obs.agg_renders(k) == ("u", "1") and signature_of(k).aggs == ("1", "u")
    d = signature_of(SIGNATURE_CASES["term_order_a"](T))
    assert d.filters == ("x1==1.0",) and d.aggs == ("1[x1==1.0]*u",)


# ------------------------------------------------------------------- workload

def test_workload_recorder_bounded_and_aggregates(tmp_path):
    rec = WorkloadRecorder(capacity=4)
    sig = signature_of(queries()[0])
    for i in range(10):
        rec.record("read", "q_count", sig, "pinned_read", 100.0 + i, epoch=i)
    assert rec.n_recorded == 10 and rec.n_dropped == 6
    assert len(rec.records()) == 4
    e = rec.by_signature()[sig.key()]
    assert e["n"] == 4 and e["hits"] == {"pinned_read": 4}
    assert e["views"] == ["q_count"]
    assert e["latency_us_mean"] == pytest.approx(107.5)
    path = tmp_path / "workload.json"
    payload = rec.export_json(str(path))
    on_disk = json.loads(path.read_text())
    assert on_disk["n_recorded"] == payload["n_recorded"] == 10
    assert len(on_disk["records"]) == 4
    off = WorkloadRecorder(capacity=0)
    off.record("read", "q", sig, "pinned_read", 1.0)
    assert not off.enabled and off.n_recorded == 0
    with pytest.raises(ValueError, match="capacity"):
        WorkloadRecorder(capacity=-1)


def test_workload_records_every_path():
    """One signature per view through every hit path: batch scan,
    maintained full scan, epoch read, pinned serving read."""
    db = session()
    db.views(queries()).run()                       # batch_scan
    live = db.views(queries(), maintain=True)
    live.run()                                      # full_scan
    live.run()                                      # epoch_read
    srv = live.serve()
    srv.read()                                      # pinned_read x all views
    srv.read("q_g1")                                # pinned_read x one view
    by = db.workload.by_signature()
    assert len(by) == len(queries())
    for q in queries():
        e = by[signature_of(q).key()]
        assert e["hits"]["batch_scan"] == 1
        assert e["hits"]["full_scan"] == 1
        assert e["hits"]["epoch_read"] == 1
        assert e["hits"]["pinned_read"] >= 1
        assert e["latency_us_mean"] > 0
    assert by[signature_of(queries()[1]).key()]["hits"]["pinned_read"] == 2
    db0 = session(workload_capacity=0)
    db0.views(queries()).run()
    assert db0.workload.n_recorded == 0


# ------------------------------------------------- wiring: compile/IVM/serve

#: tests/test_obs.py's span set, and the verifier's and the checkpoint's
SPAN_NAMES = {"compile", "compile.roots", "compile.pushdown", "compile.group",
              "compile.ir", "compile.schedule", "compile.bind",
              "ivm.init", "ivm.apply", "ivm.validate", "ivm.tick",
              "ivm.publish", "serve.read", "compile.verify", "serve.checkpoint"}


def test_spans_thread_through_engine(tracing, tmp_path):
    """One session through compile -> init -> tick -> serve -> checkpoint
    leaves the reference's span names in the trace (compile.verify: the
    verifier runs under pytest), and the chrome export loads."""
    db = session()
    db.views(queries()).run()
    live = db.views(queries(), maintain=True)
    live.run()
    rng = np.random.default_rng(3)
    live.apply(DeltaBatchUpdate().insert("R2", r2_rows(rng, 3)))
    srv = live.serve(max_pinned_epochs=4)
    srv.read("q_count")
    srv.checkpoint(str(tmp_path / "ckpt"))
    evs = tracing.events()
    assert SPAN_NAMES <= {e["name"] for e in evs}
    tick = next(e for e in evs if e["name"] == "ivm.tick")
    assert tick["args"]["rel"] == "R2"
    path = tmp_path / "trace.json"
    obs.export_chrome(str(path))
    assert json.loads(path.read_text())["traceEvents"]


def test_server_stats_latency_lag_and_warning(caplog):
    db = session()
    live = db.views(queries(), maintain=True)
    srv = live.serve(max_pinned_epochs=8, warn_epoch_lag=1)
    rng = np.random.default_rng(5)

    def upd():
        return DeltaBatchUpdate().insert("R2", r2_rows(rng, 2))

    srv.read()
    with caplog.at_level(logging.WARNING, logger="repro_torch.serve"):
        with srv.snapshot() as snap:               # laggard pin
            assert snap.epoch_lag == 0
            srv.apply(upd())
            srv.apply(upd())
            assert snap.epoch_lag == 2
            st = srv.stats()
            assert st["epoch_lag"] == 2 and st["n_lag_warnings"] >= 1
    assert any("pinned readers lag served head" in r.message for r in caplog.records)
    assert srv.epoch_lag == 0
    st = srv.stats()
    assert st["read_us"]["count"] == 1 and st["read_us"]["p50"] > 0
    assert st["tick_us"]["count"] == 2             # the full scan not counted
    assert st["pinned_epochs_hwm"] >= 1 and st["shard"] is None
    assert live.maintained.metrics.snapshot()["ivm.tick_us"]["count"] == 2


@pytest.mark.parametrize("field,value", [
    ("warn_epoch_lag", 0), ("max_pinned_epochs", 0), ("workload_capacity", -1),
    ("workload_capacity", True), ("route_cache_capacity", -1),
    ("route_cache_capacity", 1.5), ("verify_plans", "yes")])
def test_execution_config_validates_serving_knobs(field, value):
    with pytest.raises(ValueError, match=field):
        repro_torch.ExecutionConfig(**{field: value})


def test_view_server_validates_its_knobs():
    mb = session().views(queries(), maintain=True).maintained
    with pytest.raises(ValueError, match="warn_epoch_lag"):
        ViewServer(mb, warn_epoch_lag=0)
    with pytest.raises(ValueError, match="max_pinned_epochs"):
        ViewServer(mb, max_pinned_epochs=0)

"""The port's block-size autotuner (``core/autotune.py``) on the CPU: the
behaviours of tests/test_autotune.py (cache hits do zero timing work, the
cache survives a restart, corrupt or stale state degrades without raising),
the card's candidate grid and its payload budget, ``block_size="auto"``
results against static blocking and the reference, the IVM delta lane, and
the spans of tests/test_obs.py.  Result tolerance: rtol/atol 1e-4, the
reference's between its backends (tests/test_backends.py:36).
"""

import json

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
from repro_torch import obs
from repro_torch.core import aggregates as T
from repro_torch.core import autotune as at
from repro_torch.core.autotune import (Autotuner, TuneSignature,
                                       signature_for_step)
from repro_torch.core.schema import schema as tschema
from repro_torch.data import datasets as TD
from repro_torch.data import relations as TR
from repro_torch.kernels import ops
from repro_torch.ml import covar as tcovar

TOL = dict(rtol=1e-4, atol=1e-4)


def _sig(**kw):
    base = dict(backend="cuda", platform="cpu", n_rows=4096, n_segments=128,
                payload_width=16, n_nodes=None)
    base.update(kw)
    return signature_for_step(**base)


@pytest.fixture
def fast_tuner(monkeypatch):
    """Autotuner factory whose candidate timing is instant but still counts
    ``n_timed`` — tests assert on the counters, not wall time."""
    def make(path):
        t = Autotuner(str(path))

        def fake_time_candidates(sig):
            t.n_timed += len(at.BLOCK_SIZE_CANDIDATES)
            return 1 << 18
        monkeypatch.setattr(t, "_time_candidates", fake_time_candidates)
        return t
    return make


# ------------------------------------------- the behaviours of test_autotune

def test_signature_buckets_and_key():
    a = _sig(n_rows=4000)
    b = _sig(n_rows=4096)
    assert a.key() == b.key()          # same pow2 bucket -> same cache line
    assert _sig(n_rows=5000).key() != a.key()
    assert _sig(n_nodes=8).key() != a.key()
    assert _sig(backend="torch").key() != a.key()
    assert _sig(platform="cuda").key() != a.key()
    assert a.key().startswith(f"v{at.CACHE_VERSION}/cuda/cpu/r4096/")
    assert not hasattr(a, "interpret")     # no kernel grid to tune


def test_delta_signature_gets_own_cache_lane():
    a = _sig(n_rows=4096)
    d = _sig(n_rows=4096, delta=True)
    assert d.key() != a.key()
    assert d.key().endswith("/d1") and a.key().endswith("/d0")


def test_cache_hit_does_zero_timing(fast_tuner, tmp_path):
    t = fast_tuner(tmp_path / "cache.json")
    r1 = t.tune(_sig())
    assert r1.block_size == 1 << 18 and not hasattr(r1, "block_rows")
    assert not r1.from_cache and t.n_misses == 1 and t.n_timed > 0
    timed_after_miss = t.n_timed
    r2 = t.tune(_sig(n_rows=4000))     # same bucket -> hit, no timing
    assert r2.from_cache and r2.block_size == 1 << 18
    assert t.n_hits == 1 and t.n_timed == timed_after_miss


def test_cache_survives_restart(fast_tuner, tmp_path):
    path = tmp_path / "cache.json"
    fast_tuner(path).tune(_sig())
    fresh = Autotuner(str(path))       # "new process": no monkeypatch needed
    r = fresh.tune(_sig())
    assert r.from_cache and r.block_size == 1 << 18
    assert fresh.n_timed == 0 and fresh.n_hits == 1 and fresh.n_misses == 0


def test_corrupt_cache_file_retunes_without_raising(fast_tuner, tmp_path):
    path = tmp_path / "cache.json"
    path.write_text("{not json!!")
    t = fast_tuner(path)
    r = t.tune(_sig())                 # load failure -> empty cache -> re-tune
    assert not r.from_cache and t.n_misses == 1
    blob = json.loads(path.read_text())     # the re-tune rewrote a valid file
    assert blob["version"] == at.CACHE_VERSION and blob["entries"]


def test_corrupt_entry_falls_back_to_default(fast_tuner, tmp_path):
    path = tmp_path / "cache.json"
    path.write_text(json.dumps({"version": at.CACHE_VERSION,
                                "entries": {_sig().key(): {"block_size": "huge"}}}))
    t = fast_tuner(path)
    r = t.tune(_sig())
    assert r.fallback and not r.from_cache
    assert r.block_size == at.DEFAULT_BLOCK_SIZE
    assert t.n_fallbacks == 1 and t.n_timed == 0


def test_stale_version_discarded(fast_tuner, tmp_path):
    path = tmp_path / "cache.json"
    path.write_text(json.dumps({"version": at.CACHE_VERSION + 1,
                                "entries": {_sig().key(): {"block_size": 1024}}}))
    t = fast_tuner(path)
    r = t.tune(_sig())                 # version mismatch -> whole cache dropped
    assert not r.from_cache and t.n_misses == 1


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_real_timing_probe_smoke(tmp_path, backend):
    """One un-mocked tune per backend: the probes run (the kernel's plain
    version or index_add_ on the CPU) and give a candidate."""
    path = str(tmp_path / "cache.json")
    sig = _sig(backend=backend, n_rows=1 << 17, n_segments=16,
               payload_width=4)
    t = Autotuner(path)
    r = t.tune(sig)
    assert r.block_size in at.candidates(sig) == (1 << 16, 1 << 17)
    assert t.n_timed == 2
    warm = Autotuner(path)
    r2 = warm.tune(sig)
    assert r2.from_cache and r2.block_size == r.block_size
    assert warm.n_timed == 0


# ------------------------------------------------ the card's candidate grid

def test_candidates_collapse_to_one_block_and_respect_the_payload_budget():
    # every grid size below the bucketed row count; past it, one block
    assert at.candidates(_sig(n_rows=1 << 23, payload_width=4)) == \
        at.BLOCK_SIZE_CANDIDATES
    assert at.candidates(_sig(n_rows=300_000, payload_width=4)) == \
        (1 << 16, 1 << 18, 1 << 19)
    assert at.candidates(_sig(n_rows=1000)) == (1024,)
    # the maintained covar batch's fact reduction (2,024 columns): 2²² rows
    # would be a 34 GB payload block, dropped
    wide = _sig(n_rows=84_000_000, payload_width=2024)
    assert at.candidates(wide) == (1 << 16, 1 << 18, 1 << 20)
    assert all(c * wide.payload_width * 4 <= at.MAX_BLOCK_PAYLOAD_BYTES
               for c in at.candidates(wide))
    # wider than any candidate's budget: the smallest stays
    assert at.candidates(_sig(n_rows=1 << 23, payload_width=1 << 16)) == \
        (1 << 16,)


def test_probe_rows_fit_the_byte_budget():
    sig = _sig(n_rows=1 << 23, payload_width=4)
    assert at.probe_rows(sig, at.candidates(sig)) == 1 << 23  # 2 × 2²² blocks
    wide = _sig(n_rows=1 << 27, payload_width=2048)
    n = at.probe_rows(wide, at.candidates(wide))
    assert n * wide.payload_width * 4 <= at.MAX_PROBE_BYTES
    assert n == 1 << 18
    assert at.probe_rows(_sig(n_rows=100), (128,)) == 128


def test_only_candidates_the_probe_can_tell_apart_are_timed():
    """A candidate the probe runs as one block of all its rows times the
    same as every larger one: only the largest of those is timed."""
    wide = _sig(n_rows=1 << 27, payload_width=2048)   # the maintained fact
    cands = at.candidates(wide)
    n = at.probe_rows(wide, cands)
    assert at.timed_candidates(cands, n) == (1 << 16, 1 << 20)
    assert at.timed_candidates(at.BLOCK_SIZE_CANDIDATES, 1 << 23) == \
        at.BLOCK_SIZE_CANDIDATES
    assert at.timed_candidates((1024,), 1024) == (1024,)


def test_capped_probe_times_the_largest_one_block_candidate(tmp_path,
                                                            monkeypatch):
    """With the probe capped at 2¹⁷ rows, 2¹⁸ and 2²⁰ would both run one
    block: the tuner times 2¹⁶ and 2²⁰ only."""
    monkeypatch.setattr(at, "MAX_PROBE_BYTES", (1 << 17) * 4 * 4)
    t = Autotuner(str(tmp_path / "cache.json"))
    sig = _sig(backend="torch", n_rows=1 << 20, n_segments=4, payload_width=4)
    r = t.tune(sig)
    assert t.n_timed == 2 and r.block_size in (1 << 16, 1 << 20)


def test_default_cache_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "/elsewhere/reference.json")
    assert at.default_cache_path().endswith("repro_torch/autotune.json")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", "/x/port.json")
    assert at.default_cache_path() == "/x/port.json"


# ------------------------------------------------------- "auto" end to end

@pytest.fixture(scope="module")
def retailer_ref():
    jds = JD.make("retailer", scale=0.02)
    C, N, _, _ = jcovar.compute_covar(jds, backend="xla")
    return np.asarray(C), N


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_auto_blocking_matches_static_and_reference(tmp_path, retailer_ref,
                                                    backend):
    """block_size="auto" resolves one block per step at bind time, records
    them in plan.last_autotune, and gives the static blocking's results and
    the reference's (tests/test_backends.py:226); a second session on the
    same cache times nothing."""
    ds = TD.make("retailer", scale=0.02)
    cache = str(tmp_path / "autotune.json")
    db = repro_torch.connect(ds, device="cpu")
    auto = db.with_config(backend=backend, block_size="auto",
                          autotune_cache=cache)
    C, N, _, batch = tcovar.compute_covar(ds, database=auto)
    rep = batch.plan.last_autotune
    steps = batch.schedule.steps
    assert [r["rel"] for r in rep] == [s.rel for s in steps]
    assert all(r["block_size"] in at.BLOCK_SIZE_CANDIDATES
               or r["block_size"] < min(at.BLOCK_SIZE_CANDIDATES)
               for r in rep)
    assert all(f"/{backend}/cpu/" in r["key"] for r in rep)
    assert batch.plan.autotuner.n_timed > 0
    Cs, Ns, _, _ = tcovar.compute_covar(
        ds, database=db.with_config(backend=backend))
    assert N == Ns == retailer_ref[1]
    np.testing.assert_allclose(C, Cs, **TOL)
    np.testing.assert_allclose(C, retailer_ref[0], **TOL)
    _, _, _, warm = tcovar.compute_covar(ds, database=auto.with_config())
    assert warm.plan.autotuner.n_timed == 0
    assert all(r["from_cache"] for r in warm.plan.last_autotune)


SPEC = ([("x1", "categorical", 3), ("x2", "key", 4), ("x3", "key", 5),
         ("x4", "categorical", 3), ("u", "continuous", 0)],
        [("R1", ["x1", "x2"]), ("R2", ["x2", "x3", "u"]), ("R3", ["x3", "x4"])])


def make_tables(seed=0):
    rng = np.random.default_rng(seed)
    return {"R1": {"x1": rng.integers(0, 3, 17), "x2": rng.integers(0, 4, 17)},
            "R2": {"x2": rng.integers(0, 4, 29), "x3": rng.integers(0, 5, 29),
                   "u": rng.normal(size=29).astype(np.float32)},
            "R3": {"x3": rng.integers(0, 5, 13), "x4": rng.integers(0, 3, 13)}}


def queries(mod):
    return [mod.query("q_count", [], [mod.COUNT]),
            mod.query("q_sums", [], [mod.sum_of("u"), mod.agg(mod.Pow("u", 2))]),
            mod.query("q_g1", ["x1"], [mod.COUNT, mod.sum_of("u")]),
            mod.query("q_delta", ["x4"],
                      [mod.agg(mod.Var("u"), mod.Delta("x1", "==", 1))])]


def r2_rows(rng, k):
    return {"x2": rng.integers(0, 4, k), "x3": rng.integers(0, 5, k),
            "u": rng.normal(size=k).astype(np.float32)}


def host(out):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in out.items()}


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_delta_lane_tunes_at_runner_build_only(tmp_path, backend):
    """A maintained view under "auto": the delta scans tune under delta=True
    signatures when the tick runner is built, a steady tick (same pad
    buckets) builds no runner and tunes nothing, and the results follow
    the reference's."""
    cfg = repro_torch.ExecutionConfig(
        backend=backend, block_size="auto",
        autotune_cache=str(tmp_path / "cache.json"))
    live = repro_torch.connect(tschema(*SPEC), tables=make_tables(),
                               device="cpu", config=cfg).views(
        queries(T), maintain=True)
    ref = repro.connect(jschema(*SPEC), tables=make_tables(),
                        config=repro.ExecutionConfig(block_size=8)).views(
        queries(J), maintain=True)
    live.run()
    ref.run()
    plan, mb = live.compiled.plan, live.maintained
    assert plan.last_autotune and plan.last_autotune_delta is None
    rng = np.random.default_rng(3)
    for i in range(3):        # 3 rows in and 3 out: the same pad buckets
        rows, gone = r2_rows(rng, 3), np.array([0, 4, 9])
        got = live.apply(TR.DeltaBatchUpdate().insert("R2", rows)
                         .delete("R2", gone))
        want = ref.apply(JR.DeltaBatchUpdate().insert("R2", rows)
                         .delete("R2", gone))
        g, w = host(got), host(want)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **TOL)
        if i == 0:
            rep = plan.last_autotune_delta
            delta_steps = [r for r in rep if r["delta"]]
            assert delta_steps and all(r["key"].endswith("/d1")
                                       for r in delta_steps)
            assert all(r["rel"] == "R2" for r in delta_steps)
            assert [r["rel"] for r in rep] == [
                s.rel for s in mb.delta_program("R2").steps]
            timed, builds = plan.autotuner.n_timed, mb.n_fold_traces
    assert mb.n_fold_traces == builds == 1
    assert plan.autotuner.n_timed == timed


@pytest.fixture
def tracing():
    obs.clear_trace()
    obs.enable_tracing()
    yield obs.get_tracer()
    obs.disable_tracing()
    obs.clear_trace()


def test_autotune_span_and_delta_provenance(tmp_path, tracing):
    """tests/test_obs.py:286: auto blocking resolves through autotune.tune
    spans, and explain() carries both labeled resolutions (batch + delta)
    for maintained views."""
    cfg = repro_torch.ExecutionConfig(
        block_size="auto", autotune_cache=str(tmp_path / "cache.json"))
    db = repro_torch.connect(tschema(*SPEC), tables=make_tables(),
                             device="cpu", config=cfg)
    live = db.views(queries(T), maintain=True)
    live.run()
    live.apply(TR.DeltaBatchUpdate().insert("R2", r2_rows(
        np.random.default_rng(3), 3)))
    rep = live.explain()
    assert rep.autotune and rep.autotune_delta
    s = rep.summary()
    assert "autotune[batch]:" in s and "autotune[delta]:" in s
    assert "bs=" in s and "br=" not in s
    names = {e["name"] for e in tracing.events()}
    assert {"compile.autotune", "autotune.tune", "autotune.probe"} <= names
    delta_spans = [e for e in tracing.events()
                   if e["name"] == "compile.autotune"
                   and e["args"].get("delta")]
    assert delta_spans


def test_auto_is_validated_like_the_reference():
    repro_torch.ExecutionConfig(block_size="auto")
    for bad in (0, -1, "large", True):
        with pytest.raises(ValueError, match="block_size"):
            repro_torch.ExecutionConfig(block_size=bad)


def test_cpu_auto_run_launches_no_kernel(tmp_path):
    ops.reset_launches()
    ds = TD.make("retailer", scale=0.02)
    tcovar.compute_covar(ds, database=repro_torch.connect(
        ds, device="cpu", config=repro_torch.ExecutionConfig(
            block_size="auto", autotune_cache=str(tmp_path / "c.json"))))
    assert sum(ops.LAUNCHES.values()) == 0      # CPU: plain versions


def test_auto_bind_needs_the_relations_device(tmp_path):
    """The probes run where the relations lie: an "auto" bind without the
    device raises instead of tuning somewhere else."""
    db = repro_torch.connect(tschema(*SPEC), tables=make_tables(), device="cpu",
                             config=repro_torch.ExecutionConfig(
                                 block_size="auto",
                                 autotune_cache=str(tmp_path / "c.json")))
    plan = db.views(queries(T)).compiled.plan
    with pytest.raises(ValueError, match="device"):
        plan.bind(db.sizes())
    run = plan.bind(db.sizes(), device="cpu")
    assert plan.last_autotune and run

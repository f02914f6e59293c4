"""The port's sharded IVM against the reference's single-device maintained
views on the CPU (tests/test_ivm_sharded.py:86-270).

Four gloo ranks (``tests/torch_dist_harness.py``) each run a sharded and a
local maintained batch over the same chain tables and the same mixed
update stream (inserts and deletes on the partitioned R2 and on the
replicated R1 and R3).  The parent holds every rank's results against the
reference's single-device batch (``xla``) at rtol/atol 1e-4 (the
reference's rule between its backends, tests/test_backends.py:36), and the
gathered relations against the reference's ``apply_delta``, row for row.
"""

import numpy as np
import pytest

import repro
from repro.core import aggregates as J
from repro.core.schema import schema as jschema
from repro.data import relations as JR
from torch_dist_harness import (SPEC, as_update, chain_queries, chain_tables,
                                ivm_snapshot_case, ivm_stream_case, run_ranks,
                                update_stream)

TOL = dict(rtol=1e-4, atol=1e-4)
WORLD = 4


def _close(got, want, msg):
    assert got.keys() == want.keys(), msg
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{msg} {k}",
                                   **TOL)


@pytest.fixture(scope="module")
def reference():
    """The reference's single-device maintained batch over the stream:
    results at init and after every apply, the relations at the end, and
    a routed ``q_x4``."""
    db = repro.connect(jschema(*SPEC), tables=chain_tables(),
                       config=repro.ExecutionConfig(block_size=8))
    v = db.views(chain_queries(J), maintain=True)

    def host(out):
        return {k: np.asarray(o, np.float64) for k, o in out.items()}

    out = {"init": host(v.run()), "steps": []}
    oracle = JR.from_numpy(jschema(*SPEC), chain_tables())
    for upd in update_stream():
        out["steps"].append(host(v.apply(as_update(JR, upd))))
        oracle = JR.apply_delta(oracle, as_update(JR, upd))
    out["relations"] = {name: {a: np.asarray(c) for a, c in
                               oracle.relation(name).columns.items()}
                        for name in ("R1", "R2", "R3")}
    out["route"] = np.asarray(db.route(J.query("q_x4", ["x4"], [J.COUNT]))
                              .value, np.float64)
    return out


@pytest.fixture(scope="module", params=["cuda", "torch"])
def stream(request, tmp_path_factory):
    """Every rank's results of ``ivm_stream_case`` on one backend."""
    return request.param, run_ranks(ivm_stream_case, WORLD,
                                    tmp_path_factory.mktemp("stream"),
                                    request.param)


def test_sharded_stream_matches_reference(stream, reference):
    """After every apply the sharded batch's results, on every rank, equal
    the reference's single-device results (and the port's local batch's)."""
    _, ranks = stream
    for r, res in enumerate(ranks):
        assert res["shard_rel"] == "R2"     # the largest relation
        got_s, got_l = res["init"]
        _close(got_s, reference["init"], f"rank {r} init")
        _close(got_l, reference["init"], f"rank {r} local init")
        for i, ((got_s, got_l), want) in enumerate(
                zip(res["steps"], reference["steps"])):
            _close(got_s, want, f"rank {r} apply {i}")
            _close(got_l, want, f"rank {r} local apply {i}")
        _close(*res["final"], f"rank {r} steady")


def test_gathered_relations_equal_apply_delta_rows(stream, reference):
    """The gathered relations restore the oracle's row order exactly (the
    gid contract), on every rank."""
    _, ranks = stream
    for res in ranks:
        for name, cols in reference["relations"].items():
            got = res["relations"][name]
            assert got.keys() == cols.keys()
            for a, c in cols.items():
                np.testing.assert_array_equal(got[a], c, err_msg=f"{name}.{a}")


def test_steady_ticks_build_no_runner(stream):
    """Same-size batches after warm-up build no tick runner (the local
    contract, tests/test_ivm_sharded.py:146), and every tick program
    carries its all-reduces."""
    _, ranks = stream
    for res in ranks:
        assert res["steady_builds"] == 0
        assert "psums @data" in res["tick"]["R2"]
        for k, (n_checks, invariants) in res["verify"].items():
            if k.startswith("tick Δ"):
                assert "psum-before-fold" in invariants and n_checks > 0


def test_explain_topology_and_sharded_router(stream, reference):
    """tests/test_ivm_sharded.py:248: ``explain()`` carries the topology;
    a routed miss under the mesh scans sharded and answers the
    reference's value."""
    backend, ranks = stream
    for res in ranks:
        t = res["shard"]
        assert (t["n_devices"], t["mesh_axis"], t["shard_rel"]) == \
            (WORLD, "data", "R2")
        assert t["rows_per_shard"] == -(-t["rows"] // WORLD)
        assert t["capacity_per_shard"] >= t["rows_per_shard"]
        assert t["psums_per_tick"]["R2"] >= 1
        s = res["summary"]
        assert s.startswith(f"[maintained] backend={backend} sharded")
        assert "devices=4" in s and "psums/tick" in s
        tier, value, hits = res["route"]
        assert tier == "compiled" and set(hits) == {"sharded_scan"}
        np.testing.assert_allclose(value, reference["route"], **TOL)


def test_snapshot_restores_across_placements(tmp_path, reference):
    """tests/test_ivm_sharded.py:114: a sharded snapshot (written by rank 0
    alone) restores into a local batch, a local one into a sharded batch,
    which keeps maintaining in step with the reference."""
    ranks = run_ranks(ivm_snapshot_case, WORLD, tmp_path, str(tmp_path))
    for r, res in enumerate(ranks):
        assert res["steps"] == (3, 3)
        assert res["files"] == ["step_00000003"]
        _close(*res["sharded_to_local"], f"rank {r} sharded->local")
        _close(*res["local_to_sharded"], f"rank {r} local->sharded")
        _close(res["local_to_sharded"][0], reference["steps"][2],
               f"rank {r} restored")
        for i, (got_s, got_l) in enumerate(res["post"]):
            _close(got_s, reference["steps"][3 + i], f"rank {r} post {i}")
            _close(got_l, reference["steps"][3 + i], f"rank {r} local {i}")

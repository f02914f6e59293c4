"""The comparison that decides ``correct`` fails what it must, at a size a
test run holds: the control (the reference in bfloat16 put in the
program's place) on each cell, and a whole run with the timed path broken
underneath, once for each fault the cell can have.  The benchmark's own
runs run neither."""

import time

import pytest
import torch

import repro_torch.api as api
import repro_torch.core.engine as engine
import repro_torch.core.ivm as ivm
import repro_torch.ml.online as online
import repro_torch.ml.trees as trees
from repro_torch.data import relations as rel_mod

from cardbench import control as control_cli
from cardbench.harness import cell as C
from cardbench.harness import spec

SMALL = {"fact_rows": 4000}
CELLS = ["retailer.covar", "retailer.ivm", "favorita.tree", "favorita.covar"]


def run(workload):
    c = spec.cell(workload)
    return C.run(c, 2**31 + 5, 0.3, False, "cpu", time.perf_counter(), overrides=SMALL)


def failed_numbers(cell, numbers):
    return [k for k, lim in cell.limits.items() if not numbers[k] <= lim]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload):
    c = spec.cell(workload)
    tables = c.data_maker().make(dict(c.config, **SMALL), 9, "cpu")
    ref = c.reference()
    numbers = ref.judge(tables, ref.control(tables, c.traffic, 9, 6))
    assert failed_numbers(c, numbers), numbers


def _half_fact(db):
    """The database with the second half of the largest relation left out."""
    rels = dict(db.relations)
    big = max(rels, key=lambda r: rels[r].n_rows)
    n = rels[big].n_rows // 2
    rels[big] = rel_mod.Relation(big, {a: c[:n] for a, c in rels[big].columns.items()})
    return rel_mod.Database(db.schema, rels)


def half_batch_call(mp):
    orig = engine.CompiledBatch.__call__
    mp.setattr(engine.CompiledBatch, "__call__", lambda self, db, params=None: {
        k: 2 * v for k, v in orig(self, _half_fact(db), params).items()})


def half_batch_batched(mp):
    orig = engine.CompiledBatch.run_batched
    mp.setattr(engine.CompiledBatch, "run_batched", lambda self, db, params, **kw: {
        k: 2 * v for k, v in orig(self, _half_fact(db), params, **kw).items()})


def altered_view(mp):
    orig = api.ViewHandle.run

    def run(self, params=None):
        out = dict(orig(self, params))
        out["cm_scalar"] = out["cm_scalar"].clone()
        out["cm_scalar"].view(-1)[0] *= 1.01        # the join's row count
        return out
    mp.setattr(api.ViewHandle, "run", run)


def state_unchanged(mp):
    mp.setattr(ivm.MaintainedBatch, "apply", lambda self, update, params=None: self.results())


def half_delta(mp):
    orig = online.OnlineRidge.update

    def update(self, upd):
        half = rel_mod.DeltaBatchUpdate()
        for rel, d in upd.updates.items():
            half.insert(rel, {a: c[:len(c) // 2] for a, c in d.inserts.items()})
            half.delete(rel, d.delete_idx[:len(d.delete_idx) // 2])
        return orig(self, half)
    mp.setattr(online.OnlineRidge, "update", update)


def altered_state(mp):
    orig = ivm.MaintainedBatch.results

    def results(self, epoch=None):
        out = dict(orig(self, epoch))
        out["cm_scalar"] = out["cm_scalar"] * torch.tensor(
            [1.01] + [1.0] * (out["cm_scalar"].numel() - 1)).view_as(out["cm_scalar"])
        return out
    mp.setattr(ivm.MaintainedBatch, "results", results)


def altered_stats(mp):
    orig = trees.split_stats

    def split_stats(outputs, features):
        out = orig(outputs, features)
        first = features[0].attr
        out[first] = out[first].copy()
        out[first][0, 0, 0] *= 1.01
        return out
    mp.setattr(trees, "split_stats", split_stats)


FAULTS = {
    "retailer.covar": [half_batch_call, altered_view],
    "favorita.covar": [half_batch_call, altered_view],
    "retailer.ivm": [state_unchanged, half_delta, altered_state],
    "favorita.tree": [half_batch_batched, altered_stats],
}


@pytest.mark.parametrize("workload,fault", [(w, f) for w, fs in FAULTS.items() for f in fs],
                         ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    out = run(workload)
    assert out["result"]["correct"] is False, out["notes"]["numbers"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_sound_path_is_correct(workload):
    assert run(workload)["result"]["correct"] is True

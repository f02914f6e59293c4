"""Small methods of the reference's public API, in the port, against the
reference on the CPU (numpy in, numpy out): ``OnlineRidge.update_fact``,
``MaintainedBatch.state``, ``Database.total_tuples`` and
``Relation.column``.  Tolerances as in tests/test_torch_ivm.py: covar
statistics at rtol/atol 1e-4 (float32 sums in different orders), θ at 5e-3
relative L2 (its ill-conditioned solve, see
``test_online_ridge_matches_reference``).
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
from repro.ml import online as jonline
from repro_torch.core import aggregates as T
from repro_torch.core.schema import schema as tschema
from repro_torch.data import datasets as TD
from repro_torch.data import relations as TR
from repro_torch.ml import online as tonline

TOL = dict(rtol=1e-4, atol=1e-4)
SPEC = ([("x1", "categorical", 3), ("x2", "key", 4), ("u", "continuous", 0)],
        [("R1", ["x1", "x2"]), ("R2", ["x2", "u"])])


def chain_tables(seed=0):
    rng = np.random.default_rng(seed)
    return {"R1": {"x1": rng.integers(0, 3, 17), "x2": rng.integers(0, 4, 17)},
            "R2": {"x2": rng.integers(0, 4, 29),
                   "u": rng.normal(size=29).astype(np.float32)}}


def chain_queries(mod):
    return [mod.query("q_count", [], [mod.COUNT]),
            mod.query("q_g1", ["x1"], [mod.COUNT, mod.sum_of("u")])]


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def retailer():
    return JD.make("retailer", scale=0.02), TD.make("retailer", scale=0.02)


@pytest.mark.parametrize("inserts,deletes", [(True, True), (True, False),
                                             (False, True)])
def test_update_fact_matches_reference(retailer, inserts, deletes):
    """``update_fact`` with inserts, deletes or both: N exact, C at 1e-4
    and θ at 5e-3 of the reference's; the same update as a
    ``DeltaBatchUpdate`` through ``update`` gives the same bits."""
    jds, tds = retailer
    ref = jonline.OnlineRidge(jds)
    ref.fit()
    olr = tonline.OnlineRidge(tds, device="cpu")
    olr.fit()
    twin = tonline.OnlineRidge(tds, device="cpu")
    twin.fit()
    fact = tds.tables[tds.fact]
    n = len(fact[tds.label])
    rng = np.random.default_rng(17)
    pick = rng.integers(0, n, 12)
    ins = {a: np.asarray(c)[pick] for a, c in fact.items()} if inserts else None
    dels = rng.choice(n, 12, replace=False) if deletes else None
    want = ref.update_fact(inserts=ins, delete_idx=dels)
    got = olr.update_fact(inserts=ins, delete_idx=dels)
    assert olr.N == ref.N
    assert olr.N == n + 12 * (int(inserts) - int(deletes))
    np.testing.assert_allclose(olr.C, ref.C, **TOL)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 5e-3
    upd = TR.DeltaBatchUpdate()
    if ins is not None:
        upd.insert(tds.fact, ins)
    if dels is not None:
        upd.delete(tds.fact, dels)
    np.testing.assert_array_equal(twin.update(upd), got)
    assert olr.maintained.step == ref.maintained.step == 1


def test_maintained_state_matches_reference():
    """``state``: None before init, then the current epoch's view tensors
    by vid, the reference's keys and values, after init and after an
    update; a copy of the mapping, not the epoch's own."""
    tables = chain_tables()
    ref = repro.connect(jschema(*SPEC), tables=tables,
                        config=repro.ExecutionConfig(block_size=8)
                        ).views(chain_queries(J), maintain=True)
    port = repro_torch.connect(tschema(*SPEC), tables=tables, device="cpu",
                               config=repro_torch.ExecutionConfig(block_size=8)
                               ).views(chain_queries(T), maintain=True)
    assert port.maintained.state is None and ref.maintained.state is None
    rng = np.random.default_rng(4)
    upd = [("R2", {"x2": rng.integers(0, 4, 5),
                   "u": rng.normal(size=5).astype(np.float32)}, np.array([0, 3]))]
    for step in range(2):
        if step == 0:
            ref.run()
            port.run()
        else:
            ju, tu = JR.DeltaBatchUpdate(), TR.DeltaBatchUpdate()
            for rel, ins, dels in upd:
                ju.insert(rel, ins).delete(rel, dels)
                tu.insert(rel, ins).delete(rel, dels)
            ref.apply(ju)
            port.apply(tu)
        got, want = port.maintained.state, ref.maintained.state
        assert sorted(got) == sorted(want)
        for vid in want:
            np.testing.assert_allclose(host(got[vid]), host(want[vid]),
                                       err_msg=str(vid), **TOL)
        got.clear()
        assert port.maintained.state.keys() == want.keys()


def test_database_total_tuples_and_relation_column():
    """``Database.total_tuples`` and ``Relation.column`` over the same
    numpy tables in both packages, and over the port's session data."""
    tables = chain_tables(seed=2)
    jdb = JR.from_numpy(jschema(*SPEC), tables)
    tdb = TR.from_numpy(tschema(*SPEC), tables, torch.device("cpu"))
    assert tdb.total_tuples() == jdb.total_tuples() == 17 + 29
    for name, cols in tables.items():
        for attr in cols:
            got = tdb.relation(name).column(attr)
            assert got is tdb.relation(name).columns[attr]
            np.testing.assert_array_equal(host(got),
                                          host(jdb.relation(name).column(attr)))
    session = repro_torch.connect(tschema(*SPEC), tables=tables, device="cpu")
    assert session.data.total_tuples() == 46

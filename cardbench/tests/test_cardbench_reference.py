"""The plain references against independent numpy computations at a small
size: the join looked up by each dimension's own key columns, the design
matrix by ``np.eye``, the tree's statistics by ``np.bincount``, the
replayed fact by ``np.delete`` and ``np.concatenate``."""

import numpy as np
import pytest
import torch

from cardbench.harness import spec
from cardbench.reference import covar, ivm_ridge, tree

N = 12_000


def tables(workload="retailer.covar", seed=4):
    c = spec.cell(workload)
    return c.data_maker().make(dict(c.config, fact_rows=N), seed, "cpu")


def numpy_join(t):
    """Every attribute's column over the join, each dimension row found by
    a lookup table over its own key columns."""
    cols = {a: c.numpy() for a, c in t.columns[t.fact].items()}
    done, todo = {t.fact}, list(t.edges)
    while todo:
        for a, b in list(todo):
            par, ch = (a, b) if a in done else (b, a) if b in done else (None, None)
            if par is None:
                continue
            todo.remove((a, b))
            dim = {k: v.numpy() for k, v in t.columns[ch].items()}
            keys = [k for k in dim if k in set(t.rel_attrs(par))]
            doms = [t.domain(k) for k in keys]
            lut = np.full(int(np.prod(doms)), -1)
            lut[np.ravel_multi_index([dim[k] for k in keys], doms)] = np.arange(len(dim[keys[0]]))
            rows = lut[np.ravel_multi_index([cols[k] for k in keys], doms)]
            assert (rows >= 0).all()
            for k, v in dim.items():
                cols.setdefault(k, v[rows])
            done.add(ch)
    return cols


def numpy_design(t, cols):
    parts = [np.ones((N, 1))]
    parts += [cols[a][:, None].astype(np.float64) for a in t.features_cont]
    parts += [np.eye(t.domain(a))[cols[a]] for a in t.features_cat]
    parts += [cols[t.label][:, None].astype(np.float64)]
    return np.hstack(parts)


@pytest.mark.parametrize("workload", ["retailer.covar", "favorita.covar"])
def test_covar_is_numpys(workload):
    t = tables(workload)
    X = numpy_design(t, numpy_join(t))
    G = covar.xtx(t)
    assert np.allclose(G, X.T @ X, rtol=1e-12, atol=1e-6)
    assert covar.judge(t, {"C": [X.T @ X]})["covar_err"] < 1e-12


def test_tree_level_statistics_are_numpys():
    t = tables("favorita.tree")
    cols = numpy_join(t)
    y = cols[t.label].astype(np.float64)
    thr = 7
    nodes = [dict(depth=0, feature="transactions__b", kind="ordered", threshold=thr, left=1, right=2),
             dict(depth=1, feature=None, kind="", threshold=-1, left=-1, right=-1),
             dict(depth=1, feature=None, kind="", threshold=-1, left=-1, right=-1)]
    join = tree.GatheredJoin(t)
    got = tree.level_stats(join, t, nodes, [1, 2])
    for side, sel in enumerate([cols["transactions__b"] <= thr, cols["transactions__b"] > thr]):
        for a, _, d in tree.features(t):
            code = cols[a][sel]
            want = np.stack([np.bincount(code, w, minlength=d)
                             for w in (np.ones(sel.sum()), y[sel], y[sel] ** 2)], 1)
            assert np.allclose(got[a][0][side], want, rtol=1e-12, atol=1e-6), a


def test_tree_judge_reads_its_own_fit_as_exact():
    t = tables("favorita.tree")
    params = {"max_depth": 3, "min_instances": 500, "max_nodes": 15}
    fit = tree.grow(t, params, torch.float64)
    assert sum(nd["left"] >= 0 for nd in fit["nodes"]) > 0
    got = tree.judge(t, {"params": params, "trees": [fit]})
    assert got == {"stat_err": 0.0, "split_regret": 0.0}


def test_ivm_replay_is_numpys():
    t = tables()
    g = torch.Generator().manual_seed(0)
    fact = {a: c.numpy() for a, c in t.columns[t.fact].items()}
    ticks = []
    want = dict(fact)
    for _ in range(3):
        pick = torch.randint(0, N, (120,), generator=g)
        dels = torch.randperm(N, generator=g)[:120]
        ticks.append({"pick": pick, "dels": dels})
        want = {a: np.concatenate([np.delete(c, dels.numpy()), fact[a][pick.numpy()]])
                for a, c in want.items()}
    got = ivm_ridge.replay(t, ticks)
    for a in fact:
        assert np.array_equal(got[a].numpy(), want[a]), a
    X = numpy_design(t, numpy_join(type(t)(**{**t.__dict__, "columns": {
        **t.columns, t.fact: {a: torch.from_numpy(v) for a, v in want.items()}}})))
    res = ivm_ridge.judge(t, {"ticks": ticks, "C": X.T @ X, "resident": got})
    assert res["rows_off"] == 0 and res["covar_err"] < 1e-12


def test_a_fact_row_without_its_dimension_row_drops_out():
    t = tables("favorita.covar")
    full = covar.xtx(t)
    tx = t.columns["Transactions"]
    gone = (tx["date"][0].item(), tx["store_nbr"][0].item())
    keep = ~((tx["date"] == gone[0]) & (tx["store_nbr"] == gone[1]))
    t2 = type(t)(**{**t.__dict__, "columns": {
        **t.columns, "Transactions": {a: c[keep] for a, c in tx.items()}}})
    s = t.columns["Sales"]
    hit = int(((s["date"] == gone[0]) & (s["store_nbr"] == gone[1])).sum())
    assert hit > 0
    assert covar.xtx(t2)[0, 0] == full[0, 0] - hit

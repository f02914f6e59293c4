"""The port's decision-tree path against the reference on the CPU.

The same numpy tables and masks (made from a seed) go through ``repro``
(the ``pallas`` backend in interpret mode: the reference's ``xla`` tree path
has a known failure, ROADMAP Queue 3) and ``repro_torch`` (the ``cuda``
backend, whose kernel wrappers run their plain versions on CPU tensors),
fused and unfused.  Tolerance: rtol/atol 1e-4, the reference's own between
its backends (tests/test_backends.py): float32 sums taken in different
orders.  Trees are compared split by split: features, kinds and thresholds
exactly, counts and predictions at rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import aggregates as J
from repro.core.schema import schema as jschema
from repro.data import datasets as JD
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.ml import forest as jforest
from repro.ml import trees as jtrees
from repro_torch.core import aggregates as T
from repro_torch.core.schema import schema as tschema
from repro_torch.data import datasets as TD
from repro_torch.kernels import ops
from repro_torch.ml import forest as tforest
from repro_torch.ml import trees as ttrees

TOL = dict(rtol=1e-4, atol=1e-4)
SCALE = 0.02
REG = dict(task="regression", max_depth=3, min_instances=50, max_nodes=15)
CLS = dict(task="classification", label="c_preferred", max_depth=2,
           min_instances=50, max_nodes=7)
RF = dict(n_trees=3, max_depth=2, min_instances=50, max_nodes=7, seed=7)
GBT = dict(n_rounds=2, learning_rate=0.5, max_depth=2, min_instances=50)


def _cpu(ds, **cfg):
    return repro_torch.connect(ds, device="cpu",
                               config=repro_torch.ExecutionConfig(**cfg))


def _masks(features, n, seed):
    """``n`` distinct random 0/1 node masks per feature."""
    rng = np.random.default_rng(seed)
    return [{f.attr: (rng.random(f.domain) < 0.7).astype(np.float32)
             for f in features} for _ in range(n)]


def _assert_same_tree(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.feature, g.kind, g.threshold, g.left, g.right) == \
            (w.feature, w.kind, w.threshold, w.left, w.right)
        np.testing.assert_allclose(g.n, w.n, rtol=1e-4)
        np.testing.assert_allclose(g.prediction, w.prediction, **TOL)


class _PerNode:
    """The reference's ``run_batched`` answered by its per-node path: one
    pallas run per node through a single compiled, unbatched batch.  The
    reference ensembles fit with it run their own algorithm unchanged,
    compiling once instead of once per frontier width."""

    def __init__(self, view):
        self.view = view

    def run_batched(self, params):
        n = len(next(iter(params.values())))
        outs = [self.view.run({k: v[i] for k, v in params.items()})
                for i in range(n)]
        return {q: np.stack([np.asarray(o[q]) for o in outs]) for q in outs[0]}


# ------------------------------------------------------------------ kernel

@pytest.mark.parametrize("n_nodes", [1, 3, 16])
@pytest.mark.parametrize("n_buckets", [2, 40, 480])
def test_tree_hist_batched_plain_matches_reference(n_nodes, n_buckets):
    n = 777 + n_nodes                            # ragged against 512-row grids
    rng = np.random.default_rng(n_nodes * 1000 + n_buckets)
    spill = max(1, n_buckets // 10)
    codes = rng.integers(-spill, n_buckets + spill, n).astype(np.int32)
    y = rng.normal(size=n).astype(np.float32)
    cond = (rng.random((n, n_nodes)) < 0.5).astype(np.float32)
    got = ops.tree_hist_batched(torch.from_numpy(codes), torch.from_numpy(y),
                                torch.from_numpy(cond), n_buckets)
    assert tuple(got.shape) == (n_nodes, n_buckets, 3)
    jargs = (jnp.asarray(codes), jnp.asarray(y), jnp.asarray(cond), n_buckets)
    want = jref.tree_hist_batched_ref(*jargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jops.tree_hist_batched(*jargs, block_rows=512, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # out-of-range codes contribute nowhere
    ok = (codes >= 0) & (codes < n_buckets)
    np.testing.assert_allclose(got.numpy()[:, :, 0].sum(1),
                               cond[ok].sum(0), rtol=1e-5)


# ------------------------------------------------------- run_batched vs ref

@pytest.fixture(scope="module")
def batched_refs():
    """Per dataset: the reference pallas run_batched outputs for N=3
    distinct random masks (padded to 4 inside), and the masks."""
    out = {}
    for name in ("favorita", "retailer"):
        jds = JD.make(name, scale=SCALE)
        jdt = jtrees.DecisionTree(jds, max_depth=1, min_instances=10,
                                  backend="pallas")
        masks = _masks(jdt.features, 3, seed=len(name))
        params = jtrees.stack_mask_params(jdt.features, masks)
        want = {k: np.asarray(v, np.float64)
                for k, v in jdt.view.run_batched(params).items()}
        out[name] = (params, want)
    return out


@pytest.mark.parametrize("name,fuse,launches", [
    ("favorita", True, 11), ("favorita", False, 23),
    ("retailer", True, 9), ("retailer", False, 19)])
def test_run_batched_matches_reference(batched_refs, name, fuse, launches):
    params, want = batched_refs[name]
    ds = TD.make(name, scale=SCALE)
    # 256-row blocks: several blocks per relation, a ragged last block
    dt = ttrees.DecisionTree(ds, max_depth=1, min_instances=10,
                             database=_cpu(ds, block_size=256,
                                           fuse_kernels=fuse))
    assert dt.batch.stats.n_kernel_launches == launches
    assert all(vp.batched for prog in dt.batch.plan.step_programs
               for vp in prog.views)
    ops.reset_launches()
    before = dt.batch.n_dispatches
    got = dt.view.run_batched(params)
    assert dt.batch.n_dispatches == before + 1
    assert sum(ops.LAUNCHES.values()) == 0           # CPU: plain versions
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape == (3,) + want[k].shape[1:]
        np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=k, **TOL)
    # and each node alone through the unbatched per-node batch
    single = ttrees.DecisionTree(ds, max_depth=1, min_instances=10,
                                 node_batch=False,
                                 database=_cpu(ds, fuse_kernels=fuse))
    for i in range(3):
        one = single.view.run({k: v[i] for k, v in params.items()})
        for k in want:
            np.testing.assert_allclose(one[k].numpy(), want[k][i],
                                       err_msg=f"{k} node {i}", **TOL)


def test_batched_plan_needs_n_nodes():
    ds = TD.make("favorita", scale=SCALE)
    db = _cpu(ds)
    dt = ttrees.DecisionTree(ds, max_depth=1, database=db)
    with pytest.raises(ValueError, match="n_nodes"):
        dt.batch.plan.bind(db.sizes())
    with pytest.raises(ValueError, match="without batched params"):
        ttrees.DecisionTree(ds, max_depth=1, database=db,
                            node_batch=False).view.run_batched({})


def test_delta_with_batched_threshold_matches_reference():
    spec = ([("k", "key", 6), ("c", "categorical", 4),
             ("u", "continuous", 0)],
            [("F", ["k", "u"]), ("D", ["k", "c"])])
    rng = np.random.default_rng(5)
    n = 257
    tables = {"F": {"k": rng.integers(0, 6, n),
                    "u": rng.normal(size=n).astype(np.float32)},
              "D": {"k": np.arange(6), "c": rng.integers(0, 4, 6)}}
    thr = np.array([0, 2, 1], dtype=np.int32)

    def qs(m):
        t = m.Param("t", batched=True)
        return [m.query("qd", ["c"], [m.agg(m.Var("u"), m.Delta("c", "<=", t)),
                                      m.agg(m.Delta("c", "==", t))]),
                m.query("qs", [], [m.agg(m.Var("u"))])]

    want = repro.connect(jschema(*spec), tables=tables,
                         config=repro.ExecutionConfig(backend="pallas",
                                                      block_size=64)).views(
        qs(J)).run_batched({"t": thr})
    handle = repro_torch.connect(tschema(*spec), tables=tables, device="cpu",
                                 config=repro_torch.ExecutionConfig(
                                     block_size=64)).views(qs(T))
    got = handle.run_batched({"t": thr})
    unpadded = handle.compiled.run_batched(handle._database.data, {"t": thr},
                                           pad_to_pow2=False)
    assert tuple(got["qd"].shape) == (3, 4, 2)
    assert tuple(got["qs"].shape) == (1,)            # not batched: no node axis
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
        np.testing.assert_allclose(unpadded[k].numpy(), got[k].numpy(),
                                   err_msg=k, **TOL)
    u = tables["F"]["u"].astype(np.float64)
    c_of_row = tables["D"]["c"][tables["F"]["k"]]
    for j, t in enumerate(thr):
        for c in range(4):
            sel = c_of_row == c
            np.testing.assert_allclose(float(got["qd"][j, c, 0]),
                                       u[sel].sum() * (c <= t), atol=1e-4)


# ------------------------------------------------------------ tree fitting

@pytest.fixture(scope="module")
def ref_fits():
    """Reference fits on the pallas backend's per-node path: the regression
    and classification trees, and a random forest and gradient-boosted
    trees driven through the regression tree's compiled batch."""
    fav = JD.make("favorita", scale=SCALE)
    tpc = JD.make("tpcds", scale=SCALE)
    reg = jtrees.DecisionTree(fav, node_batch=False, backend="pallas",
                              **REG).fit()
    cls = jtrees.DecisionTree(tpc, node_batch=False, backend="pallas",
                              **CLS).fit()
    rf = jforest.RandomForest(fav, backend="pallas", **RF)
    gbt = jforest.GradientBoostedTrees(fav, backend="pallas", **GBT)
    rf.view = gbt.view = _PerNode(reg.view)
    return {"regression": reg.nodes, "classification": cls.nodes,
            "forest": rf.fit(), "boosted": gbt.fit()}


@pytest.mark.parametrize("task,name", [("regression", "favorita"),
                                       ("classification", "tpcds")])
@pytest.mark.parametrize("fuse", [True, False])
def test_fit_matches_per_node_and_reference(ref_fits, task, name, fuse):
    ds = TD.make(name, scale=SCALE)
    kw = REG if task == "regression" else CLS
    db = _cpu(ds, fuse_kernels=fuse)
    frontier = ttrees.DecisionTree(ds, database=db, **kw).fit()
    n_levels = max(n.depth for n in frontier.nodes) + 1
    assert frontier.batch.n_dispatches == n_levels   # one pass per level
    assert all(n.n > 0 for n in frontier.nodes)
    assert frontier.n_split_nodes() > 0
    per_node = ttrees.DecisionTree(ds, database=db, node_batch=False,
                                   **kw).fit()
    assert per_node.batch.n_dispatches == len(per_node.nodes)
    _assert_same_tree(frontier.nodes, per_node.nodes)
    _assert_same_tree(frontier.nodes, ref_fits[task])


def test_fit_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the fit would run there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrees.DecisionTree(TD.make("favorita", scale=SCALE))


# ---------------------------------------------------------------- ensembles

def test_random_forest_matches_reference(ref_fits):
    want = ref_fits["forest"]
    ds = TD.make("favorita", scale=SCALE)
    rf = tforest.RandomForest(ds, database=_cpu(ds), **RF).fit()
    assert [t.allowed_attrs for t in rf.trees] == \
        [t.allowed_attrs for t in want.trees]
    assert len({frozenset(t.allowed_attrs) for t in rf.trees}) > 1
    for t, w in zip(rf.trees, want.trees):
        _assert_same_tree(t.nodes, w.nodes)
    levels = max(max(n.depth for n in t.nodes) for t in rf.trees) + 1
    assert rf.batch.n_dispatches == levels           # one pass per level


def test_gradient_boosted_trees_match_reference(ref_fits):
    want = ref_fits["boosted"]
    ds = TD.make("favorita", scale=SCALE)
    gbt = tforest.GradientBoostedTrees(ds, database=_cpu(ds), **GBT).fit()
    np.testing.assert_allclose(gbt.base, want.base, rtol=1e-5)
    assert len(gbt.trees) == len(want.trees) == GBT["n_rounds"]
    for t, w in zip(gbt.trees, want.trees):
        _assert_same_tree(t, w)

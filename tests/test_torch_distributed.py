"""The port's domain parallelism (``core/distributed.py``, the session's
mesh) against the reference's single-device results on the CPU.

gloo ranks are spawned by ``tests/torch_dist_harness.py`` (a ``file://``
store in ``tmp_path``); each computes the sharded result, the parent holds
it against the reference (``repro``, one device) on the same numpy tables
at rtol/atol 1e-4, the reference's rule between its backends
(tests/test_backends.py:36).  The cases are tests/test_distributed.py:7-56
and tests/test_database_api.py:149-296.
"""

import numpy as np
import pytest

import repro
import repro_torch
from repro.core import aggregates as J
from repro.core import distributed as JDist
from repro.core.schema import schema as jschema
from repro.data import datasets as JD
from repro.ml import covar as jcovar
from repro.ml import trees as jtrees
from repro_torch.core import distributed as TDist
from repro_torch.data import datasets as TD
from repro_torch.launch import mesh as tmesh
from repro_torch.ml import covar as tcovar
from torch_dist_harness import (FD_SPEC, covar_case, engine_case,
                                errors_case, run_ranks, tree_level_case)

TOL = dict(rtol=1e-4, atol=1e-4)
SCALE = 0.02


def _reference_engine(tables, block_size):
    qs = [J.query("byc", ["c"], [J.COUNT, J.sum_of("u"),
                                 J.agg(J.Pow("u", 2))]),
          J.query("tot", [], [J.COUNT, J.sum_of("u")])]
    db = repro.connect(jschema(*FD_SPEC), tables=tables,
                       config=repro.ExecutionConfig(block_size=block_size))
    return {k: np.asarray(v, np.float64) for k, v in db.views(qs).run().items()}


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("shape,names,n,block_size", [
    ((4,), ("data",), 1003, 64),
    ((1, 4), ("model", "data"), 517, 32)], ids=["mesh4", "mesh1x4"])
def test_engine_sharded_matches_reference(tmp_path, backend, shape, names, n,
                                          block_size):
    """tests/test_distributed.py:7 and :33 on four gloo ranks: the last
    rank's padded rows count nowhere, on both backends."""
    ranks = run_ranks(engine_case, 4, tmp_path, shape, names, "data", n,
                      block_size, backend)
    want = _reference_engine(ranks[0]["tables"], block_size)
    for r in ranks:
        for label in ("legacy", "session", "again"):
            assert r[label].keys() == want.keys()
            for k in want:
                np.testing.assert_allclose(r[label][k], want[k],
                                           err_msg=f"{label} {k}", **TOL)
        assert r["n_runners"] == 1          # built once, cached
        t = r["shard"]
        assert (t["n_devices"], t["mesh_axis"], t["shard_rel"]) == \
            (4, "data", "F")
        assert t["rows"] == n and t["rows_per_shard"] == -(-n // 4)
        assert t["psums_per_run"] >= 1
        s = r["summary"]
        assert s.startswith(f"[batch] backend={backend} sharded")
        assert "shard: devices=4 axis=data rel=F" in s and "psums/run=" in s


@pytest.fixture(scope="module")
def covar_reference():
    C, N, _, _ = jcovar.compute_covar(JD.make("retailer", scale=SCALE))
    return np.asarray(C, np.float64), float(N)


@pytest.mark.parametrize("world,fuse", [(1, True), (2, True), (2, False)],
                         ids=["w1", "w2", "w2-unfused"])
def test_covar_through_connect_matches_reference(tmp_path, covar_reference,
                                                 world, fuse):
    """``connect(..., config=ExecutionConfig(mesh=))`` runs the covar batch
    domain-parallel; world size 1 gives the unsharded result bitwise (an
    all-reduce over one rank is the identity)."""
    C_want, N_want = covar_reference
    ranks = run_ranks(covar_case, world, tmp_path, SCALE, fuse)
    for r in ranks:
        assert r["N"] == N_want
        np.testing.assert_allclose(r["C"], C_want, **TOL)
        assert r["launches"] == 0            # CPU: the plain versions
        np.testing.assert_array_equal(r["C"], ranks[0]["C"])
    if world == 1:
        ds = TD.make("retailer", scale=SCALE)
        db = repro_torch.connect(ds, device="cpu",
                                 config=repro_torch.ExecutionConfig(
                                     block_size=256, fuse_kernels=fuse))
        C, N, _, _ = tcovar.compute_covar(ds, database=db)
        np.testing.assert_array_equal(ranks[0]["C"], C)
        assert ranks[0]["N"] == N


@pytest.fixture(scope="module")
def tree_reference():
    """The reference's ``pallas`` (interpret) frontier for 4 random masks:
    its ``xla`` frontier fails on its own (ROADMAP Queue 3)."""
    jds = JD.make("favorita", scale=SCALE)
    jdt = jtrees.DecisionTree(jds, max_depth=1, min_instances=10,
                              backend="pallas")
    rng = np.random.default_rng(11)
    params = {f"mask_{f.attr}": (rng.random((4, f.domain)) < 0.7)
              .astype(np.float32) for f in jdt.features}
    want = [{k: np.asarray(v, np.float64) for k, v in
             jdt.view.run_batched({k: v[:n] for k, v in params.items()})
             .items()} for n in (3, 4)]
    return params, want


@pytest.mark.parametrize("world", [1, 2])
def test_tree_level_pads_nodes_and_matches_reference(tmp_path, tree_reference,
                                                     world):
    """tests/test_database_api.py:269: a sharded frontier of 3 nodes pads to
    4 and shares the 4-node runner; the pad is sliced off; each level equals
    the reference's."""
    params, want = tree_reference
    ranks = run_ranks(tree_level_case, world, tmp_path, SCALE, params,
                      (3, 4))
    for r in ranks:
        assert r["runners"] == [1, 1]
        assert set(r["hits"]) == {"sharded_scan"}
        for got, w, n in zip(r["outs"], want, (3, 4)):
            assert got.keys() == w.keys()
            for k in w:
                assert got[k].shape == w[k].shape and got[k].shape[0] == n
                np.testing.assert_allclose(got[k], w[k], err_msg=k, **TOL)


def test_missing_axis_and_unknown_shard_rel_raise(tmp_path):
    """tests/test_database_api.py:204: a mesh without the axis and an
    unknown ``shard_rel`` raise on every rank (batch and maintained views);
    a mesh on the card is refused without one; no mesh without a process
    group."""
    for raised in run_ranks(errors_case, 2, tmp_path):
        assert len(raised) == 4
        assert "no axis 'model'" in raised[0]
        assert "shard_rel 'nope'" in raised[1] and "shard_rel 'nope'" in \
            raised[2]
        assert "device='cpu'" in raised[3]
    with pytest.raises(RuntimeError, match="no default process group"):
        tmesh.make_host_mesh(n_data=1, device_type="cpu")
    with pytest.raises(RuntimeError, match="no default process group"):
        tmesh.make_production_mesh(device_type="cpu")


@pytest.mark.parametrize("n_ins,ndev", [(1, 1), (5, 2), (13, 4), (16, 4)])
def test_insert_layout_matches_reference(n_ins, ndev):
    """The strided insert layout and each shard's share equal the
    reference's, and ``put_strided`` is ``put_sharded`` of the permuted
    batch."""
    blk = 1 << (-(-n_ins // ndev) - 1).bit_length()
    perm = TDist.strided_insert_layout(blk, ndev)
    np.testing.assert_array_equal(perm,
                                  JDist.strided_insert_layout(blk, ndev))
    col = np.arange(1, n_ins + 1, dtype=np.int32)
    padded = np.pad(col, (0, blk * ndev - n_ins))
    for s in range(ndev):
        ax = TDist.AxisInfo(group=None, size=ndev, index=s)
        got = TDist.put_strided(col, blk, ax, "cpu")
        np.testing.assert_array_equal(
            got.numpy(), TDist.put_sharded(padded[perm], ax, "cpu").numpy())
        k = TDist.local_insert_count(n_ins, s, ndev, blk)
        assert k == int(JDist.local_insert_count(n_ins, s, ndev, blk))
        assert (got.numpy()[:k] > 0).all() and (got.numpy()[k:] == 0).all()

"""The port's sharding rules (``distributed/sharding.py``, the train step's
``state_pspecs``/``batch_pspecs``/``abstract_state``) against the
reference's, with no process group: the spec functions take a plain
``{axis: size}`` mapping, and the reference's read only ``mesh.shape`` and
``mesh.axis_names``, so both get the production meshes without 512 ranks.
"""

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro import configs as jconfigs
from repro.distributed import sharding as JSh
from repro.models import model as JM
from repro.train import step as JS
from repro_torch import configs
from repro_torch.distributed import sharding as TSh
from repro_torch.models import model as TM
from repro_torch.train import adamw
from repro_torch.train import step as TS

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4},
          "1x4": {"data": 1, "model": 4},
          "4x1": {"data": 4, "model": 1}}
#: (batch, max_len) of the decode caches: a production decode batch, and
#: one request (its batch replicated on any data axis past 1)
CACHE_SHAPES = ((32, 4096), (1, 128))


class SpecMesh:
    """What the reference's spec functions read of a mesh."""

    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


def _leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: type(x).__name__ == "PartitionSpec")


def _spec_leaves(tree):
    """A spec tree's specs in sorted key order (a spec is a tuple: not
    walked into)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _spec_leaves(tree[k])]
    return [tree]


def _same(port, ref):
    p, r = _spec_leaves(port), _leaves(ref)
    assert len(p) == len(r)
    for a, b in zip(p, r):
        assert isinstance(a, TSh.P) and tuple(a) == tuple(b), (a, b)
        assert a == b


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_specs_equal_reference(arch, mesh):
    """``rules_for``, ``param_pspecs`` of the model's and the caches'
    specs, ``state_pspecs`` (with the compression residual) and
    ``batch_pspecs`` equal the reference's, entry for entry; the port's
    ``abstract_state`` has the reference's shapes and dtypes, on ``meta``."""
    sizes = MESHES[mesh]
    jm = SpecMesh(sizes)
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    rules = TSh.rules_for(sizes)
    assert rules == JSh.rules_for(jm)
    assert TSh.rules_for(sizes, seq_shard=False) == JSh.rules_for(jm, seq_shard=False)
    _same(TSh.param_pspecs(TM.model_specs(cfg), rules, sizes),
          JSh.param_pspecs(JM.model_specs(jcfg), rules, jm))
    for b, t in CACHE_SHAPES:
        _same(TSh.param_pspecs(TM.cache_specs(cfg, b, t), rules, sizes),
              JSh.param_pspecs(JM.cache_specs(jcfg, b, t), rules, jm))
    tcfg, jtcfg = TS.TrainConfig(compress_grads=True), JS.TrainConfig(compress_grads=True)
    _same(TS.state_pspecs(cfg, tcfg, sizes), JS.state_pspecs(jcfg, jtcfg, jm))
    _same(TS.batch_pspecs(cfg, sizes), JS.batch_pspecs(jcfg, jm))
    port = adamw.tree_leaves(TS.abstract_state(cfg, tcfg))
    ref = jax.tree.leaves(JS.abstract_state(jcfg, jtcfg))
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert a.device.type == "meta" and tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[-1] == np.dtype(b.dtype).name


def test_spec_rules_by_hand():
    """The two rules of ``spec_for``: a mapping that does not divide its
    dimension falls back to replicated, and a mesh axis is used once per
    spec, the first dimension winning (the cache's length over kv)."""
    rules = TSh.rules_for({"data": 16, "model": 16})
    assert TSh.spec_for(("embed", "kv", None), rules, (2048, 8, 128),
                        {"data": 16, "model": 16}) == ("data", None, None)
    # ("data",) reads "data", as PartitionSpec normalises it
    assert TSh.spec_for(("cache_batch", "cache_seq", "kv", None), rules) == \
        ("data", "model", None, None)
    assert TSh.spec_for(("vocab", "embed"), rules, (92544, 2048),
                        {"data": 16, "model": 16}) == ("model", "data")
    assert TSh.spec_for(("vocab", "embed"), rules, (92545, 2048),
                        {"data": 16, "model": 16}) == (None, "data")
    assert repr(TSh.P("data", None)) == "P('data', None)"


#: (spec, mesh, placements): a dimension over (pod, data), split pod-major
#: as the reference's ("pod", "data"); kv replicated on a model axis that
#: does not divide it while heads split; axes of extent 1 still named
PLACEMENTS = [
    (TSh.P(("pod", "data"), None), {"pod": 2, "data": 16, "model": 16},
     (Shard(0), Shard(0), Replicate())),
    (TSh.P(None, ("pod", "data"), "model"), {"pod": 2, "data": 4, "model": 2},
     (Shard(1), Shard(1), Shard(2))),
    (TSh.P("data", None, None), {"data": 16, "model": 16},
     (Shard(0), Replicate())),
    (TSh.P("data", "model", None), {"data": 16, "model": 16},
     (Shard(0), Shard(1))),
    (TSh.P(("data",), "model", None, None), {"data": 1, "model": 4},
     (Shard(0), Shard(1))),
    (TSh.P(), {"data": 2, "model": 2}, (Replicate(), Replicate())),
]


@pytest.mark.parametrize("spec,mesh,want", PLACEMENTS,
                         ids=[f"{tuple(s)}-{'x'.join(map(str, m.values()))}"
                              for s, m, _ in PLACEMENTS])
def test_placements_by_hand(spec, mesh, want):
    assert TSh.placements_for(spec, mesh) == want


class CoordMesh:
    """A rank of a mesh, as ``local_shard_offsets`` reads it."""

    def __init__(self, shape, coord):
        self.shape, self.coord = shape, coord

    def get_coordinate(self):
        return list(self.coord)

    def size(self, i):
        return self.shape[i]


def test_pod_data_split_is_pod_major():
    """DTensor splits a dimension over its mesh dimensions in mesh order:
    under (Shard(0), Shard(0)) on a (pod 2, data 4) mesh, rank (p, d) holds
    rows (4p + d)·n/8 onward, the order of the reference's
    P(("pod", "data")) (major to minor); ``local_shard_offsets`` agrees.
    An entry against the mesh's order raises."""
    from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset

    n, shape = 64, (2, 4, 2)
    pls = TSh.placements_for(TSh.P(("pod", "data"), None),
                             {"pod": 2, "data": 4, "model": 2})
    for p in range(2):
        for d in range(4):
            for m in range(2):
                want = ((n // 8, 3), ((4 * p + d) * n // 8, 0))
                got = _compute_local_shape_and_global_offset((n, 3), shape,
                                                             [p, d, m], pls)
                assert tuple(map(tuple, got)) == want
                assert TSh.local_shard_offsets((n, 3), pls,
                                               CoordMesh(shape, (p, d, m))) == want
    with pytest.raises(ValueError, match="order"):
        TSh.placements_for(TSh.P(("data", "pod")), {"pod": 2, "data": 4})


def test_kv_split_or_replicated_with_heads():
    """GQA under a model axis: kv heads follow the q heads where the axis
    divides them, else stay replicated while the q heads split."""
    cfg = configs.get_smoke("internlm2-1.8b")            # 4 heads, 2 kv heads
    specs = TM.model_specs(cfg)["layers"]["attn"]
    for sizes, kv in (({"data": 2, "model": 2}, "model"),
                      ({"data": 1, "model": 4}, None)):
        rules = TSh.rules_for(sizes)
        got = TSh.param_pspecs(specs, rules, sizes)
        assert got["wq"] == (None, "data", "model", None)
        assert got["wk"] == (None, "data", kv, None)
        # embed over data, even of extent 1 (the spec keeps the name)
        want = (Shard(1), Shard(2) if kv else Replicate())
        assert TSh.placements_for(got["wk"], sizes) == want


def test_constrain_and_fsdp_are_no_ops_without_a_mesh():
    x = torch.ones(4, 8, 16)
    assert TSh.current_mesh() is None
    assert TSh.constrain(x, "batch", "seq", None) is x
    assert TSh.fsdp(x) is x
    with TSh.mesh_context(None):
        assert TSh.constrain(x, "batch", "seq", None) is x

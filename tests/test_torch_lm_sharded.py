"""The LM's sharding (``distributed/sharding.py``, the steps' mesh) against
the reference's single-device steps on the CPU.

gloo ranks are spawned by ``tests/torch_dist_harness.py`` (``lm_case``),
one group a mesh running every case of that mesh; the parent holds what
they return against the reference (``repro``, one device, jitted) on the
same numpy state and batches, at the reference's own tolerances
(tests/test_distributed.py:86-90 and :133-134: loss 1e-3, params 5e-3,
decode logits rtol/atol 5e-3) and the port's prefill tolerance
(tests/test_torch_train.py: 2e-3).  The reference's own sharded runs of
those tests fail on their own (ROADMAP Queue 3), so its single-device step
is the oracle.  The meshes cover kv heads split with the q heads, (2, 2),
and kv heads replicated while the q heads split, (1, 4): the smoke
configs' 2 kv heads on a 4-way model axis.
"""

import functools
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.data.pipeline import PipelineConfig, TokenPipeline
from repro.models import model as JM
from repro.models.layers import init_params as jinit_params
from repro.serve.engine import make_serve_step as jmake_serve_step
from repro.train import step as JS
from repro_torch import configs
from torch_dist_harness import lm_case, run_ranks
from torch_train_cases import np_params

LOSS_TOL, PARAM_TOL, DECODE_TOL, PREFILL_TOL = 1e-3, 5e-3, 5e-3, 2e-3
TRAIN_KW = dict(peak_lr=1e-2, warmup=2, total_steps=10, ce_chunk=8,
                attn_impl="dense")
VARIANTS = {"plain": {}, "accum_compress": dict(grad_accum=2, compress_grads=True),
            "remat_chunked": dict(attn_impl="chunked", grad_accum=2)}
#: config overrides of a variant: the card's train path (remat, chunked
#: attention over query chunks of 8)
CFG_KW = {"remat_chunked": dict(remat=True, attn_chunk=8)}
BATCH, SEQ, TRAIN_STEPS = 8, 16, 2
DECODE_B, DECODE_LEN, DECODE_STEPS = 2, 16, 12
#: mesh -> its cases: (kind, arch, variant or impl)
MESH_CASES = {
    (2, 2): [("train", "internlm2-1.8b", "plain"),
             ("train", "qwen3-moe-235b-a22b", "plain"),
             ("prefill", "internlm2-1.8b", "flash"),
             ("prefill", "internlm2-1.8b", "chunked"),
             ("decode", "llama3-8b", DECODE_LEN),
             ("decode", "llama3-8b", DECODE_LEN - 1)],
    (1, 2): [("train", "internlm2-1.8b", "plain"),
             ("train", "qwen3-moe-235b-a22b", "plain"),
             ("train", "internlm2-1.8b", "remat_chunked")],
    (2, 1): [("train", "internlm2-1.8b", "plain"),
             ("train", "qwen3-moe-235b-a22b", "plain"),
             ("train", "internlm2-1.8b", "accum_compress"),
             ("loop", "internlm2-1.8b", "plain")],
    (1, 4): [("prefill", "internlm2-1.8b", "flash"),
             ("prefill", "internlm2-1.8b", "chunked"),
             ("train", "internlm2-1.8b", "plain")],
}
#: the spawned groups: world size -> the meshes its ranks run in turn; the
#: two groups run at once
GROUPS = {4: [(2, 2), (1, 4)], 2: [(1, 2), (2, 1)]}


class SpecMesh:
    """What the reference's spec functions read of a mesh."""

    def __init__(self, shape):
        self.shape = dict(zip(("data", "model"), shape))
        self.axis_names = ("data", "model")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tcfg(variant):
    return dict(TRAIN_KW, **VARIANTS[variant])


def _cfg(arch, variant="plain"):
    return jconfigs.get_smoke(arch).with_(**CFG_KW.get(variant, {}))


@functools.lru_cache(maxsize=None)
def _batches(arch):
    cfg = jconfigs.get_smoke(arch)
    pipe = TokenPipeline(PipelineConfig(BATCH, SEQ, cfg.vocab, seed=0), cfg)
    return [np.asarray(pipe.batch_at(i)["tokens"]) for i in range(TRAIN_STEPS)]


@functools.lru_cache(maxsize=None)
def _state(arch, variant):
    """An initial train state from numpy (``init_state``'s layout: the
    params of ``np_params``, zero float32 moments and residuals), the same
    params for every variant."""
    params = np_params(configs.get_smoke(arch), seed=0)
    zeros = jax.tree.map(np.zeros_like, params)
    state = {"params": params, "m": zeros, "v": zeros, "step": np.zeros((), np.int32)}
    if VARIANTS[variant].get("compress_grads"):
        state["ef"] = zeros
    return state


@functools.lru_cache(maxsize=None)
def reference_train(arch, variant):
    """The reference's jitted single-device step, TRAIN_STEPS times."""
    cfg = _cfg(arch, variant)
    step = jax.jit(JS.make_train_step(cfg, JS.TrainConfig(**_tcfg(variant))))
    state = jax.tree.map(jnp.asarray, _state(arch, variant))
    metrics = []
    for b in _batches(arch):
        state, met = step(state, {"tokens": jnp.asarray(b)})
        metrics.append({k: float(v) for k, v in met.items()})
    return metrics, _np(state["params"])


@functools.lru_cache(maxsize=None)
def reference_prefill(arch, impl):
    cfg = jconfigs.get_smoke(arch)
    jimpl = "pallas" if impl == "flash" else impl
    params = _state(arch, "plain")["params"]
    out = JS.make_prefill_step(cfg, JS.TrainConfig(attn_impl=jimpl))(
        jax.tree.map(jnp.asarray, params), {"tokens": jnp.asarray(_batches(arch)[0])})
    return np.asarray(out)


@functools.lru_cache(maxsize=None)
def reference_decode(arch):
    cfg = jconfigs.get_smoke(arch)
    params = jax.tree.map(jnp.asarray, _state(arch, "plain")["params"])
    cache = jinit_params(JM.cache_specs(cfg, DECODE_B, DECODE_LEN),
                         jax.random.PRNGKey(0), cfg.jdtype)
    step = jax.jit(jmake_serve_step(cfg))
    toks = _batches(arch)[0][:DECODE_B]
    out = []
    for pos in range(DECODE_STEPS):
        lg, cache = step(params, cache, jnp.asarray(toks[:, pos:pos + 1]),
                         jnp.asarray(pos, jnp.int32))
        out.append(np.asarray(lg))
    return out


def _case(kind, arch, variant):
    if kind in ("train", "loop"):
        case = dict(kind=kind, arch=arch, tcfg=_tcfg(variant),
                    state=_state(arch, variant), cfg=CFG_KW.get(variant, {}))
        if kind == "train":
            case["batches"] = _batches(arch)
        else:
            case.update(pipe=(BATCH, SEQ), steps=4, stop=2)
        return case
    case = dict(kind=kind, arch=arch, params=_state(arch, "plain")["params"])
    if kind == "prefill":
        case.update(impl=variant, tokens=_batches(arch)[0])
    else:
        case.update(tokens=_batches(arch)[0][:DECODE_B], max_len=variant,
                    steps=DECODE_STEPS)
    return case


_RUNS = {}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(mesh)``: every rank's results for the mesh's cases.  On
    first use both groups are spawned at once, each running its meshes."""
    def spawn(world, meshes, tmp, out):
        try:
            runs = [(m, [_case(*c) for c in MESH_CASES[m]]) for m in meshes]
            res = run_ranks(lm_case, world, tmp, runs, str(tmp))
            for i, m in enumerate(meshes):
                out[m] = [r[i] for r in res]
        except BaseException as e:          # re-raised in the test thread
            for m in meshes:
                out[m] = e

    def get(mesh):
        if not _RUNS:
            for world, meshes in GROUPS.items():    # reference inputs first
                for m in meshes:
                    [_case(*c) for c in MESH_CASES[m]]
            # the directories made here: tmp_path_factory is not thread-safe
            threads = [threading.Thread(target=spawn, args=(
                w, ms, tmp_path_factory.mktemp(f"lm_w{w}"), _RUNS))
                for w, ms in GROUPS.items()]
            for t in threads:
                t.start()
            for m, cases in MESH_CASES.items():     # the oracle meanwhile
                for kind, arch, variant in cases:
                    if kind == "train":
                        reference_train(arch, variant)
                    elif kind == "prefill":
                        reference_prefill(arch, variant)
                    elif kind == "decode":
                        reference_decode(arch)
            for t in threads:
                t.join()
        if isinstance(_RUNS[mesh], BaseException):
            raise _RUNS[mesh]
        return _RUNS[mesh]
    return get


def _result(ranks, mesh, case):
    return [r[MESH_CASES[mesh].index(case)] for r in ranks(mesh)]


TRAIN = [(m, c) for m, cs in MESH_CASES.items() for c in cs if c[0] == "train"]


@pytest.mark.parametrize("mesh,case", TRAIN, ids=[
    f"{'x'.join(map(str, m))}-{c[1]}-{c[2]}" for m, c in TRAIN])
def test_train_steps_match_reference(ranks, mesh, case):
    """tests/test_distributed.py:59 on gloo ranks: the same global batch
    and initial state give the reference's loss and params."""
    _, arch, variant = case
    want_met, want_params = reference_train(arch, variant)
    for r in _result(ranks, mesh, case):
        assert r["plain_metrics"]
        for got, want in zip(r["metrics"], want_met):
            assert abs(got["loss"] - want["loss"]) < LOSS_TOL, (got, want)
            assert abs(got["grad_norm"] - want["grad_norm"]) < 1e-3 * want["grad_norm"]
            np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
        d = max(float(np.max(np.abs(a.astype(np.float32) - b.astype(np.float32))))
                for a, b in zip(jax.tree.leaves(r["params"]),
                                jax.tree.leaves(want_params)))
        assert d < PARAM_TOL, d


def _shard_shape(shape, spec, sizes):
    out = []
    for n, entry in zip(shape, tuple(spec)):
        names = () if entry is None else (entry,) if isinstance(entry, str) else entry
        out.append(n // math.prod(sizes[a] for a in names))
    return tuple(out)


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_state_is_split_by_reference_specs(ranks, mesh):
    """Each rank holds only its shard: every leaf of the state after the
    steps has the local shape of the reference's spec on this mesh."""
    case = ("train", "internlm2-1.8b", "plain")
    cfg = jconfigs.get_smoke(case[1])
    spec_mesh = SpecMesh(mesh)
    specs = JS.state_pspecs(cfg, JS.TrainConfig(**_tcfg("plain")), spec_mesh)
    leaves = jax.tree.leaves(specs, is_leaf=lambda x: x is None or
                             type(x).__name__ == "PartitionSpec")
    rs = _result(ranks, mesh, case)
    split = 0
    for r in rs:
        assert len(r["shapes"]) == len(leaves)
        for (glob, loc), spec in zip(r["shapes"], leaves):
            assert loc == _shard_shape(glob, spec, spec_mesh.shape), (glob, spec)
            split += loc != glob
    assert split > 0


@pytest.mark.parametrize("mesh,impl", [((2, 2), "flash"), ((2, 2), "chunked"),
                                       ((1, 4), "flash"), ((1, 4), "chunked")],
                         ids=["2x2-kv-split-flash", "2x2-kv-split-chunked",
                              "1x4-kv-replicated-flash", "1x4-kv-replicated-chunked"])
def test_prefill_matches_reference(ranks, mesh, impl):
    """The sharded prefill (``"flash"`` through the kernel wrapper's plain
    version on each rank's local heads) against the reference's unsharded
    one (``"pallas"`` in interpret mode, ``"chunked"``)."""
    case = ("prefill", "internlm2-1.8b", impl)
    want = reference_prefill("internlm2-1.8b", impl)
    for r in _result(ranks, mesh, case):
        np.testing.assert_allclose(r["logits"], want, rtol=PREFILL_TOL,
                                   atol=PREFILL_TOL)
        assert r["placements"][-1] == "Shard(dim=2)" or mesh[1] == 1


@pytest.mark.parametrize("max_len", [DECODE_LEN, DECODE_LEN - 1],
                         ids=["length-split", "kv-heads-split"])
def test_sharded_decode_matches_reference(ranks, max_len):
    """tests/test_distributed.py:96 on (2, 2) gloo ranks, through steps on
    both halves of the length-sharded cache; and where ``model`` does not
    divide the length (15), the cache splits its kv heads over ``model``
    instead (the reference's spec rules) and decode runs on those."""
    case = ("decode", "llama3-8b", max_len)
    want = reference_decode("llama3-8b")
    cfg = jconfigs.get_smoke("llama3-8b")
    n, b, t, kv, hd = cfg.n_layers, DECODE_B, max_len, cfg.n_kv, cfg.hd
    local = ((n, b // 2, t // 2, kv, hd) if max_len % 2 == 0
             else (n, b // 2, t, kv // 2, hd))
    for r in _result(ranks, (2, 2), case):
        for pos, (got, w) in enumerate(zip(r["logits"], want)):
            np.testing.assert_allclose(got, w, rtol=DECODE_TOL, atol=DECODE_TOL,
                                       err_msg=f"pos {pos}")
        # cache_batch over data (2); cache_seq over model (2), else kv
        assert r["shapes"] == [((n, b, t, kv, hd), local)] * 2
        # every written position landed once: on the rank that holds it
        k = r["cache"]["kv"]["k"]
        assert np.all(np.abs(k[:, :, :DECODE_STEPS]).sum(axis=(0, 3, 4)) > 0)
        assert not np.any(k[:, :, DECODE_STEPS:])


def test_sharded_loop_resumes_bitwise(ranks):
    """A sharded TrainLoop (2 × 1: FSDP over data) stopped after a
    checkpoint and resumed from it reads the straight run's losses and
    params bit for bit; rank 0 alone wrote the checkpoints."""
    case = ("loop", "internlm2-1.8b", "plain")
    rs = _result(ranks, (2, 1), case)
    for r in rs:
        a, b = r["straight"], r["resumed"]
        assert len(a["losses"]) == len(b["losses"]) == 4
        assert a["losses"] == b["losses"]
        for x, y in zip(jax.tree.leaves(a["params"]), jax.tree.leaves(b["params"])):
            assert np.array_equal(x, y)
        assert a["files"] == ["step_00000002", "step_00000004"]
    assert rs[0]["straight"]["losses"] == rs[-1]["straight"]["losses"]


@pytest.fixture
def one_rank_mesh():
    """A (1, 1) ("data", "model") mesh over a one-rank gloo group in this
    process, torn down after the test."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_every_kernel_wrapper_raises_on_a_dtensor(one_rank_mesh):
    """A DTensor's ``data_ptr`` is not its shard's: each wrapper refuses
    one on the CPU (here) as on the card, before any kernel or plain
    version runs; the same calls on the local shards run."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels import ops

    def dt(t):
        return DTensor.from_local(t, one_rank_mesh, [Replicate(), Replicate()],
                                  run_check=False)

    q = torch.randn(1, 2, 8, 8)
    x = torch.randn(6, 3)
    codes = torch.zeros(6, dtype=torch.int32)
    calls = {
        "flash_attention": lambda f: ops.flash_attention(f(q), q, q),
        "covar_xtx": lambda f: ops.covar_xtx(f(x)),
        "seg_aggregate": lambda f: ops.seg_aggregate(codes, f(x), 2),
        "tree_hist": lambda f: ops.tree_hist(f(codes), x[:, 0], torch.ones(6), 2),
        "tree_hist_batched": lambda f: ops.tree_hist_batched(
            codes, f(x[:, 0]), torch.ones(6, 2), 2),
        "fused_scan_block": lambda f: ops.fused_scan_block(
            codes[:, None], f(x), [ops.ReduceSpec("seg", 0, 2, 3, 0)]),
        "fused_scan_parts": lambda f: ops.fused_scan_parts(
            [ops.Parts("seg", f(codes), (ops.Part(x, 0),), 2, 3)]),
    }
    ops.reset_launches()
    for name, call in calls.items():
        with pytest.raises(TypeError, match="not DTensors"):
            call(dt)
        assert call(lambda t: t) is not None, name
    assert sum(ops.LAUNCHES.values()) == 0


def test_sharded_state_round_trips_through_numpy(one_rank_mesh):
    """``state_to_numpy`` gathers a sharded state; ``state_from_numpy``
    places it again, by ``like``'s placements or by a mesh and specs."""
    from torch.distributed.tensor import DTensor

    from repro_torch import configs
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.models.weights import state_from_numpy, state_to_numpy
    from repro_torch.train.adamw import tree_leaves
    from repro_torch.train.step import TrainConfig, init_state, state_pspecs

    import torch

    cfg = configs.get_smoke("internlm2-1.8b").with_(dtype="bfloat16")
    tcfg = TrainConfig(compress_grads=True)
    plain = init_state(cfg, tcfg, torch.Generator().manual_seed(2), "cpu")
    specs = state_pspecs(cfg, tcfg, one_rank_mesh)
    sharded = shard_tree(plain, specs, one_rank_mesh)
    host = state_to_numpy(sharded)
    for back in (state_from_numpy(host, like=sharded),
                 state_from_numpy(host, like=plain, mesh=one_rank_mesh, specs=specs)):
        for a, b in zip(tree_leaves(back), tree_leaves(sharded)):
            assert isinstance(a, DTensor) and a.placements == b.placements
            assert torch.equal(a.to_local(), b.to_local())


def test_sharded_attention_on_one_rank_is_the_plain_one(one_rank_mesh):
    """On a (1, 1) mesh the sharded prefill (``"flash"`` on the local
    heads) equals the unsharded port's bit for bit, and decode (its
    softmax's sum divided after the all-reduce) within 1e-6."""
    import torch

    from repro_torch import configs
    from repro_torch.distributed.sharding import param_pspecs, rules_for, shard_tree
    from repro_torch.models import model as TM
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.serve.engine import init_sharded_cache, make_serve_step
    from repro_torch.train.step import TrainConfig, make_prefill_step

    arch = "internlm2-1.8b"
    cfg = configs.get_smoke(arch)
    params = params_from_numpy(_state(arch, "plain")["params"], "cpu")
    sharded = shard_tree(params, param_pspecs(TM.model_specs(cfg),
                                              rules_for(one_rank_mesh),
                                              one_rank_mesh), one_rank_mesh)
    toks = torch.from_numpy(np.array(_batches(arch)[0]))
    tcfg = TrainConfig(attn_impl="flash")
    want = make_prefill_step(cfg, tcfg)(params, {"tokens": toks})
    got = make_prefill_step(cfg, tcfg, one_rank_mesh)(sharded, {"tokens": toks})
    assert torch.equal(got.full_tensor(), want)
    cache = TM.init_cache(cfg, 2, 8, "cpu")
    scache = init_sharded_cache(cfg, 2, 8, one_rank_mesh)
    for pos in range(3):
        w, cache = make_serve_step(cfg)(params, cache, toks[:2, pos:pos + 1], pos)
        g, scache = make_serve_step(cfg, one_rank_mesh)(sharded, scache,
                                                        toks[:2, pos:pos + 1], pos)
        torch.testing.assert_close(g.full_tensor(), w, rtol=1e-6, atol=1e-6)


def test_remat_recompute_runs_under_the_mesh(one_rank_mesh, monkeypatch):
    """On the card autograd runs the backward on the device's own thread,
    where the thread-local mesh context is not set: a rematerialised layer
    recomputes under the mesh all the same (here the backward runs on
    another thread, as there, while the step's thread holds the mesh)."""
    import threading

    import torch

    from repro_torch import configs
    from repro_torch.distributed import sharding as TSh
    from repro_torch.models import model as TM
    from repro_torch.train import step as TS
    from repro_torch.train.adamw import tree_leaves

    cfg = configs.get_smoke("internlm2-1.8b").with_(remat=True, attn_chunk=8)
    tcfg = TS.TrainConfig(attn_impl="chunked", ce_chunk=8)
    gen = torch.Generator().manual_seed(0)
    state = TSh.shard_tree(TS.init_state(cfg, tcfg, gen, "cpu"),
                           TS.state_pspecs(cfg, tcfg, one_rank_mesh), one_rank_mesh)
    seen = []
    block = TM.dense_block

    def probe(*args, **kwargs):
        seen.append(TSh.current_mesh() is not None)
        return block(*args, **kwargs)

    monkeypatch.setattr(TM, "dense_block", probe)
    leaves = tree_leaves(state["params"])
    for p in leaves:
        p.requires_grad_(True)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=gen)}
    out = {}
    with TSh.mesh_context(one_rank_mesh):
        loss, _ = TS._loss_fn(state["params"], TS._placed(batch), cfg, tcfg)
        t = threading.Thread(target=lambda: out.update(
            grads=torch.autograd.grad(loss, leaves)))
        t.start()
        t.join()
    assert len(seen) == 2 * cfg.n_layers and all(seen), seen   # forward, recompute
    assert len(out["grads"]) == len(leaves)

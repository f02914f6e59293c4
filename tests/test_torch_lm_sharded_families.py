"""The SSM, hybrid, MLA, VLM and audio families on a mesh against the
reference's single-device steps on the CPU.

gloo ranks are spawned by ``tests/torch_dist_harness.py`` (``lm_case``):
one group of four ranks runs the (2, 2) mesh, another of two the (1, 2)
mesh, both at once, while the parent computes the reference's jitted
single-device steps on the same numpy state, batches and contexts.  The
tolerances are the reference's own (tests/test_distributed.py:86-90 and
:133-134: loss 1e-3, params 5e-3, decode logits 5e-3) and the port's
prefill tolerance (tests/test_torch_train.py: 2e-3).  ``model`` splits
mamba2's ``din`` and SSM heads, the attention heads (MLA's expanded ones,
cross-attention's over a context), the decode cache's length and the
vocab.  MLA and whisper are held against the reference's ``dense``
attention: its Pallas kernel sizes V by q's width, and its ``chunked``
masks cross-attention keys past the query length (ROADMAP Queue 3).

Every rank runs under ``strict_flatten_views``: the card's torch 2.11
refuses a view that flattens the batch with a sequence-sharded dimension,
which the CPU's newer torch allows; internlm2-1.8b's remat train steps
(the four-card run's path) failed there before the residual adds placed
the sublayer outputs like the stream (``model._residual``), and whisper's
train steps, whose one CE chunk spans the sequence, before the CE gathered
each chunk's sequence (``train.step._ce_sum``).
"""

import functools
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
TCFG = dict(peak_lr=1e-2, warmup=1, total_steps=10, ce_chunk=8, attn_impl="dense")
#: two SSD chunks of 8 (the smoke configs' ``ssm_chunk``) a sequence
BATCH, SEQ, TRAIN_STEPS = 4, 16, 2
#: decode over both halves of a length-sharded cache of 16
DECODE_B, DECODE_LEN, DECODE_STEPS = 2, 16, 12
#: config overrides by case name: zamba2 with a tail (5 layers, a shared
#: block every 2: two groups and one layer after them); internlm2 with
#: remat and chunked attention in two microbatches (the four-card run's
#: train path); whisper's CE in one chunk of the whole sequence (as a
#: 448-token decoder's under the card's chunk of 512)
CFG_KW = {"zamba2-tail": dict(n_layers=5),
          "internlm2-remat": dict(remat=True, attn_chunk=8)}
TCFG_KW = {"internlm2-remat": dict(attn_impl="chunked", grad_accum=2),
           "whisper": dict(ce_chunk=SEQ)}
ARCH = {"mamba2": "mamba2-2.7b", "zamba2-tail": "zamba2-1.2b",
        "deepseek": "deepseek-v2-lite-16b", "vision": "llama-3.2-vision-90b",
        "whisper": "whisper-small", "internlm2-remat": "internlm2-1.8b"}
#: the reference's attention for the port's "flash" prefill
REF_IMPL = {"deepseek": "dense", "whisper": "dense"}
FAMILIES = ("mamba2", "zamba2-tail", "deepseek", "vision", "whisper")
#: mesh -> its cases: (kind, case name)
MESH_CASES = {
    (2, 2): [(kind, name) for kind in ("train", "prefill", "decode") for name in FAMILIES]
    + [("train", "internlm2-remat")],
    (1, 2): [("train", "mamba2"), ("train", "deepseek"), ("prefill", "vision"),
             ("decode", "mamba2"), ("decode", "whisper")],
}
#: the spawned groups: world size -> its meshes; the groups run at once
GROUPS = {4: [(2, 2)], 2: [(1, 2)]}


def _jcfg(name):
    return jconfigs.get_smoke(ARCH[name]).with_(**CFG_KW.get(name, {}))


def _cfg(name):
    return configs.get_smoke(ARCH[name]).with_(**CFG_KW.get(name, {}))


@functools.lru_cache(maxsize=None)
def _batches(name):
    """TRAIN_STEPS batches of the reference's pipeline as numpy: tokens,
    and the VLM's ``vision`` or whisper's ``frames``."""
    pipe = TokenPipeline(PipelineConfig(BATCH, SEQ, _jcfg(name).vocab, seed=0),
                         _jcfg(name))
    return [{k: np.asarray(v) for k, v in pipe.batch_at(i).items()}
            for i in range(TRAIN_STEPS)]


@functools.lru_cache(maxsize=None)
def _state(name):
    params = np_params(_cfg(name), seed=0)
    zeros = jax.tree.map(np.zeros_like, params)
    return {"params": params, "m": zeros, "v": zeros, "step": np.zeros((), np.int32)}


@functools.lru_cache(maxsize=None)
def _context(name, b):
    """A raw decode context (0.02·N(0, 1)) for the VLM and audio, else None."""
    cfg = _cfg(name)
    if cfg.family not in ("vlm", "audio"):
        return None
    n = cfg.vision_tokens if cfg.family == "vlm" else cfg.encoder_frames
    rng = np.random.default_rng(3)
    return (0.02 * rng.standard_normal((b, n, cfg.d_model))).astype(np.float32)


def _tcfg(name):
    return dict(TCFG, **TCFG_KW.get(name, {}))


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


@functools.lru_cache(maxsize=None)
def reference_train(name):
    step = jax.jit(JS.make_train_step(_jcfg(name), JS.TrainConfig(**_tcfg(name))))
    state = _jtree(_state(name))
    metrics = []
    for b in _batches(name):
        state, met = step(state, _jtree(b))
        metrics.append({k: float(v) for k, v in met.items()})
    return metrics, jax.tree.map(np.asarray, state["params"])


@functools.lru_cache(maxsize=None)
def reference_prefill(name):
    tcfg = JS.TrainConfig(attn_impl=REF_IMPL.get(name, "pallas"))
    out = JS.make_prefill_step(_jcfg(name), tcfg)(
        _jtree(_state(name)["params"]), _jtree(_batches(name)[0]))
    return np.asarray(out)


@functools.lru_cache(maxsize=None)
def reference_decode(name):
    cfg = _jcfg(name)
    params = _jtree(_state(name)["params"])
    cache = jinit_params(JM.cache_specs(cfg, DECODE_B, DECODE_LEN),
                         jax.random.PRNGKey(0), cfg.jdtype)
    raw = _context(name, DECODE_B)
    context = None if raw is None else JM.encode_context(
        params, {"frames" if cfg.family == "audio" else "vision": jnp.asarray(raw)},
        cfg, impl="dense")
    step = jax.jit(jmake_serve_step(cfg))
    toks = _batches(name)[0]["tokens"][:DECODE_B]
    out = []
    for pos in range(DECODE_STEPS):
        lg, cache = step(params, cache, jnp.asarray(toks[:, pos:pos + 1]),
                         jnp.asarray(pos, jnp.int32), context)
        out.append(np.asarray(lg))
    return out


def _case(kind, name):
    arch, cfg = ARCH[name], CFG_KW.get(name, {})
    if kind == "train":
        return dict(kind=kind, arch=arch, cfg=cfg, tcfg=_tcfg(name), state=_state(name),
                    batches=_batches(name))
    case = dict(kind=kind, arch=arch, cfg=cfg, params=_state(name)["params"])
    b0 = _batches(name)[0]
    if kind == "prefill":
        case.update(impl="flash", tokens=b0["tokens"],
                    context={k: v for k, v in b0.items() if k != "tokens"})
    else:
        case.update(tokens=b0["tokens"][:DECODE_B], max_len=DECODE_LEN,
                    steps=DECODE_STEPS, context=_context(name, DECODE_B))
    return case


_RUNS = {}
_REFERENCE = {"train": reference_train, "prefill": reference_prefill,
              "decode": reference_decode}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(mesh)``: every rank's results for the mesh's cases; on first
    use the groups are spawned at once and the oracle runs meanwhile."""
    def spawn(world, meshes, tmp, out):
        try:
            runs = [(m, [_case(*c) for c in MESH_CASES[m]]) for m in meshes]
            res = run_ranks(lm_case, world, tmp, runs, str(tmp), True)
            for i, m in enumerate(meshes):
                out[m] = [r[i] for r in res]
        except BaseException as e:          # re-raised in the test thread
            for m in meshes:
                out[m] = e

    def get(mesh):
        if not _RUNS:
            for cases in MESH_CASES.values():      # the ranks' inputs first
                [_case(*c) for c in cases]
            threads = [threading.Thread(target=spawn, args=(
                w, ms, tmp_path_factory.mktemp(f"fam_w{w}"), _RUNS))
                for w, ms in GROUPS.items()]
            for t in threads:
                t.start()
            for cases in MESH_CASES.values():
                for kind, name in cases:
                    _REFERENCE[kind](name)
            for t in threads:
                t.join()
        if isinstance(_RUNS[mesh], BaseException):
            raise _RUNS[mesh]
        return _RUNS[mesh]
    return get


def _result(ranks, mesh, case):
    return [r[MESH_CASES[mesh].index(case)] for r in ranks(mesh)]


def _cases(kind):
    return [(m, c[1]) for m, cs in MESH_CASES.items() for c in cs if c[0] == kind]


def _ids(kind):
    return [f"{'x'.join(map(str, m))}-{n}" for m, n in _cases(kind)]


@pytest.mark.parametrize("mesh,name", _cases("train"), ids=_ids("train"))
def test_family_train_steps_match_reference(ranks, mesh, name):
    """Two sharded train steps (the VLM's and whisper's batches with their
    context; internlm2 with remat, chunked attention and two microbatches)
    give the reference's loss, grad norm and params, under torch 2.11's
    view rule."""
    want_met, want_params = reference_train(name)
    for r in _result(ranks, mesh, ("train", name)):
        assert r["plain_metrics"]
        for got, want in zip(r["metrics"], want_met):
            assert abs(got["loss"] - want["loss"]) < LOSS_TOL, (got, want)
            assert abs(got["grad_norm"] - want["grad_norm"]) < 1e-3 * want["grad_norm"]
        d = max(float(np.max(np.abs(a - b))) for a, b in
                zip(jax.tree.leaves(r["params"]), jax.tree.leaves(want_params)))
        assert d < PARAM_TOL, d
        # the state is split: mamba2's din, the heads, the vocab over model
        assert any(glob != loc for glob, loc in r["shapes"])


@pytest.mark.parametrize("mesh,name", _cases("prefill"), ids=_ids("prefill"))
def test_family_prefill_matches_reference(ranks, mesh, name):
    """The sharded ``"flash"`` prefill (the kernel's plain version on each
    rank's local heads; none for mamba2) against the reference's."""
    want = reference_prefill(name)
    for r in _result(ranks, mesh, ("prefill", name)):
        np.testing.assert_allclose(r["logits"], want, rtol=PREFILL_TOL, atol=PREFILL_TOL)
        assert r["placements"][-1] == "Shard(dim=2)"       # vocab over model


@pytest.mark.parametrize("mesh,name", _cases("decode"), ids=_ids("decode"))
def test_family_decode_matches_reference(ranks, mesh, name):
    """Sharded decode steps with the context encoded once on the mesh
    against the reference's ``decode_step``; the SSM states split their
    heads over ``model``, MLA's ``{c, kr}`` cache its length (both halves
    written, each position once), and the context comes back placed like
    a batch."""
    want = reference_decode(name)
    cfg = _cfg(name)
    for r in _result(ranks, mesh, ("decode", name)):
        for pos, (got, w) in enumerate(zip(r["logits"], want)):
            np.testing.assert_allclose(got, w, rtol=DECODE_TOL, atol=DECODE_TOL,
                                       err_msg=f"pos {pos}")
        if cfg.family in ("vlm", "audio"):
            assert r["context_placements"][-1] == "Replicate()"
            assert r["context_placements"][0] == (
                "Shard(dim=0)" if mesh[0] > 1 else "Replicate()")
        shapes = dict(zip(("c", "kr") if cfg.kv_lora else ("conv", "h"), r["shapes"]))
        if cfg.kv_lora:
            n, t = cfg.n_layers, DECODE_LEN
            assert shapes["c"] == ((n, DECODE_B, t, cfg.kv_lora),
                                   (n, DECODE_B // mesh[0], t // mesh[1], cfg.kv_lora))
            c = r["cache"]["kv"]["c"]
            assert np.all(np.abs(c[:, :, :DECODE_STEPS]).sum(axis=(0, 3)) > 0)
            assert not np.any(c[:, :, DECODE_STEPS:])
            assert DECODE_STEPS > t // 2         # both halves of the length
        elif cfg.family == "ssm":
            (glob, loc) = shapes["h"]
            assert loc[2] == glob[2] // mesh[1]      # the heads over model


def test_family_mesh_gate_is_gone():
    """Every family's specs build under a mesh context (the port once
    refused the SSM, hybrid, VLM, audio and MLA families there)."""
    from repro_torch.distributed.sharding import mesh_context
    from repro_torch.models import model as TM

    class Mesh:
        mesh_dim_names, shape = ("data", "model"), (1, 1)

    with mesh_context(Mesh()):
        for name in FAMILIES:
            assert TM.model_specs(_cfg(name))


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


@pytest.mark.parametrize("name", ["mamba2", "deepseek", "whisper"])
def test_family_on_one_rank_is_the_plain_port(one_rank_mesh, name):
    """On a (1, 1) mesh the sharded prefill equals the unsharded port's bit
    for bit (mamba2's local conv reads every column, MLA's heads are all
    local), and decode (the split softmax divides after its all-reduced
    sum) within 1e-6, the context encoded once each way; a serve step on
    the mesh refuses to decode whisper without its context."""
    import torch

    from repro_torch.distributed.sharding import param_pspecs, rules_for, shard_tree
    from repro_torch.models import model as TM
    from repro_torch.models.weights import params_from_numpy
    from repro_torch.serve.engine import (init_sharded_cache, make_encode_step,
                                          make_serve_step)
    from repro_torch.train.step import TrainConfig, make_prefill_step

    cfg = _cfg(name)
    params = params_from_numpy(_state(name)["params"], "cpu")
    sharded = shard_tree(params, param_pspecs(TM.model_specs(cfg),
                                              rules_for(one_rank_mesh),
                                              one_rank_mesh), one_rank_mesh)
    batch = {k: torch.from_numpy(v) for k, v in _batches(name)[0].items()}
    tcfg = TrainConfig(attn_impl="flash")
    want = make_prefill_step(cfg, tcfg)(params, batch)
    got = make_prefill_step(cfg, tcfg, one_rank_mesh)(sharded, batch)
    assert torch.equal(got.full_tensor(), want)
    raw = _context(name, DECODE_B)
    runs = {}
    for label, mesh, p in (("plain", None, params), ("sharded", one_rank_mesh, sharded)):
        cache = (init_sharded_cache(cfg, DECODE_B, DECODE_LEN, mesh) if mesh is not None
                 else TM.init_cache(cfg, DECODE_B, DECODE_LEN, "cpu"))
        context = make_encode_step(cfg, mesh)(p, raw)
        step = make_serve_step(cfg, mesh)
        out = []
        for pos in range(4):
            lg, cache = step(p, cache, batch["tokens"][:DECODE_B, pos:pos + 1], pos,
                             context)
            out.append(lg.full_tensor() if mesh is not None else lg)
        runs[label] = torch.cat(out, dim=1)
    torch.testing.assert_close(runs["sharded"], runs["plain"], rtol=1e-6, atol=1e-6)
    if raw is not None:
        with pytest.raises(ValueError, match="needs the context"):
            make_serve_step(cfg, one_rank_mesh)(
                sharded, init_sharded_cache(cfg, DECODE_B, DECODE_LEN, one_rank_mesh),
                batch["tokens"][:DECODE_B, :1], 0)

"""The port's training path (``repro_torch.train``, ``distributed/
compression``, the train-state trees of ``models/weights``) against the
reference's, on the CPU.

Parameters, train states and batches are made with numpy and passed to
both packages (``params_from_numpy``), so both see
the same values.  Tolerances: schedules to rtol 1e-6 (the same float32
formula); AdamW to 1e-6 in float32 and to one bf16 ulp for bf16 parameters
(both round the same float32 update to nearest); losses and gradients as
``torch_train_cases`` states them.  The loss and gradients of every family
are in ``test_torch_train_families.py``.
"""

import hashlib
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import store as jstore
from repro.distributed import compression as jcomp
from repro.train import adamw as jadamw
from repro.train import schedules as jsched
from repro.train import step as JS
from repro_torch import configs
from repro_torch.checkpoint import store
from repro_torch.distributed import compression as comp
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.models.weights import (params_from_numpy, state_from_numpy,
                                        state_to_numpy)
from repro_torch.train import adamw
from repro_torch.train import schedules as sched
from repro_torch.train import step as TS
from repro_torch.train.adamw import tree_leaves
from torch_train_cases import (B, CE_CHUNK, GRAD_REL, LOSS_TOL, cfgs, np_batch,
                               np_params, reference)
from torch_train_cases import rel as _rel


# --------------------------------------------------------------- schedules


@pytest.mark.parametrize("name,kw", [
    ("cosine", dict(peak_lr=3e-4, warmup=5, total=40)),
    ("cosine", dict(peak_lr=1e-2, warmup=0, total=30, min_frac=0.2)),
    ("wsd", dict(peak_lr=3e-4, warmup=5, total=40)),
    ("wsd", dict(peak_lr=1e-3, warmup=2, total=30, decay_frac=0.3)),
])
def test_schedules_match_reference(name, kw):
    steps = np.arange(kw["total"] + 6, dtype=np.int32)
    want = np.asarray(jsched.SCHEDULES[name](jnp.asarray(steps), **kw))
    got = sched.SCHEDULES[name](torch.from_numpy(steps), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # a Python step gives the same value as a tensor step
    assert float(sched.SCHEDULES[name](7, **kw)) == float(got[7])


# ------------------------------------------------------------------- AdamW


def _adam_inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": {"c": (3,), "d": (2, 3, 4)}}

    def tree(scale):
        return jax.tree.map(lambda s: (scale * rng.standard_normal(s)).astype(np.float32),
                            shapes, is_leaf=lambda x: isinstance(x, tuple))

    p = jax.tree.map(lambda a: a.astype(dtype), tree(0.5))
    g = jax.tree.map(lambda a: a.astype(dtype), tree(3.0))   # norm > clip_norm
    m, v = tree(0.1), jax.tree.map(np.abs, tree(0.01))
    return p, g, m, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [0, 5])
def test_adamw_update_matches_reference(dtype, step):
    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    p, g, m, v = _adam_inputs(np_dtype, seed=step)
    cfg = jadamw.AdamWConfig()
    jp, jm, jv, jn = jadamw.update(*(jax.tree.map(jnp.asarray, t) for t in (p, g, m, v)),
                                   jnp.asarray(step, jnp.int32), jnp.float32(3e-3), cfg)
    tp, tg, tm, tv = (params_from_numpy(t, "cpu") for t in (p, g, m, v))
    np_, nm, nv, nn = adamw.update(tp, tg, tm, tv, torch.tensor(step, dtype=torch.int32),
                                   torch.tensor(3e-3), adamw.AdamWConfig())
    assert np_ is tp and nm is tm                       # in place
    np.testing.assert_allclose(float(nn), float(jn), rtol=1e-6)
    assert float(nn) > cfg.clip_norm                    # clipping is exercised
    for got, want in zip(tree_leaves(nm) + tree_leaves(nv),
                         jax.tree.leaves(jm) + jax.tree.leaves(jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-12)
    for got, want in zip(tree_leaves(np_), jax.tree.leaves(jp)):
        assert got.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
        want = np.asarray(want, np.float32)
        got = got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
        else:                                            # one bf16 ulp
            ulp = np.exp2(np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
            assert (np.abs(got - want) <= ulp).all()


def test_clip_and_global_norm_match_reference():
    _, g, _, _ = _adam_inputs(np.float32, seed=3)
    jg, jn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    tg, tn = adamw.clip_by_global_norm(params_from_numpy(g, "cpu"), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(adamw.global_norm(tg)), 1.0, rtol=1e-6)
    for got, want in zip(tree_leaves(tg), jax.tree.leaves(jg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)


def test_init_moments_are_float32_zeros():
    p = params_from_numpy({"w": np.ones((3, 2), ml_dtypes.bfloat16)}, "cpu")
    m, v = adamw.init_moments(p)
    assert m["w"].dtype == v["w"].dtype == torch.float32
    assert not m["w"].any() and m["w"] is not v["w"]


# ------------------------------------------------------------- compression


def test_compress_decompress_matches_reference():
    rng = np.random.default_rng(0)
    g = {"a": rng.standard_normal((40, 3)).astype(np.float32),
         "b": {"c": (1e-3 * rng.standard_normal(17)).astype(np.float32)}}
    ef = jax.tree.map(lambda a: (0.01 * rng.standard_normal(a.shape)).astype(np.float32), g)
    jd, je = jcomp.compress_decompress(jax.tree.map(jnp.asarray, g),
                                       jax.tree.map(jnp.asarray, ef))
    td, te = comp.compress_decompress(params_from_numpy(g, "cpu"),
                                      params_from_numpy(ef, "cpu"))
    for got, want in zip(tree_leaves(td) + tree_leaves(te),
                         jax.tree.leaves(jd) + jax.tree.leaves(je)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)
    assert len(torch.unique(td["a"])) <= 255          # int8 levels


def test_compression_error_feedback_bounded():
    """tests/test_distributed.py::test_compression_error_feedback_bounded
    on the port: the accumulated quantized sum tracks the exact sum."""
    g = {"a": torch.linspace(-1, 1, 100)}
    ef = {"a": torch.zeros(100)}
    total, exact = torch.zeros(100), torch.zeros(100)
    for _ in range(10):
        dq, ef = comp.compress_decompress(g, ef)
        total, exact = total + dq["a"], exact + g["a"]
    assert float((total - exact).abs().max()) < 0.05


# ------------------------------------------------------------- chunked CE


@pytest.mark.parametrize("s,chunk", [(13, 5), (16, 16), (16, 4)])
def test_chunked_ce_matches_reference_and_unchunked(s, chunk):
    cfg = configs.get_smoke("internlm2-1.8b")
    jcfg = jconfigs.get_smoke("internlm2-1.8b")
    rng = np.random.default_rng(s * chunk)
    emb = (0.5 * rng.standard_normal((cfg.vocab, cfg.d_model))).astype(np.float32)
    x = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    mask = (rng.random((B, s)) < 0.8).astype(np.float32)

    def jloss(e, x):
        return JS.chunked_ce({"embedding": e}, x, jnp.asarray(labels),
                             jnp.asarray(mask), jcfg, chunk)

    jl, (jge, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(emb),
                                                              jnp.asarray(x))
    te = torch.from_numpy(emb).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    tl = TS.chunked_ce({"embedding": te}, tx, torch.from_numpy(labels),
                       torch.from_numpy(mask), cfg, chunk)
    ge, gx = torch.autograd.grad(tl, (te, tx))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_TOL)
    assert _rel(ge.numpy(), np.asarray(jge)) <= GRAD_REL
    assert _rel(gx.numpy(), np.asarray(jgx)) <= GRAD_REL
    # against one unchunked cross-entropy over every masked position
    logits = tx @ te.t()
    per = torch.nn.functional.cross_entropy(logits.reshape(-1, cfg.vocab),
                                            torch.from_numpy(labels).long().reshape(-1),
                                            reduction="none")
    whole = (per * torch.from_numpy(mask).reshape(-1)).sum() / float(mask.sum())
    np.testing.assert_allclose(float(tl), float(whole), rtol=LOSS_TOL)
    we, wx = torch.autograd.grad(whole, (te, tx))
    assert _rel(ge.numpy(), we.numpy()) <= GRAD_REL
    assert _rel(gx.numpy(), wx.numpy()) <= GRAD_REL


def test_chunked_ce_all_masked_is_zero_not_nan():
    cfg = configs.get_smoke("internlm2-1.8b")
    x = torch.randn(1, 4, cfg.d_model, generator=torch.Generator().manual_seed(1))
    loss = TS.chunked_ce({"embedding": torch.ones(cfg.vocab, cfg.d_model)}, x,
                         torch.zeros(1, 4, dtype=torch.int32), torch.zeros(1, 4),
                         cfg, 3)
    assert float(loss) == 0.0


# --------------------------------------------------------- whole train step


def _step_close(name, got, want, lr, m_got, m_want):
    """Parameters after Adam's first step move by lr·(ĝ/(|ĝ| + eps) + wd·p):
    where |ĝ| is near eps (1e-8) the move is sensitive to ĝ's last digits,
    and under compression an element within float noise of an int8
    rounding boundary takes the next level (and may flip sign).  So each
    parameter is held to 1e-4·lr where both packages' m agree (to 1e-4)
    and |m| = 0.1·|ĝ| is at least 1e-6 (|ĝ| ≥ 1e3·eps), and everywhere to
    2·lr (the largest flip), with at most 1% of a leaf's elements outside
    the tight bound."""
    diff = np.abs(got - want)
    tight = 1e-4 * lr + 1e-6 * np.abs(want)
    held = (np.abs(m_want) >= 1e-6) & (np.abs(m_got - m_want) <= 1e-4 * np.abs(m_want))
    assert (diff[held] <= tight[held]).all(), name
    assert (diff <= 2 * lr * (1 + 1e-5)).all(), name
    assert np.mean(diff > tight) <= 0.01, name


@pytest.mark.parametrize("variant", ["plain", "grad_accum", "compress"])
def test_train_step_matches_reference(variant):
    arch = "internlm2-1.8b"
    jcfg, cfg = cfgs(arch)
    kw = dict(peak_lr=1e-2, warmup=0, total_steps=10, ce_chunk=CE_CHUNK,
              attn_impl="chunked", grad_accum=2 if variant == "grad_accum" else 1,
              compress_grads=variant == "compress")
    params = np_params(cfg, seed=4)
    zeros = jax.tree.map(np.zeros_like, params)
    jstate = {"params": params, "m": zeros, "v": zeros, "step": np.zeros((), np.int32)}
    if kw["compress_grads"]:
        jstate["ef"] = zeros
    batch = np_batch(cfg, 2)
    jnew, jmet = jax.jit(JS.make_train_step(jcfg, JS.TrainConfig(**kw)))(
        jax.tree.map(jnp.asarray, jstate), {k: jnp.asarray(v) for k, v in batch.items()})
    state = params_from_numpy(jstate, "cpu")
    new, met = TS.make_train_step(cfg, TS.TrainConfig(**kw))(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert int(new["step"]) == int(jnew["step"]) == 1
    assert all(isinstance(v, torch.Tensor) for v in met.values())
    lr = float(jmet["lr"])
    np.testing.assert_allclose(float(met["lr"]), lr, rtol=1e-6)
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]),
                               rtol=GRAD_REL)
    jm, jv = jax.tree.leaves(jnew["m"]), jax.tree.leaves(jnew["v"])
    for i, (m, v, wm, wv) in enumerate(zip(tree_leaves(new["m"]), tree_leaves(new["v"]),
                                           jm, jv)):
        wm, wv = np.asarray(wm), np.asarray(wv)
        if variant == "compress":
            # a value within float noise of a rounding boundary takes the
            # next int8 level: m = 0.1·clip·deq is then one level
            # (max|m| / 127) apart, on at most 1% of a leaf
            level = np.abs(wm).max() / 127
            dm = np.abs(m.numpy() - wm)
            same = dm <= 1e-6 * level * 127
            assert dm.max() <= level * (1 + 1e-4) and same.mean() >= 0.99, i
            np.testing.assert_allclose(v.numpy()[same], wv[same], rtol=1e-5, atol=0)
        else:
            assert _rel(m.numpy(), wm) <= GRAD_REL, i
            assert _rel(v.numpy(), wv) <= 2 * GRAD_REL, i
    for i, (p, wp, m, wm) in enumerate(zip(tree_leaves(new["params"]),
                                           jax.tree.leaves(jnew["params"]),
                                           tree_leaves(new["m"]), jm)):
        _step_close(f"param leaf {i}", p.numpy(), np.asarray(wp), lr, m.numpy(),
                    np.asarray(wm))
    if variant == "compress":
        for e, we in zip(tree_leaves(new["ef"]), jax.tree.leaves(jnew["ef"])):
            assert e.dtype == torch.float32 and e.shape == we.shape


def test_prefill_step_matches_reference():
    jcfg, cfg = cfgs("internlm2-1.8b")
    jparams, batch, _, _ = reference("internlm2-1.8b", "chunked")
    want = JS.make_prefill_step(jcfg, JS.TrainConfig())(
        jax.tree.map(jnp.asarray, jparams), {"tokens": jnp.asarray(batch["tokens"])})
    got = TS.make_prefill_step(cfg, TS.TrainConfig())(
        params_from_numpy(jparams, "cpu"), {"tokens": torch.from_numpy(batch["tokens"])})
    assert tuple(got.shape) == (B, 1, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-3)


# ---------------------------------------------------- the kernels under grad


def test_flash_train_step_raises():
    cfg = configs.get_smoke("internlm2-1.8b")
    with pytest.raises(ValueError, match="no backward"):
        TS.make_train_step(cfg, TS.TrainConfig(attn_impl="flash"))
    with pytest.raises(ValueError, match="not 'pallas'"):
        TS.make_train_step(cfg, TS.TrainConfig(attn_impl="pallas"))


def test_kernel_wrappers_raise_under_grad():
    """On the CPU each wrapper would differentiate its plain version, while
    the card's kernel would return a detached result: both raise instead."""
    q = torch.randn(1, 2, 8, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_attention has no backward"):
        ops.flash_attention(q, q.detach(), q.detach())
    cfg = configs.get_smoke("internlm2-1.8b")
    params = params_from_numpy(reference("internlm2-1.8b", "chunked")[0], "cpu")
    params["layers"]["attn"]["wq"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="'dense' or 'chunked'"):
        M.forward(params, {"tokens": torch.zeros(1, 4, dtype=torch.int32)}, cfg,
                  impl="flash")
    x = torch.randn(6, 3, requires_grad=True)
    codes = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="covar_xtx has no backward"):
        ops.covar_xtx(x)
    with pytest.raises(RuntimeError, match="seg_aggregate has no backward"):
        ops.seg_aggregate(codes, x, 2)
    with pytest.raises(RuntimeError, match="tree_hist has no backward"):
        ops.tree_hist(codes, x[:, 0], torch.ones(6), 2)
    with pytest.raises(RuntimeError, match="tree_hist_batched has no backward"):
        ops.tree_hist_batched(codes, x[:, 0], torch.ones(6, 2), 2)
    with pytest.raises(RuntimeError, match="fused_scan_block has no backward"):
        ops.fused_scan_block(codes[:, None], x, [ops.ReduceSpec("seg", 0, 2, 3, 0)])
    # no grad recorded: the same calls run
    with torch.no_grad():
        assert ops.flash_attention(q, q, q).shape == q.shape
        assert ops.covar_xtx(x).shape == (3, 3)
    assert ops.seg_aggregate(codes, x.detach(), 2).shape == (2, 3)


# ------------------------------------------------------ train-state trees


def test_state_numpy_round_trip_is_bitwise():
    cfg = configs.get_smoke("internlm2-1.8b").with_(dtype="bfloat16")
    tcfg = TS.TrainConfig(compress_grads=True)
    gen = torch.Generator().manual_seed(3)
    state = TS.init_state(cfg, tcfg, gen, "cpu")
    state["step"] += 7
    host = state_to_numpy(state)
    assert host["params"]["embedding"].dtype == np.dtype("V2")
    assert host["step"].dtype == np.int32 and host["step"].shape == ()
    back = state_from_numpy(host, like=state)
    for a, b in zip(tree_leaves(state), tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a.view(-1).view(torch.uint8)
                                                  if a.dim() else a,
                                                  b.view(-1).view(torch.uint8)
                                                  if b.dim() else b)
    with pytest.raises(ValueError, match="does not restore"):
        state_from_numpy({"w": np.zeros(3, np.float32)},
                         like={"w": torch.zeros(3, dtype=torch.bfloat16)})


def test_bf16_leaf_file_matches_reference(tmp_path):
    """The same bf16 values saved by the reference's store (an
    ``ml_dtypes.bfloat16`` array) and by the port's (``state_to_numpy``'s
    ``'V2'`` bits): the same ``.npy`` bytes, sha and manifest dtype; each
    store restores the other's file to the same bits."""
    vals = np.random.default_rng(0).standard_normal((5, 3)).astype(ml_dtypes.bfloat16)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    jstore.save(str(ref_dir), 1, {"w": vals})
    port_tree = state_to_numpy({"w": params_from_numpy({"w": vals}, "cpu")["w"]})
    store.save(str(port_dir), 1, port_tree)
    f = "step_00000001/w.npy"
    assert (ref_dir / f).read_bytes() == (port_dir / f).read_bytes()
    jm = json.loads((ref_dir / "step_00000001/manifest.json").read_text())
    pm = json.loads((port_dir / "step_00000001/manifest.json").read_text())
    assert jm == pm
    assert pm["leaves"]["w"]["sha"] == hashlib.sha256(vals.tobytes()).hexdigest()[:16]
    like = {"w": torch.zeros(5, 3, dtype=torch.bfloat16)}
    for d in (ref_dir, port_dir):
        t = state_from_numpy(store.restore(str(d), like)[0], like=like)["w"]
        assert torch.equal(t.view(torch.int16),
                           torch.from_numpy(vals.view(np.int16)))

"""The port's MLA (deepseek-v2-lite), VLM (llama-3.2-vision) and audio
(whisper) families, and ``flash_attention`` at D_q ≠ D_v, against the
reference on the CPU.

Inputs come from numpy seeds; weights are the reference's ``init_params``
carried across by ``params_from_numpy``.  Tolerances are PR 21's family
tests', the reference's own: 2e-3 between attention implementations
(tests/test_models.py:109, tests/test_kernels.py:185) and 5e-3 between
teacher-forced decode and the forward (tests/test_models.py:70).  The
reference's ``pallas`` attention sizes V and the output by q's width, so
MLA is held against its ``dense`` and ``chunked`` attention; the kernel's
Pallas oracle is used at D_q = D_v only.  The contexts (vision embeddings,
audio frames) are N(0, 1), so cross-attention moves the logits well past
the tolerance (checked).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.layers import init_params as j_init_params
from repro.serve.engine import BatchedServer as JServer
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models import layers as TL
from repro_torch.models import model as M
from repro_torch.models.layers import init_params
from repro_torch.models.weights import params_from_numpy
from repro_torch.serve.engine import BatchedServer

NEW = ["deepseek-v2-lite-16b", "llama-3.2-vision-90b", "whisper-small"]
B, S = 2, 40
TOL = dict(rtol=2e-3, atol=2e-3)
DECODE_TOL = dict(rtol=5e-3, atol=5e-3)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _context(cfg, rng, b=B):
    """The raw context batch entry of a VLM or audio config, else {}."""
    if cfg.family == "vlm":
        return {"vision": rng.normal(size=(b, cfg.vision_tokens, cfg.d_model))
                .astype(np.float32)}
    if cfg.family == "audio":
        return {"frames": rng.normal(size=(b, cfg.encoder_frames, cfg.d_model))
                .astype(np.float32)}
    return {}


def _setup(arch, seed=0, s=S):
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jparams = j_init_params(JM.model_specs(jcfg), jax.random.PRNGKey(seed),
                            jcfg.jdtype)
    params = params_from_numpy(_np_tree(jparams), "cpu")
    rng = np.random.default_rng(seed + 1)
    tokens = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    return jcfg, cfg, jparams, params, tokens, _context(cfg, rng)


def _batches(tokens, ctx):
    jb = {"tokens": jnp.asarray(tokens), **{k: jnp.asarray(v) for k, v in ctx.items()}}
    tb = {"tokens": torch.from_numpy(tokens),
          **{k: torch.from_numpy(v) for k, v in ctx.items()}}
    return jb, tb


@pytest.mark.parametrize("arch", NEW)
def test_new_family_forward_matches_reference(arch):
    """Every port implementation (``flash`` runs the plain version here)
    against the reference's ``dense`` and ``chunked`` at S = 40."""
    jcfg, cfg, jparams, params, tokens, ctx = _setup(arch)
    jb, tb = _batches(tokens, ctx)
    want = [np.asarray(JM.forward(jparams, jb, jcfg, impl=impl)[0])
            for impl in ("dense", "chunked")]
    ops.reset_launches()
    for impl in ("flash", "chunked", "dense"):
        logits, aux = M.forward(params, tb, cfg, impl=impl)
        assert tuple(logits.shape) == (B, S, cfg.vocab)
        for w in want:
            np.testing.assert_allclose(logits.numpy(), w, **TOL,
                                       err_msg=f"{arch} {impl}")
    assert sum(ops.LAUNCHES.values()) == 0           # the CPU runs no kernel
    if ctx:
        # the context reaches the logits: another one moves them
        other = {k: torch.from_numpy(v[::-1].copy()) for k, v in ctx.items()}
        moved = M.forward(params, {**tb, **other}, cfg)[0]
        assert float((moved - logits).abs().max()) > 10 * TOL["atol"]


@pytest.mark.parametrize("arch", NEW)
def test_new_family_decode_matches_reference_and_forward(arch):
    """Teacher-forced decode (MLA's latent cache, the VLM's and whisper's
    KV caches in place, the encoded context) against the reference's
    decode_step and against the port's forward; the caches end equal."""
    s = 16
    jcfg, cfg, jparams, params, tokens, ctx = _setup(arch, s=s)
    jb, tb = _batches(tokens, ctx)
    full = M.forward(params, tb, cfg)[0].numpy()
    jctx = JM.encode_context(jparams, jb, jcfg)
    tctx = M.encode_context(params, tb, cfg)
    assert (tctx is None) == (jctx is None)
    if tctx is not None:
        np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx), **TOL)
    cache = M.init_cache(cfg, B, s, "cpu")
    jcache = j_init_params(JM.cache_specs(jcfg, B, s), jax.random.PRNGKey(0),
                           jcfg.jdtype)
    jstep = jax.jit(lambda p, c, t, pos, x: JM.decode_step(p, c, t, pos, jcfg,
                                                           context=x))
    for pos in range(s):
        lg, cache = M.decode_step(params, cache, torch.from_numpy(tokens[:, pos:pos + 1]),
                                  pos, cfg, context=tctx)
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, pos:pos + 1]),
                            jnp.asarray(pos, jnp.int32), jctx)
        np.testing.assert_allclose(lg[:, 0].numpy(), np.asarray(jlg[:, 0]),
                                   **DECODE_TOL, err_msg=f"{arch} {pos}")
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, pos], **DECODE_TOL,
                                   err_msg=f"{arch} {pos}")
    flat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert len(flat) == len(jax.tree.leaves(cache))
    for path, want in flat:
        got = cache
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **DECODE_TOL,
                                   err_msg=f"{arch} {path}")
    if cfg.kv_lora:
        assert set(cache["kv"]) == {"c", "kr"}
        assert cache["kv"]["c"].shape == (cfg.n_layers, B, s, cfg.kv_lora)


@pytest.mark.parametrize("arch", NEW)
def test_new_family_generate_matches_reference(arch):
    """The same greedy tokens from the same weights, prompts and raw
    context (encoded once by each server); a second call reuses the
    cache."""
    jcfg, cfg, jparams, params, tokens, ctx = _setup(arch, seed=2)
    raw = next(iter(ctx.values()), None)
    prompts, n_gen = tokens[:, :5], 11
    want = JServer(jcfg, jparams, max_len=5 + n_gen, batch=B,
                   context=None if raw is None else jnp.asarray(raw)
                   ).generate(prompts, n_gen)
    server = BatchedServer(cfg, params, max_len=5 + n_gen, batch=B,
                           device="cpu", context=raw)
    np.testing.assert_array_equal(server.generate(prompts, n_gen), want)
    np.testing.assert_array_equal(server.generate(prompts, n_gen), want)
    with pytest.raises(ValueError, match="cache entries"):
        server.generate(prompts, n_gen + 2)     # 5 + 13 − 1 > 16 entries


def _qkv(b, h, hkv, sq, sk, dq, dv, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, sq, dq)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, dq)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, dv)).astype(np.float32))


@pytest.mark.parametrize("sq,sk,causal", [(40, 40, True), (40, 24, True),
                                          (40, 24, False), (24, 40, False)])
def test_flash_attention_mla_widths_match_dense(sq, sk, causal):
    """D_q = 192, D_v = 128 (MLA's prefill) against the reference's
    ``_dense_attention`` on (B, S, H, D) layouts: the output is V's width,
    scaled by q's."""
    q, k, v = _qkv(2, 4, 2, sq, sk, 192, 128, seed=sq + sk)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal)
    assert tuple(got.shape) == (2, 4, sq, 128)
    want = JL._dense_attention(*(jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v)),
                               causal=causal, window=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 2, 1, 3),
                               **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_192_matches_pallas_interpret(causal):
    """D_q = D_v = 192 against the reference's Pallas kernel in interpret
    mode (which takes V's width from q's, so only at D_v = D_q)."""
    q, k, v = _qkv(1, 4, 2, 64, 64, 192, 192, seed=3)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, block_q=32, block_k=32,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("s,chunk", [(40, 16), (33, 64)])
def test_chunked_attention_returns_v_width(s, chunk):
    """Query chunks at D_q = 48, D_v = 32 against the reference's chunked
    attention and the port's dense one."""
    rng = np.random.default_rng(s)
    q = rng.normal(size=(2, s, 4, 48)).astype(np.float32)
    k = rng.normal(size=(2, s, 2, 48)).astype(np.float32)
    v = rng.normal(size=(2, s, 2, 32)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = TL.attention_core(tq, tk, tv, causal=True, impl="chunked", chunk=chunk)
    assert tuple(got.shape) == (2, s, 4, 32)
    np.testing.assert_allclose(
        got.numpy(), TL.attention_core(tq, tk, tv, causal=True, impl="dense").numpy(),
        rtol=2e-4, atol=2e-4)
    want = JL.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, impl="chunked", chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dq,dk,dv,match", [
    (200, 200, 128, "D_q"),                 # past 192
    (64, 64, 128, "D_v"),                   # D_v > D_q
    (192, 128, 128, "D_k"),                 # k's width is not q's
    (96, 96, 104, "D_v"),                   # D_v > D_q, neither a power of 2
])
def test_flash_attention_wrapper_names_the_dimension(dq, dk, dv, match):
    """The wrapper refuses, on the CPU as on the card, the widths the kernel
    does not take, and says which."""
    q, k, v = (torch.zeros(1, 2, 8, d) for d in (dq, dk, dv))
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(q, k, v)


@pytest.mark.parametrize("arch", NEW)
def test_params_from_numpy_carries_new_trees(arch):
    """The reference's MLA, VLM (two-level ``super`` stacks) and audio
    trees reach the port with the keys, shapes, dtypes and values of the
    port's own ``model_specs``; the cache specs agree with the
    reference's."""
    jcfg, cfg, jparams, params, _, _ = _setup(arch)
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    specs = M.model_specs(cfg)
    n = 0
    for path, want in flat:
        got, spec = params, specs
        for key in path:
            got, spec = got[key.key], spec[key.key]
        assert tuple(got.shape) == spec.shape == want.shape
        assert got.dtype == cfg.torch_dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        n += 1
    assert n == len(jax.tree.leaves(params))
    if cfg.family == "vlm":
        n_super = cfg.n_layers // cfg.cross_every
        assert params["super"]["self"]["attn"]["wq"].shape[:2] == (
            n_super, cfg.cross_every - 1)
        assert M.layer(params["super"]["self"], 1, 0)["attn"]["wq"].data_ptr() == \
            params["super"]["self"]["attn"]["wq"][1, 0].data_ptr()
    jc = jax.tree.map(lambda s: s.shape, JM.cache_specs(jcfg, B, 24),
                      is_leaf=lambda x: hasattr(x, "axes"))
    tc = M.init_cache(cfg, B, 24, "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), tc) == jc


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_every_config_serves_on_cpu(arch):
    """All ten configs build, run forward, decode_step and
    BatchedServer.generate at smoke size (S a multiple of the SSD chunk)."""
    cfg = configs.get_smoke(arch)
    params = init_params(M.model_specs(cfg), torch.Generator().manual_seed(0),
                         cfg.torch_dtype, "cpu")
    rng = np.random.default_rng(0)
    ctx = _context(cfg, rng)
    tokens = rng.integers(0, cfg.vocab, (B, 16))
    _, tb = _batches(tokens, ctx)
    logits, _ = M.forward(params, tb, cfg)
    assert tuple(logits.shape) == (B, 16, cfg.vocab) and bool(torch.isfinite(logits).all())
    cache = M.init_cache(cfg, B, 8, "cpu")
    lg, _ = M.decode_step(params, cache, tb["tokens"][:, :1], 0, cfg,
                          context=M.encode_context(params, tb, cfg))
    assert tuple(lg.shape) == (B, 1, cfg.vocab)
    raw = next(iter(ctx.values()), None)
    out = BatchedServer(cfg, params, max_len=8, batch=B, device="cpu",
                        context=raw).generate(tokens[:, :3].astype(np.int32), 5)
    assert out.shape == (B, 8) and ((out >= 0) & (out < cfg.vocab)).all()

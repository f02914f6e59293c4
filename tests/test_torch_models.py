"""The port's LM stack (dense family) against the reference, on the CPU.

Inputs come from numpy seeds; weights are the reference's ``init_params``
carried across by ``params_from_numpy``.  Tolerances are the reference's
own: 2e-3 between attention implementations and for the float32 kernel
(tests/test_kernels.py:185, tests/test_models.py:109), 5e-2 for bf16
attention (tests/test_kernels.py:197), 5e-3 between teacher-forced decode
and the forward (tests/test_models.py:70) and 2e-2 on the ring-buffer path
(tests/test_models.py:93).  On the CPU the port's ``flash_attention`` runs
its plain version; the CUDA kernel is held against that in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import model as JM
from repro.models.layers import init_params as j_init_params
from repro.serve.engine import BatchedServer as JServer
from repro_torch import configs
from repro_torch.kernels import ops, ref
from repro_torch.models import model as M
from repro_torch.models.layers import init_params
from repro_torch.models.weights import params_from_numpy
from repro_torch.serve.engine import BatchedServer, greedy

DENSE = ["llama3-8b", "internlm2-1.8b", "minicpm-2b", "h2o-danube-3-4b"]
B, S = 2, 40          # S = 40: a ragged tile for the kernel's 64-row tiles


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(arch, seed=0, s=S, **overrides):
    """The reference's smoke config and weights, and the port's copy."""
    jcfg = jconfigs.get_smoke(arch).with_(**overrides)
    cfg = configs.get_smoke(arch).with_(**overrides)
    jparams = j_init_params(JM.model_specs(jcfg), jax.random.PRNGKey(seed),
                            jcfg.jdtype)
    params = params_from_numpy(_np_tree(jparams), "cpu")
    tokens = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (B, s)).astype(np.int32)
    return jcfg, cfg, jparams, params, tokens


@pytest.mark.parametrize("b,h,hkv,s,d", [(1, 2, 1, 64, 8), (2, 4, 2, 100, 16),
                                         (1, 4, 4, 96, 32)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24), (False, 0)])
def test_flash_attention_matches_reference(b, h, hkv, s, d, causal, window):
    """The cases of tests/test_kernels.py::test_flash_attention."""
    rng = np.random.default_rng(b * s)
    q = rng.normal(size=(b, h, s, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window).numpy()
    want_kernel = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal,
                                       window=window, block_q=32, block_k=32,
                                       interpret=True)
    want_ref = jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want_kernel), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, np.asarray(want_ref), rtol=2e-3, atol=2e-3)


def test_flash_attention_bf16_matches_reference():
    """The case of tests/test_kernels.py::test_flash_attention_bf16, the same
    bf16 inputs on both sides."""
    rng = np.random.default_rng(7)
    q, k, v = (jnp.asarray(rng.normal(size=(1, 2, 64, 16)), jnp.bfloat16)
               for _ in range(3))
    tq, tk, tv = (params_from_numpy(np.asarray(a), "cpu") for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    want_kernel = jops.flash_attention(q, k, v, causal=True, block_q=32,
                                       block_k=32, interpret=True)
    want_ref = jref.attention_ref(q, k, v, causal=True)
    for want in (want_kernel, want_ref):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=5e-2, atol=5e-2)


def test_attention_ref_rows_without_keys_are_zero():
    """A window of 1 over a shorter key sequence: rows i >= S_k see no key
    and output 0, as the kernel's clamped denominator gives."""
    q = torch.ones(1, 1, 6, 8)
    k = v = torch.ones(1, 1, 3, 8)
    out = ref.attention_ref(q, k, v, causal=True, window=1)
    assert torch.equal(out[0, 0, 3:], torch.zeros(3, 8))
    assert torch.equal(out[0, 0, :3], torch.ones(3, 8))


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(arch):
    """Both port implementations against both reference ones at S = 40."""
    jcfg, cfg, jparams, params, tokens = _setup(arch)
    jbatch = {"tokens": jnp.asarray(tokens)}
    want = {impl: np.asarray(JM.forward(jparams, jbatch, jcfg, impl=impl)[0])
            for impl in ("dense", "pallas")}
    batch = {"tokens": torch.from_numpy(tokens)}
    for impl in ("flash", "dense"):
        logits, aux = M.forward(params, batch, cfg, impl=impl)
        assert tuple(logits.shape) == (B, S, cfg.vocab)
        assert float(aux["aux_loss"]) == 0.0
        for w in want.values():
            np.testing.assert_allclose(logits.numpy(), w, rtol=2e-3, atol=2e-3,
                                       err_msg=f"{arch} {impl}")


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_reference_and_forward(arch):
    """Teacher-forced decode through the in-place cache against the
    reference's decode_step and against the port's forward."""
    s = 16
    jcfg, cfg, jparams, params, tokens = _setup(arch, s=s)
    full = M.forward(params, {"tokens": torch.from_numpy(tokens)}, cfg)[0].numpy()
    cache = init_params(M.cache_specs(cfg, B, s), None, cfg.torch_dtype, "cpu")
    jcache = j_init_params(JM.cache_specs(jcfg, B, s), jax.random.PRNGKey(0),
                           jcfg.jdtype)
    jstep = jax.jit(lambda p, c, t, pos: JM.decode_step(p, c, t, pos, jcfg))
    tol = 2e-2 if cfg.window else 5e-3
    for pos in range(s):
        lg, cache = M.decode_step(params, cache, torch.from_numpy(tokens[:, pos:pos + 1]),
                                  pos, cfg)
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, pos:pos + 1]),
                            jnp.asarray(pos, jnp.int32))
        np.testing.assert_allclose(lg[:, 0].numpy(), np.asarray(jlg[:, 0]),
                                   rtol=5e-3, atol=5e-3, err_msg=f"{arch} {pos}")
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, pos], rtol=tol,
                                   atol=tol, err_msg=f"{arch} {pos}")
    for name in ("k", "v"):
        np.testing.assert_allclose(cache["kv"][name].numpy(),
                                   np.asarray(jcache["kv"][name]),
                                   rtol=5e-3, atol=5e-3)


def test_swa_ring_buffer_window_semantics():
    """tests/test_models.py::test_swa_ring_buffer_window_semantics on the
    port: a window-sized ring cache, smaller than the sequence, decodes as
    a forward whose attention window matches the ring."""
    s = 16
    jcfg, cfg, jparams, params, tokens = _setup("h2o-danube-3-4b", seed=1,
                                                s=s, window=8)
    full = M.forward(params, {"tokens": torch.from_numpy(tokens)}, cfg)[0].numpy()
    cache = init_params(M.cache_specs(cfg, B, s), None, cfg.torch_dtype, "cpu")
    assert cache["kv"]["k"].shape[2] == 8 < s
    for pos in range(s):
        lg, cache = M.decode_step(params, cache, torch.from_numpy(tokens[:, pos:pos + 1]),
                                  pos, cfg)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, pos], rtol=2e-2,
                                   atol=2e-2, err_msg=f"pos {pos}")


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "h2o-danube-3-4b"])
def test_generate_matches_reference(arch):
    """The same greedy tokens from the same weights and prompts (h2o-danube's
    16-entry window makes its 5 + 14 positions wrap the ring)."""
    jcfg, cfg, jparams, params, tokens = _setup(arch, seed=2)
    prompts = tokens[:, :5]
    n_gen = 14
    want = JServer(jcfg, jparams, max_len=5 + n_gen, batch=B).generate(prompts, n_gen)
    server = BatchedServer(cfg, params, max_len=5 + n_gen, batch=B, device="cpu")
    got = server.generate(prompts, n_gen)
    np.testing.assert_array_equal(got, want)
    # a second call reuses the cache without clearing it
    np.testing.assert_array_equal(server.generate(prompts, n_gen), want)


def test_greedy_takes_the_first_of_tied_maxima():
    logits = torch.tensor([[[0.0, 2.0, 2.0, 1.0]], [[3.0, 3.0, 3.0, 3.0]]])
    assert greedy(logits).tolist() == [[1], [0]]
    jl = np.asarray(jnp.argmax(jnp.asarray(logits.numpy())[:, -1], axis=-1))
    assert greedy(logits)[:, 0].tolist() == jl.tolist()


def test_params_from_numpy_keeps_bf16_bits():
    rng = np.random.default_rng(3)
    tree = {"a": rng.normal(size=(3, 5)).astype(ml_dtypes.bfloat16),
            "layers": {"w": rng.normal(size=(2, 4, 4)).astype(ml_dtypes.bfloat16),
                       "n": np.arange(6, dtype=np.int32)}}
    got = params_from_numpy(tree, "cpu")
    assert got["a"].dtype == torch.bfloat16
    for want, t in ((tree["a"], got["a"]), (tree["layers"]["w"], got["layers"]["w"])):
        back = t.view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(back, want.view(np.uint16))
    assert got["layers"]["n"].dtype == torch.int32
    # a copy: writing into it (as decode does into a cache) leaves the source
    got["layers"]["n"][0] = 7
    assert tree["layers"]["n"][0] == 0


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_match_reference(arch):
    for full in (True, False):
        cfg = configs.get(arch) if full else configs.get_smoke(arch)
        jcfg = jconfigs.get(arch) if full else jconfigs.get_smoke(arch)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        fields = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}
        assert fields == {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
        assert cfg.torch_dtype == {"bfloat16": torch.bfloat16,
                                   "float32": torch.float32}[cfg.dtype]


def test_model_specs_match_reference_shapes():
    jcfg, cfg = jconfigs.get("internlm2-1.8b"), configs.get("internlm2-1.8b")
    want = jax.tree.map(lambda s: s.shape, JM.model_specs(jcfg),
                        is_leaf=lambda x: hasattr(x, "axes"))
    got = M.model_specs(cfg)
    flat = {}

    def walk(t, path):
        if hasattr(t, "axes"):
            flat[path] = t.shape
        else:
            for k, v in t.items():
                walk(v, path + (k,))
    walk(got, ())
    assert flat == {tuple(getattr(k, "key") for k in p): v
                    for p, v in jax.tree_util.tree_flatten_with_path(
                        want, is_leaf=lambda x: isinstance(x, tuple))[0]}
    n = sum(int(np.prod(s)) for s in flat.values())
    assert n == cfg.param_count()


def test_lm_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults would succeed")
    cfg = configs.get_smoke("internlm2-1.8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(M.model_specs(cfg), None, cfg.torch_dtype)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedServer(cfg, {}, max_len=8, batch=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.zeros(2)})


# -- the MoE, SSM and hybrid families -----------------------------------------

FAMILIES = ["qwen3-moe-235b-a22b", "mamba2-2.7b", "zamba2-1.2b"]
#: the smoke configs, and zamba2's with 5 layers: 2 groups and a 1-layer tail
FAMILY_CASES = [pytest.param(a, {}, id=a) for a in FAMILIES] + [
    pytest.param("zamba2-1.2b", {"n_layers": 5}, id="zamba2-1.2b-tail")]


@pytest.mark.parametrize("arch,overrides", FAMILY_CASES)
def test_family_forward_matches_reference(arch, overrides):
    """Every port implementation against the reference's ``dense`` (and
    ``pallas`` in interpret mode where attention runs) at S = 40, a multiple
    of the smoke SSD chunk (8); qwen3-moe's 80 tokens make 20 dispatch
    groups of capacity 2, so assignments are dropped."""
    jcfg, cfg, jparams, params, tokens = _setup(arch, **overrides)
    assert ("tail" in params) == bool(cfg.family == "hybrid"
                                      and cfg.n_layers % cfg.attn_every)
    jbatch = {"tokens": jnp.asarray(tokens)}
    impls = ("dense",) if cfg.family == "ssm" else ("dense", "pallas")
    want = {impl: JM.forward(jparams, jbatch, jcfg, impl=impl) for impl in impls}
    batch = {"tokens": torch.from_numpy(tokens)}
    for impl in ("flash", "dense", "chunked"):
        logits, aux = M.forward(params, batch, cfg, impl=impl)
        assert tuple(logits.shape) == (B, S, cfg.vocab)
        for w_logits, w_aux in want.values():
            np.testing.assert_allclose(logits.numpy(), np.asarray(w_logits),
                                       rtol=2e-3, atol=2e-3, err_msg=f"{arch} {impl}")
            np.testing.assert_allclose(float(aux["aux_loss"]), float(w_aux["aux_loss"]),
                                       rtol=1e-5, atol=1e-5)
    if cfg.family == "moe":
        assert float(aux["aux_loss"]) > 0.0


@pytest.mark.parametrize("arch,overrides", FAMILY_CASES)
def test_family_decode_matches_reference_and_forward(arch, overrides):
    """Teacher-forced decode (SSM states and KV caches in place) against the
    reference's decode_step and against the port's forward: for Mamba2 the
    O(1) recurrence against the chunked SSD."""
    s = 16
    jcfg, cfg, jparams, params, tokens = _setup(arch, s=s, **overrides)
    full = M.forward(params, {"tokens": torch.from_numpy(tokens)}, cfg)[0].numpy()
    cache = M.init_cache(cfg, B, s, "cpu")
    jcache = j_init_params(JM.cache_specs(jcfg, B, s), jax.random.PRNGKey(0),
                           jcfg.jdtype)
    jstep = jax.jit(lambda p, c, t, pos: JM.decode_step(p, c, t, pos, jcfg))
    for pos in range(s):
        lg, cache = M.decode_step(params, cache, torch.from_numpy(tokens[:, pos:pos + 1]),
                                  pos, cfg)
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(tokens[:, pos:pos + 1]),
                            jnp.asarray(pos, jnp.int32))
        np.testing.assert_allclose(lg[:, 0].numpy(), np.asarray(jlg[:, 0]),
                                   rtol=5e-3, atol=5e-3, err_msg=f"{arch} {pos}")
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, pos], rtol=5e-3,
                                   atol=5e-3, err_msg=f"{arch} {pos}")
    flat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert len(flat) == len(jax.tree.leaves(cache))
    for path, want in flat:
        got = cache
        for key in path:
            got = got[key.key]
        assert got.dtype == (torch.float32 if path[-1].key == "h" else cfg.torch_dtype)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3, atol=5e-3,
                                   err_msg=f"{arch} {path}")


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_generate_matches_reference(arch):
    """The same greedy tokens from the same weights and prompts; a second
    call starts its SSM states from zeros again."""
    jcfg, cfg, jparams, params, tokens = _setup(arch, seed=2)
    prompts = tokens[:, :5]
    n_gen = 11
    want = JServer(jcfg, jparams, max_len=5 + n_gen, batch=B).generate(prompts, n_gen)
    server = BatchedServer(cfg, params, max_len=5 + n_gen, batch=B, device="cpu")
    np.testing.assert_array_equal(server.generate(prompts, n_gen), want)
    np.testing.assert_array_equal(server.generate(prompts, n_gen), want)


@pytest.mark.parametrize("s,chunk,window", [(40, 16, 0), (40, 16, 12), (33, 64, 0)])
def test_chunked_attention_matches_dense(s, chunk, window):
    """Query chunks (a ragged last one, a window across chunk edges, one
    chunk longer than S) against the full softmax, and against the
    reference's chunked attention."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    rng = np.random.default_rng(s + chunk + window)
    q = rng.normal(size=(2, s, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, s, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, s, 2, 16)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = TL.attention_core(tq, tk, tv, causal=True, window=window,
                            impl="chunked", chunk=chunk).numpy()
    dense = TL.attention_core(tq, tk, tv, causal=True, window=window,
                              impl="dense").numpy()
    np.testing.assert_allclose(got, dense, rtol=2e-4, atol=2e-4)
    want = JL.attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, window=window, impl="chunked", chunk=chunk)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)


def _moe_setup(capacity_factor=1.25, t=(2, 40)):
    from repro.models import moe as JMoE
    jcfg = jconfigs.get_smoke("qwen3-moe-235b-a22b").with_(capacity_factor=capacity_factor)
    cfg = configs.get_smoke("qwen3-moe-235b-a22b").with_(capacity_factor=capacity_factor)
    jp = j_init_params(JMoE.moe_specs(jcfg), jax.random.PRNGKey(5), jcfg.jdtype)
    x = np.random.default_rng(6).normal(size=t + (cfg.d_model,)).astype(np.float32)
    return JMoE, jcfg, cfg, jp, params_from_numpy(_np_tree(jp), "cpu"), x


def test_router_stats_match_reference():
    from repro_torch.models import moe
    JMoE, jcfg, cfg, jp, p, x = _moe_setup()
    want = JMoE.router_stats(jp, jnp.asarray(x), jcfg)
    got = moe.router_stats(p, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(got["expert_load"].numpy(),
                                  np.asarray(want["expert_load"]))
    assert float(got["expert_load"].sum()) == x.shape[0] * x.shape[1] * cfg.top_k
    np.testing.assert_allclose(float(got["router_entropy"]),
                               float(want["router_entropy"]), rtol=1e-5)


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_moe_dispatch_matches_reference(capacity_factor):
    """The kept set and the capacity as the reference's moe_apply computes
    them (moe.py:67-82: top-k of the float32 router probabilities, ranks by
    a cumsum inside each (group, expert)), and moe_apply's output and aux
    loss, with half or more of the assignments dropped at 0.5."""
    from repro_torch.models import moe
    JMoE, jcfg, cfg, jp, p, x = _moe_setup(capacity_factor)
    t, e, k = x.shape[0] * x.shape[1], cfg.n_experts, cfg.top_k
    ng = JMoE._dispatch_groups(jcfg, t)
    assert moe._dispatch_groups(cfg, t) == ng
    # the reference's ranking, step by step
    jx = jnp.asarray(x).reshape(t, -1)
    probs = jax.nn.softmax(jnp.einsum("td,de->te", jx, jp["router"]).astype(jnp.float32))
    _, top_e = jax.lax.top_k(probs, k)
    ge = top_e.reshape(ng, -1)
    oh = jax.nn.one_hot(ge, e, dtype=jnp.int32)
    jpos = jnp.take_along_axis(jnp.cumsum(oh, axis=1) - oh, ge[..., None], axis=2)[..., 0]
    jcap = int(np.ceil(t // ng * k / e * capacity_factor))

    _, _, te = moe.route(p, torch.from_numpy(x).reshape(t, -1), cfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(top_e))
    pos, keep, cap = moe.dispatch(te, cfg, ng)
    assert cap == jcap
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jpos < jcap))
    if capacity_factor < 1:
        assert not keep.all()

    out, aux = moe.moe_apply(p, torch.from_numpy(x), cfg)
    jout, jaux = JMoE.moe_apply(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-5)


def _recurrence(x, dt, A, Bm, Cm):
    """Token-by-token SSM: h ← exp(dt·A)·h + dt·B⊗x, y = C·h (float64)."""
    b, s, h, p = x.shape
    st = np.zeros((b, h, Bm.shape[-1], p))
    ys = []
    for i in range(s):
        a = np.exp(dt[:, i] * A)
        st = st * a[:, :, None, None] + (dt[:, i][:, :, None, None]
                                         * Bm[:, i][:, None, :, None]
                                         * x[:, i][:, :, None, :])
        ys.append(np.einsum("bn,bhnp->bhp", Cm[:, i], st))
    return np.stack(ys, axis=1)


@pytest.mark.parametrize("chunk,bf16", [(8, False), (16, False), (8, True)])
def test_ssd_chunked_matches_recurrence(chunk, bf16):
    """The chunked dual form against the token-by-token recurrence (float64)
    and against the reference's ssd_chunked; the bf16 dual form at bf16's
    tolerance (tests/test_kernels.py:197)."""
    from repro.models import mamba2 as JM2
    from repro_torch.models import mamba2 as m2
    rng = np.random.default_rng(chunk)
    b, s, h, p, n = 2, 32, 3, 4, 5
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, size=(b, s, h)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, size=h).astype(np.float32)
    Bm = rng.normal(size=(b, s, n)).astype(np.float32)
    Cm = rng.normal(size=(b, s, n)).astype(np.float32)
    cd = torch.bfloat16 if bf16 else torch.float32
    got = m2.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), chunk,
                         compute_dtype=cd)
    assert got.dtype == torch.float32
    tol = 5e-2 if bf16 else 1e-4
    np.testing.assert_allclose(got.numpy(), _recurrence(x, dt, A, Bm, Cm),
                               rtol=tol, atol=tol)
    want = JM2.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk,
                           compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="multiple"):
        m2.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)), 7)

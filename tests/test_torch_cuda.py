"""The port's CUDA kernels, its engine and its LM forward on the card,
against the plain PyTorch versions (this file imports no JAX, so it runs
where only the port is installed):

    python -m pytest -m cuda tests/test_torch_cuda.py

Every case skips without a CUDA device.  Tolerance: rtol/atol 1e-4 for the
scan kernels — they and the plain versions sum float32 values in different
orders (the kernels with shared-memory atomics, in an order that varies by
run); for attention the reference's own, 2e-3 in float32 and 5e-2 in bf16
against the plain version in float32 (tests/test_kernels.py:185,197).
"""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.api import ExecutionConfig, connect
from repro_torch.data import datasets as TD
from repro_torch.kernels import ops, ref
from repro_torch.ml.covar import compute_covar
from repro_torch.ml.covar_fused import make_fused_covar
from repro_torch.ml.trees import DecisionTree
from repro_torch.models import model as M
from repro_torch.models.layers import init_params

pytestmark = pytest.mark.cuda
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _case(n, seed=0):
    """Two seg reductions and two hists sharing one [1, y, y²] triple, with
    codes up to 3 outside each domain."""
    rng = np.random.default_rng(seed + n)
    doms = [13, 7, 6, 9]
    codes = np.stack([rng.integers(-3, d + 3, n) for d in doms], 1).astype(np.int32)
    y = rng.normal(size=n).astype(np.float32)
    fpay = np.concatenate([rng.normal(size=(n, 8)).astype(np.float32),
                           (rng.random((n, 4)) < 0.5).astype(np.float32),
                           np.stack([np.ones(n, np.float32), y, y * y], 1)], 1)
    specs = (ops.ReduceSpec("seg", 0, 13, 5, 0), ops.ReduceSpec("seg", 1, 7, 3, 5),
             ops.ReduceSpec("hist", 2, 6, 6, 8, n_cond=2, yk_off=12),
             ops.ReduceSpec("hist", 3, 9, 6, 10, n_cond=2, yk_off=12))
    return codes, fpay, specs


@pytest.mark.parametrize("n", [1, 100, 513, 517, 70001])
def test_kernels_match_plain(cuda_device, n):
    codes, fpay, specs = _case(n)
    c = torch.from_numpy(codes).to(cuda_device)
    f = torch.from_numpy(fpay).to(cuda_device)
    for g, w in zip(ops.fused_scan_block(c, f, specs),
                    ref.fused_scan_block_ref(c, f, specs)):
        torch.testing.assert_close(g, w, **TOL)
    seg, pay = c[:, 0].contiguous(), f[:, :5].contiguous()
    torch.testing.assert_close(ops.seg_aggregate(seg, pay, 13),
                               ref.seg_aggregate_ref(seg, pay, 13), **TOL)
    code, y, cond = c[:, 2].contiguous(), f[:, 13].contiguous(), f[:, 8].contiguous()
    torch.testing.assert_close(ops.tree_hist(code, y, cond, 6),
                               ref.tree_hist_ref(code, y, cond, 6), **TOL)


@pytest.mark.parametrize("n", [1, 517, 70001, 1_000_003])
def test_tree_hist_batched_matches_plain(cuda_device, n):
    """The unfused tree path's kernel at the fact step's sku histogram
    (D = 480, N = 16), with codes up to 20 outside the domain."""
    rng = np.random.default_rng(n)
    d, n_nodes = 480, 16
    codes = torch.from_numpy(rng.integers(-20, d + 20, n).astype(np.int32))
    y = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    cond = torch.from_numpy((rng.random((n, n_nodes)) < 0.5).astype(np.float32))
    codes, y, cond = (t.to(cuda_device) for t in (codes, y, cond))
    got = ops.tree_hist_batched(codes, y, cond, d)
    want = ref.tree_hist_batched_ref(codes, y, cond, d)
    assert tuple(got.shape) == (n_nodes, d, 3)
    scale = ref.tree_hist_batched_ref(codes, y.abs(), cond, d)
    assert bool(((got - want).abs() <= 1e-4 * scale + 1e-6).all())
    ok = (codes >= 0) & (codes < d)
    torch.testing.assert_close(got[:, :, 0].sum(1), cond[ok].sum(0))


@pytest.mark.parametrize("f", [1, 7, 64, 70, 142])
@pytest.mark.parametrize("n", [0, 1, 517, 70001, 1_000_003])
def test_covar_xtx_matches_plain(cuda_device, n, f):
    """Row counts that are no multiple of a chunk or a staged row step,
    widths on and off the 32-wide tiles, and a 0/1 w with zeros (the
    validity of padded rows in the reference): within 1e-4 of the plain
    version's Σ|terms| per entry, exactly symmetric."""
    rng = np.random.default_rng(n + f)
    x = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(cuda_device)
    w = torch.from_numpy((rng.random(n) < 0.8).astype(np.float32)).to(cuda_device)
    ops.reset_launches()
    got = ops.covar_xtx(x, w)
    assert ops.LAUNCHES["covar_xtx"] == 1
    want = ref.covar_xtx_ref(x, w)
    scale = ref.covar_xtx_ref(x.abs(), w)
    assert tuple(got.shape) == (f, f)
    assert bool(((got - want).abs() <= 1e-4 * scale + 1e-6).all())
    assert torch.equal(got, got.t())
    if n == 0:
        assert not bool(got.any())


def test_covar_xtx_is_bit_reproducible(cuda_device):
    """No atomics: chunks combine in a fixed order, so two launches give the
    same bits; a 0/1 column's count is exact past 2^24."""
    rng = np.random.default_rng(5)
    n = 20_000_003
    x = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(cuda_device)
    x[:, 0] = 1.0
    a, b = ops.covar_xtx(x), ops.covar_xtx(x)
    assert torch.equal(a, b)
    assert float(a[0, 0]) == float(np.float32(n))


def test_covar_xtx_takes_half_inputs(cuda_device):
    """float16 x is cast to float32 as the reference's wrapper does."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(70001, 70)).astype(np.float16)).to(cuda_device)
    got = ops.covar_xtx(x)
    ones = torch.ones(x.shape[0], device=cuda_device)
    want = ref.covar_xtx_ref(x, ones)
    assert bool(((got - want).abs()
                 <= 1e-4 * ref.covar_xtx_ref(x.abs(), ones) + 1e-6).all())


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    codes, fpay, specs = _case(64)
    c = torch.from_numpy(codes).to(cuda_device)
    f = torch.from_numpy(fpay).to(cuda_device)
    with pytest.raises(ValueError, match="int32"):
        ops.fused_scan_block(c.long(), f, specs)
    with pytest.raises(ValueError, match="contiguous"):
        ops.seg_aggregate(c[:, 0], f[:, :5].contiguous(), 13)
    with pytest.raises(ValueError, match="contiguous"):
        ops.tree_hist_batched(c[:, 2].contiguous(), f[:, 13].contiguous(),
                              f[:, 8:12].t().contiguous().t(), 6)
    with pytest.raises(ValueError, match="contiguous"):
        ops.covar_xtx(f[:, :5])
    with pytest.raises(ValueError, match="same rows"):
        ops.covar_xtx(f, f[:10, 0].contiguous())


@pytest.mark.parametrize("n_segments", [60000, 120000])
def test_wide_reductions_split_into_segment_ranges(cuda_device, n_segments):
    """More segments than one shared-memory column holds (58,112): the
    kernels cut the reduction into segment ranges, as a single-root batch
    needs (Retailer's sku × category × subcategory view: 120,000)."""
    rng = np.random.default_rng(n_segments)
    n = 300_007
    seg = torch.from_numpy(rng.integers(-5, n_segments + 5, n).astype(np.int32)).to(cuda_device)
    pay = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(cuda_device)
    torch.testing.assert_close(ops.seg_aggregate(seg, pay, n_segments),
                               ref.seg_aggregate_ref(seg, pay, n_segments), **TOL)
    spec = (ops.ReduceSpec("seg", 0, n_segments, 3, 0),)
    out, = ops.fused_scan_block(seg[:, None].contiguous(), pay, spec)
    torch.testing.assert_close(out, ref.seg_aggregate_ref(seg, pay, n_segments), **TOL)


def test_integer_sums_are_exact_past_2_24(cuda_device):
    """Counts like the covar's root COUNT (4,960 rows of up to 2·10^5 each,
    summing past 2^24) come out as the exact sum rounded once to float32,
    in every run: chunk partials stay below 2^24 and chunks combine in
    double."""
    rng = np.random.default_rng(7)
    vals = rng.integers(1, 200_000, 4960)
    pay = torch.tensor(vals, dtype=torch.float32, device=cuda_device)[:, None]
    seg = torch.zeros(4960, dtype=torch.int32, device=cuda_device)
    want = float(np.float32(vals.sum()))
    assert vals.sum() > 2 ** 24
    for _ in range(3):
        assert float(ops.seg_aggregate(seg, pay, 1)[0, 0]) == want
        out, = ops.fused_scan_block(seg[:, None].contiguous(), pay,
                                    (ops.ReduceSpec("seg", 0, 1, 1, 0),))
        assert float(out[0, 0]) == want


@pytest.mark.parametrize("fuse_kernels", [True, False])
def test_covar_on_card_matches_cpu(cuda_device, fuse_kernels):
    ds = TD.make("retailer", scale=0.5)
    cfg = ExecutionConfig(block_size=4096, fuse_kernels=fuse_kernels)
    ops.reset_launches()
    C, N, _, _ = compute_covar(ds, database=connect(ds, config=cfg,
                                                    device=cuda_device))
    launched = dict(ops.LAUNCHES)
    Cc, Nc, _, _ = compute_covar(ds, config=cfg, device="cpu")
    assert N == Nc
    np.testing.assert_allclose(C, Cc, rtol=1e-4, atol=1e-4 * np.abs(Cc).max())
    if fuse_kernels:
        assert launched["fused_scan_block"] > 0
    else:
        assert launched["seg_aggregate"] > 0 and launched["tree_hist"] > 0


@pytest.mark.parametrize("fuse_kernels", [True, False])
def test_tree_fit_on_card_matches_cpu(cuda_device, fuse_kernels):
    """A frontier-batched regression tree over Retailer (30,000 fact rows):
    the levels' statistics on the card agree with the CPU's, and the card
    run went through the tree kernels."""
    ds = TD.make("retailer", scale=0.5)
    cfg = ExecutionConfig(block_size=4096, fuse_kernels=fuse_kernels)
    kw = dict(max_depth=3, min_instances=500, max_nodes=15)
    ops.reset_launches()
    card = DecisionTree(ds, database=connect(ds, config=cfg,
                                             device=cuda_device), **kw).fit()
    launched = dict(ops.LAUNCHES)
    host = DecisionTree(ds, database=connect(ds, config=cfg, device="cpu"),
                        **kw).fit()
    assert [(n.feature, n.threshold) for n in card.nodes] == \
        [(n.feature, n.threshold) for n in host.nodes]
    np.testing.assert_allclose([n.n for n in card.nodes],
                               [n.n for n in host.nodes], rtol=1e-5)
    np.testing.assert_allclose([n.prediction for n in card.nodes],
                               [n.prediction for n in host.nodes], rtol=1e-4)
    if fuse_kernels:
        assert launched["fused_scan_block"] > 0
        assert launched["tree_hist_batched"] == 0
    else:
        assert launched["tree_hist_batched"] > 0
        assert launched["fused_scan_block"] == 0


def test_fused_covar_on_card_matches_cpu(cuda_device):
    """The gathered-XᵀX covar over Retailer (30,000 fact rows, blocks of
    4,096 rows and a short last one) on the card against a CPU session of
    the same tables: every block went through the kernel."""
    ds = TD.make("retailer", scale=0.5)
    ops.reset_launches()
    fn, layout = make_fused_covar(ds, block_size=4096,
                                  database=connect(ds, device=cuda_device))
    card = fn()
    assert card.device.type == "cuda"
    assert ops.LAUNCHES["covar_xtx"] == 8
    host, _ = make_fused_covar(ds, block_size=4096, device="cpu")
    want = host().numpy()
    np.testing.assert_allclose(card.cpu().numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    assert float(card[0, 0]) == 30000.0


ATTN_TOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2}


def _qkv(b, h, hkv, s, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, n, s, d)).astype(np.float32))
            .to(device=device, dtype=dtype) for n in (h, hkv, hkv)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h,hkv,s", [(16, 4, 4, 1000), (64, 8, 4, 333),
                                       (120, 8, 2, 777), (128, 16, 8, 1000)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100), (False, 0),
                                           (False, 64)])
def test_flash_attention_matches_plain(cuda_device, dtype, d, h, hkv, s,
                                       causal, window):
    """GQA groups 1, 2 and 4, the model families' head dims (120:
    h2o-danube), sequences that end inside a 64-row tile, every mask."""
    q, k, v = _qkv(2, h, hkv, s, d, dtype, cuda_device, seed=d + s)
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.LAUNCHES["flash_attention"] == 1
    assert got.dtype == dtype and tuple(got.shape) == tuple(q.shape)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal,
                             window=window)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


def test_flash_attention_takes_transposed_views(cuda_device):
    """The model's (B, S, H, D) activations as (B, H, S, D) views: no copy,
    the output laid out like q."""
    rng = np.random.default_rng(11)
    b, s, h, hkv, d = 2, 300, 8, 2, 128
    qs, ks, vs = (torch.from_numpy(rng.normal(size=(b, s, n, d)).astype(np.float32))
                  .to(cuda_device, torch.bfloat16) for n in (h, hkv, hkv))
    q, k, v = (t.transpose(1, 2) for t in (qs, ks, vs))
    assert not q.is_contiguous()
    got = ops.flash_attention(q, k, v, causal=True)
    assert got.transpose(1, 2).is_contiguous()
    want = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_flash_attention_rows_without_keys_are_zero(cuda_device):
    """More query rows than keys under a window of 1: rows past S_k see no
    key and give 0, the others their one key's value."""
    q = torch.ones(1, 1, 130, 8, device=cuda_device)
    k = v = torch.ones(1, 1, 70, 8, device=cuda_device)
    got = ops.flash_attention(q, k, v, causal=True, window=1)
    torch.testing.assert_close(got, ref.attention_ref(q, k, v, causal=True,
                                                      window=1))
    assert not bool(got[0, 0, 70:].any())


def _check_bf16(q, k, v, causal, window):
    """The bf16 kernel against the plain version in float32: allclose at
    5e-2, and per query row max |Δ| ≤ 5e-2 of the row's rms (allclose's
    atol is near a long row's |o|, so it alone cannot see a dropped key
    tile; a row without keys must come back exactly 0)."""
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.LAUNCHES["flash_attention"] == 1
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(q.shape)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal,
                             window=window)
    tol = ATTN_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    err = (got.float() - want).abs().amax(-1, keepdim=True)
    assert bool((err <= tol * rms).all()), float((err / rms.clamp_min(1e-30)).max())


@pytest.mark.parametrize("s", [64, 127, 128, 129, 255, 4096])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_tile_edges(cuda_device, s, causal):
    """Query and key tiles of 128 that end on and inside a tile's edge."""
    q, k, v = _qkv(2, 4, 2, s, 128, torch.bfloat16, cuda_device, seed=s)
    _check_bf16(q, k, v, causal, 0)


@pytest.mark.parametrize("sq,sk", [(100, 300), (300, 100), (129, 1000),
                                   (1000, 129), (256, 255)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 100)])
def test_flash_attention_bf16_sq_ne_sk(cuda_device, sq, sk, causal, window):
    """More keys than queries and fewer, with every mask: causal rows past
    S_k see every key, query tiles past S_k under a window see none."""
    rng = np.random.default_rng(sq + sk)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, n, s, 64)).astype(np.float32))
               .to(cuda_device, torch.bfloat16)
               for n, s in ((8, sq), (4, sk), (4, sk)))
    _check_bf16(q, k, v, causal, window)


@pytest.mark.parametrize("window", [100, 129, 4097])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_windows(cuda_device, window, causal):
    """Windows whose edge falls inside a key tile, on a tile's edge + 1,
    and one key past a 4,096-key span."""
    q, k, v = _qkv(1, 4, 2, 5000, 128, torch.bfloat16, cuda_device, seed=window)
    _check_bf16(q, k, v, causal, window)


@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_flash_attention_bf16_gqa_groups(cuda_device, group):
    q, k, v = _qkv(2, 8, 8 // group, 700, 128, torch.bfloat16, cuda_device,
                   seed=group)
    _check_bf16(q, k, v, True, 0)


@pytest.mark.parametrize("d", [8, 16, 64, 120, 128])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 200)])
def test_flash_attention_bf16_head_dims(cuda_device, d, causal, window):
    """Head dims the TMA boxes cover only in part (8 ... 120) or whole."""
    q, k, v = _qkv(2, 4, 2, 600, d, torch.bfloat16, cuda_device, seed=d)
    _check_bf16(q, k, v, causal, window)


def test_flash_attention_bf16_rows_without_keys_are_zero(cuda_device):
    """The bf16 kernel under a window of 1 with more query rows than keys:
    a query tile wholly past S_k loads no key tile."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(1, 2, 300, 64)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(1, 2, 70, 64)).astype(np.float32))
            for _ in range(2))
    q, k, v = (t.to(cuda_device, torch.bfloat16) for t in (q, k, v))
    got = ops.flash_attention(q, k, v, causal=True, window=1)
    assert not bool(got[0, :, 70:].any())
    torch.testing.assert_close(got[0, :, :70], v[0], rtol=0, atol=0)
    _check_bf16(q, k, v, True, 1)
    none = ops.flash_attention(q, k[:, :, :0], v[:, :, :0], causal=False)
    assert tuple(none.shape) == tuple(q.shape) and not bool(none.any())


def test_flash_attention_raises_on_what_the_kernel_does_not_take(cuda_device):
    q, k, v = _qkv(1, 4, 2, 64, 64, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.flash_attention(*_qkv(1, 4, 2, 64, 12, torch.float32, cuda_device))
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.flash_attention(*_qkv(1, 4, 2, 64, 136, torch.float32, cuda_device))
    with pytest.raises(ValueError, match="bfloat16"):
        ops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="key/value heads"):
        ops.flash_attention(*_qkv(1, 4, 3, 64, 64, torch.float32, cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)


def test_forward_on_card_matches_cpu(cuda_device):
    """internlm2-1.8b's smoke config: the forward on the card (the kernel,
    once per layer) against the forward on the CPU (the plain version)."""
    cfg = configs.get_smoke("internlm2-1.8b")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    host = init_params(M.model_specs(cfg), gen, cfg.torch_dtype, "cpu")

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        return tree.to(cuda_device)

    card = to_card(host)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 40)).astype(np.int64))
    want, _ = M.forward(host, {"tokens": tokens}, cfg, impl="dense")
    ops.reset_launches()
    got, _ = M.forward(card, {"tokens": tokens.to(cuda_device)}, cfg)
    assert ops.LAUNCHES["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=2e-3)

"""The arithmetic of ``flash_attention``'s float32 kernel (3xTF32 on the
tensor cores, ``csrc/flash_attention.cu``), emulated in plain torch on the
CPU: operands split into TF32 high and low parts by the kernel's own
rounding, three products a term (hi·lo + lo·hi, then hi·hi), each key
tile's P·V promoted into float32 output sums, the online softmax over the
key tiles the kernel visits.  The emulation is held against float64
attention at 1e-5 (float32-class) and against the reference's
``flash_attention_pallas`` in interpret mode at the reference's own 2e-3
(tests/test_kernels.py:185); one TF32 product a term (1xTF32) misses 1e-5
at the same shapes.  The emulation lives here, not on the main path: the
card runs the kernel itself (tests/test_torch_cuda.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import ref

#: float32-class: the kernel's own bound against float64 on the card
F32_CLASS = 1e-5
#: the reference's flash kernel against its plain version
REF_TOL = 2e-3
#: the kernel's query rows a block, and its key tile by D_q
BQ = 64


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as the kernel rounds it: 10 explicit mantissa
    bits, to nearest, ties away from zero, on the bits (+0x1000, then the
    low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, n_products: int = 3) -> torch.Tensor:
    """a (m, k) times b (n, k) transposed in float32 from TF32 parts: the
    small products summed before hi·hi is added (the kernel's Q Kᵀ order);
    with one product, hi·hi alone (1xTF32)."""
    ah, al = split(a)
    bh, bl = split(b)
    if n_products == 1:
        return ah @ bh.T
    return (ah @ bl.T + al @ bh.T) + ah @ bh.T


def key_tile(d_q: int) -> int:
    return 64 if d_q <= 128 else 32


def emulate(q, k, v, *, causal=True, window=0, n_products=3) -> torch.Tensor:
    """The kernel's arithmetic on float32 (B, H, S_q, D_q), (B, H_kv, S_k,
    D_q), (B, H_kv, S_k, D_v) tensors: 64-row query tiles, the key tiles
    of its band, scores and P·V in TF32 parts, a running max from −1e30,
    exp2 with the scale folded in, each tile's P·V added to the float32
    sums, a row without keys 0."""
    b, h, sq, dq = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    bk = key_tile(dq)
    scale_log2 = math.log2(math.e) / math.sqrt(dq)
    out = torch.zeros(b, h, sq, dv)
    for ib in range(b):
        for ih in range(h):
            qh, kh, vh = q[ib, ih], k[ib, ih // (h // hkv)], v[ib, ih // (h // hkv)]
            for q0 in range(0, sq, BQ):
                rows = torch.arange(q0, min(q0 + BQ, sq))
                k_begin = max(0, q0 - window + 1) if window > 0 else 0
                k_end = min(sk, q0 + BQ) if causal else sk
                m = torch.full((len(rows), 1), -1e30)
                l = torch.zeros(len(rows), 1)
                o = torch.zeros(len(rows), dv)
                for k0 in range(k_begin // bk * bk, k_end, bk):
                    cols = torch.arange(k0, min(k0 + bk, sk))
                    s = product(qh[rows], kh[cols], n_products)
                    ok = torch.ones(len(rows), len(cols), dtype=torch.bool)
                    if causal:
                        ok &= cols[None, :] <= rows[:, None]
                    if window > 0:
                        ok &= cols[None, :] > rows[:, None] - window
                    s = s.masked_fill(~ok, float("-inf"))
                    m_new = torch.maximum(m, s.amax(1, keepdim=True))
                    alpha = torch.exp2((m - m_new) * scale_log2)
                    p = torch.exp2(s * scale_log2 - m_new * scale_log2)
                    l = l * alpha + p.sum(1, keepdim=True)
                    o = o * alpha + product(p, vh[cols].T.contiguous(), n_products)
                    m = m_new
                out[ib, ih, rows] = o / l.clamp_min(1e-30)
    return out


def inputs(b, h, hkv, sq, sk, dq, dv, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, n, s, d)).astype(np.float32))
            for n, s, d in ((h, sq, dq), (hkv, sk, dq), (hkv, sk, dv))]


def float64_attention(q, k, v, causal, window):
    return ref.attention_ref(q.double(), k.double(), v.double(), causal=causal,
                             window=window)


def test_tf32_rounds_to_nearest_ties_away():
    """The kernel's rounding: 10 explicit mantissa bits, to nearest, a tie
    away from zero; hi + lo holds x to 2^-22 of |x|."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 1 + 3 * ulp / 4,
                      1 + ulp / 2 - 2.0 ** -23], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1, 1 + ulp, 1], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    r = torch.from_numpy(np.random.default_rng(0).normal(size=10_000).astype(np.float32))
    hi, lo = split(r)
    assert not bool((hi.view(torch.int32) & 0x1FFF).any())
    assert not bool((lo.view(torch.int32) & 0x1FFF).any())
    assert bool(((r - hi).abs() <= 2.0 ** -11 * r.abs()).all())
    err = (r.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * r.abs().double()).all())


SHAPES = [
    # (B, H, H_kv, S_q, S_k, D_q, D_v, causal, window)
    (1, 2, 1, 150, 150, 64, 64, True, 0),          # GQA 2:1, ragged tile
    (1, 2, 2, 130, 130, 128, 128, False, 0),
    (1, 4, 2, 200, 200, 128, 128, True, 70),        # window inside a tile
    (1, 2, 2, 100, 170, 192, 128, True, 0),         # MLA's widths, S_q < S_k
    (1, 2, 1, 170, 60, 192, 192, False, 0),         # <192, 192>, S_q > S_k
    (1, 2, 2, 130, 70, 64, 64, True, 1),            # rows past S_k see no key
]


@pytest.mark.parametrize("shape", SHAPES)
def test_three_products_are_float32_class(shape):
    """3xTF32 with float32 sums reads within 1e-5 of float64 attention."""
    b, h, hkv, sq, sk, dq, dv, causal, window = shape
    q, k, v = inputs(b, h, hkv, sq, sk, dq, dv, seed=sq + dq)
    got = emulate(q, k, v, causal=causal, window=window)
    want = float64_attention(q, k, v, causal, window)
    err = float((got.double() - want).abs().max())
    assert err <= F32_CLASS, err


@pytest.mark.parametrize("shape", SHAPES[:4])
def test_one_product_is_not(shape):
    """1xTF32 (hi·hi alone) at the same shapes misses 1e-5 by far: each
    product rounds at 2^-11."""
    b, h, hkv, sq, sk, dq, dv, causal, window = shape
    q, k, v = inputs(b, h, hkv, sq, sk, dq, dv, seed=sq + dq)
    got = emulate(q, k, v, causal=causal, window=window, n_products=1)
    want = float64_attention(q, k, v, causal, window)
    assert float((got.double() - want).abs().max()) > 10 * F32_CLASS


@pytest.mark.parametrize("b,h,hkv,s,d,causal,window", [
    (1, 2, 1, 128, 64, True, 0), (1, 2, 2, 128, 128, False, 0),
    (2, 4, 2, 64, 32, True, 24)])
def test_emulation_matches_reference_kernel(b, h, hkv, s, d, causal, window):
    """Against the reference's Pallas kernel in interpret mode (D_q = D_v,
    S a multiple of its blocks) at the reference's own tolerance, and
    within float32-class of it."""
    q, k, v = inputs(b, h, hkv, s, s, d, d, seed=b * s + d)
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
        causal=causal, window=window, block_q=32, block_k=32, interpret=True))
    got = emulate(q, k, v, causal=causal, window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=REF_TOL, atol=REF_TOL)
    assert float(np.abs(got - want).max()) <= F32_CLASS

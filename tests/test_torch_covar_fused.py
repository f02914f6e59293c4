"""The port's gathered-XᵀX covar path against the reference on the CPU.

``ops.covar_xtx`` (its plain version on CPU tensors) is held against the
reference's jnp oracle and its Pallas kernel in interpret mode, and
``ml/covar_fused`` against the reference's ``compute_covar_fused`` (its jnp
and its Pallas route) on the same numpy tables.  Tolerance: rtol/atol 1e-4
for float32 (the reference's own between its backends,
tests/test_backends.py), 2e-3 for float16 inputs (tests/test_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.data import datasets as JD
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.ml import covar_fused as jfused
from repro_torch.data import datasets as TD
from repro_torch.kernels import covar_xtx as kxtx
from repro_torch.kernels import ops
from repro_torch.ml import covar as tcovar
from repro_torch.ml import covar_fused as tfused


@pytest.mark.parametrize("n,f,block", [(64, 4, 32), (1000, 13, 256),
                                       (513, 7, 128), (2048, 32, 512)])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-4), (np.float16, 2e-3)])
def test_covar_xtx_matches_reference(n, f, block, dtype, tol):
    rng = np.random.default_rng(n + f)
    x = rng.normal(size=(n, f)).astype(dtype)
    w = (rng.random(n) < 0.8).astype(np.float32)
    ops.reset_launches()
    got = ops.covar_xtx(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32 and tuple(got.shape) == (f, f)
    assert ops.LAUNCHES["covar_xtx"] == 0          # CPU: the plain version
    want = jref.covar_xtx_ref(jnp.asarray(x), jnp.asarray(w))
    pallas = jops.covar_xtx(jnp.asarray(x), jnp.asarray(w), block_rows=block,
                            interpret=True)
    for other in (want, pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(other),
                                   rtol=tol, atol=tol)


def test_covar_xtx_without_weights_is_xtx():
    x = np.random.default_rng(0).normal(size=(300, 9)).astype(np.float32)
    got = ops.covar_xtx(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, x.T.astype(np.float64) @ x, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("n", [0, 1, 31, 4960, 1_000_003, 84_000_000])
@pytest.mark.parametrize("f", [1, 70, 142])
def test_covar_xtx_chunks_cover_rows(n, f):
    """The kernel's row chunks for a wave of the F-wide kernel: whole staged
    steps, at most 2^16 rows (exact 0/1 counts in float32), none empty, and
    together exactly the n rows."""
    rows = kxtx.step_rows(f)
    per_sm = kxtx.SMEM_BYTES // kxtx.smem_bytes(f, kxtx.ring_stages(f, rows), rows)
    chunk_rows, n_chunks = kxtx.chunking(n, max(1, 132 * per_sm // len(kxtx.groups(f))))
    assert chunk_rows % kxtx.STEP_ROWS == 0
    assert 0 < chunk_rows <= kxtx.MAX_CHUNK_ROWS
    assert 1 <= n_chunks <= kxtx.MAX_CHUNKS
    assert (n_chunks - 1) * chunk_rows < max(n, 1) <= n_chunks * chunk_rows


@pytest.mark.parametrize("f,count", [(1, 1), (32, 1), (65, 3), (70, 3),
                                     (142, 6), (173, 8)])
def test_covar_xtx_pieces_cover_the_triangle(f, count):
    """Every upper-triangle entry (i <= j < F) in exactly one 64 x 48 piece,
    each piece starting on its band's diagonal."""
    pieces = kxtx.pieces(f)
    assert len(pieces) == count
    assert all(m0 % kxtx.PIECE_ROWS == 0 and n0 >= m0 for m0, n0 in pieces)
    for i in range(f):
        for j in range(i, f):
            hits = [(m0, n0) for m0, n0 in pieces
                    if m0 <= i < m0 + kxtx.PIECE_ROWS
                    and n0 <= j < n0 + kxtx.PIECE_COLS]
            assert len(hits) == 1, (i, j, hits)


@pytest.mark.parametrize("f", [1, 48, 70, 96, 97, 142, 144, 145, 173, 300,
                               kxtx.MAX_FEATURES])
def test_covar_xtx_geometry_fits_a_block(f):
    """A step's buffers and at least two ring stages fit a block's shared
    memory; 48-row steps up to F = 96, 32-row steps where two stages of
    them fit (to F = 192), else 16; one group up to F = 144."""
    rows = kxtx.step_rows(f)
    stages = kxtx.ring_stages(f, rows)
    assert rows == (kxtx.LONG_STEP_ROWS if f <= 96 else kxtx.STEP_ROWS if f <= 192
                    else kxtx.SHORT_STEP_ROWS)
    assert (len(kxtx.groups(f)) == 1) == (f <= 144)
    assert kxtx.MIN_STAGES <= stages <= kxtx.MAX_STAGES
    assert kxtx.smem_bytes(f, stages, rows) <= kxtx.SMEM_BYTES


@pytest.mark.parametrize("f", [1, 70, 142, 144, 145, 173, 300, 500,
                               kxtx.MAX_FEATURES])
def test_covar_xtx_groups_cover_every_piece_once(f):
    """The grid's groups: every piece in exactly one, at most MAX_PIECES
    each, inside its group's operand rows (A whole bands; B from a core
    matrix's start, a multiple of 8), and no more columns to split than the
    kernel's task registers hold: 96 in 48-row steps, 192 in 32-row steps,
    else MAX_OPERAND_ROWS."""
    pieces = kxtx.pieces(f)
    seen = []
    for g in kxtx.groups(f):
        assert 1 <= g.count <= kxtx.MAX_PIECES
        assert g.a_lo % kxtx.PIECE_ROWS == 0 and g.a_n % kxtx.PIECE_ROWS == 0
        assert g.b_lo % 8 == 0
        seen += range(g.first, g.first + g.count)
        for m0, n0 in pieces[g.first:g.first + g.count]:
            assert g.a_lo <= m0 and m0 + kxtx.PIECE_ROWS <= g.a_lo + g.a_n
            assert g.b_lo <= n0 and n0 + kxtx.PIECE_COLS <= g.b_lo + g.b_n
        cols = set(range(g.a_lo, min(g.a_lo + g.a_n, f)))
        cols |= set(range(g.b_lo, min(g.b_lo + g.b_n, f)))
        assert len(cols) <= {kxtx.LONG_STEP_ROWS: 96, kxtx.STEP_ROWS: 192,
                             kxtx.SHORT_STEP_ROWS: kxtx.MAX_OPERAND_ROWS}[kxtx.step_rows(f)]
        assert g.a_n + g.b_n <= kxtx.operand_rows(f) <= kxtx.MAX_OPERAND_ROWS
    assert seen == list(range(len(pieces)))


def test_covar_xtx_takes_every_width_up_to_its_widest():
    """Every F from 1 to MAX_FEATURES has a step and at least two ring
    stages that fit; at MAX_FEATURES + 1 two 16-row stages would not fit
    beside split buffers of MAX_OPERAND_ROWS rows."""
    assert kxtx.MAX_FEATURES >= 173   # TPC-DS's covar features
    assert all(kxtx.ring_stages(f, kxtx.step_rows(f))
               for f in range(1, kxtx.MAX_FEATURES + 1))
    rows = kxtx.SHORT_STEP_ROWS
    split = 2 * 2 * kxtx.MAX_OPERAND_ROWS * rows * 4
    last = kxtx.MAX_FEATURES
    assert split + kxtx.MIN_STAGES * kxtx._stage_bytes(last, rows) <= kxtx.SMEM_BYTES
    assert split + kxtx.MIN_STAGES * kxtx._stage_bytes(last + 1, rows) > kxtx.SMEM_BYTES


@pytest.fixture(scope="module", params=["retailer", "favorita"])
def fused_case(request):
    """Both packages' datasets from the same generator and seed, and the
    reference's fused covar by its jnp route and its Pallas route."""
    name = request.param
    jds = JD.make(name, scale=0.02)
    want = {(bs, up): jfused.compute_covar_fused(jds, block_size=bs,
                                                 use_pallas=up)
            for bs in (100, 256) for up in (False, True)}
    return TD.make(name, scale=0.02), want


@pytest.mark.parametrize("block_size", [100, 256])
def test_compute_covar_fused_matches_reference(fused_case, block_size):
    """100 divides the 1,200 fact rows, 256 leaves a short last block."""
    ds, want = fused_case
    C, N, layout = tfused.compute_covar_fused(ds, block_size=block_size,
                                              device="cpu")
    assert C.dtype == np.float64 and C.shape == (layout.p, layout.p)
    for use_pallas in (False, True):
        Cr, Nr, layout_r = want[(block_size, use_pallas)]
        assert layout.p == layout_r.p and N == Nr
        np.testing.assert_allclose(C, Cr, rtol=1e-4, atol=1e-4)
    # and against the port's own engine path
    Ce, Ne, _, _ = tcovar.compute_covar(ds, device="cpu")
    assert N == Ne
    np.testing.assert_allclose(C, Ce, rtol=1e-4, atol=1e-4)


def test_make_fused_covar_reuses_a_session():
    ds = TD.make("retailer", scale=0.02)
    db = repro_torch.connect(ds, device="cpu")
    fn, layout = tfused.make_fused_covar(ds, block_size=512, database=db)
    a, b = fn(), fn()
    assert a.device.type == "cpu" and tuple(a.shape) == (layout.p, layout.p)
    assert torch.equal(a, b)
    assert float(a[0, 0]) == 1200.0


@pytest.mark.parametrize("name", ["retailer", "favorita", "yelp", "tpcds"])
def test_supports_fused_matches_reference(name):
    assert tfused.supports_fused(TD.make(name, scale=0.02)) == \
        jfused.supports_fused(JD.make(name, scale=0.02))


def test_many_to_many_schema_raises():
    with pytest.raises(ValueError, match="many-to-many"):
        tfused.make_fused_covar(TD.make("yelp", scale=0.02), device="cpu")


def test_fused_covar_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card path would run")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfused.make_fused_covar(TD.make("retailer", scale=0.02))

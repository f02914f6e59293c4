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
    """The kernel's row chunks: whole staged steps, at most 2^16 rows (exact
    0/1 counts in float32), none empty, and together exactly the n rows."""
    chunk_rows, n_chunks = kxtx.chunking(n, f, wave=132 * 14)
    assert chunk_rows % kxtx.STEP_ROWS == 0
    assert 0 < chunk_rows <= kxtx.MAX_CHUNK_ROWS
    assert 1 <= n_chunks <= kxtx.MAX_CHUNKS
    assert (n_chunks - 1) * chunk_rows < max(n, 1) <= n_chunks * chunk_rows


@pytest.mark.parametrize("f,pairs", [(1, 1), (32, 1), (33, 3), (70, 6),
                                     (142, 15)])
def test_covar_xtx_tile_pairs(f, pairs):
    assert kxtx.tile_pairs(f) == pairs


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

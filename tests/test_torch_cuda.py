"""The port's CUDA kernels and its engine on the card, against the plain
PyTorch versions (this file imports no JAX, so it runs where only the port
is installed):

    python -m pytest -m cuda tests/test_torch_cuda.py

Every case skips without a CUDA device.  Tolerance: rtol/atol 1e-4 — the
kernels and the plain versions sum float32 values in different orders (the
kernels with shared-memory atomics, in an order that varies by run).
"""

import numpy as np
import pytest
import torch

from repro_torch.api import ExecutionConfig, connect
from repro_torch.data import datasets as TD
from repro_torch.kernels import ops, ref
from repro_torch.ml.covar import compute_covar

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


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    codes, fpay, specs = _case(64)
    c = torch.from_numpy(codes).to(cuda_device)
    f = torch.from_numpy(fpay).to(cuda_device)
    with pytest.raises(ValueError, match="int32"):
        ops.fused_scan_block(c.long(), f, specs)
    with pytest.raises(ValueError, match="contiguous"):
        ops.seg_aggregate(c[:, 0], f[:, :5].contiguous(), 13)
    with pytest.raises(ValueError, match="does not fit"):
        ops.seg_aggregate(c[:, 0].contiguous(), f, 60000)


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

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
from repro_torch.core.aggregates import (COUNT, Delta, Pow, Var, agg, query,
                                         sum_of)
from repro_torch.core.schema import schema
from repro_torch.data import datasets as TD
from repro_torch.data.relations import (DeltaBatchUpdate, Relation,
                                        ResidentRelation, next_pow2)
from repro_torch.kernels import covar_xtx as kxtx
from repro_torch.kernels import ops, ref
from repro_torch.kernels import seg_aggregate as kseg
from repro_torch.ml.covar import assemble_covar, compute_covar
from repro_torch.ml.covar_fused import make_fused_covar
from repro_torch.ml.online import OnlineRidge
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


@pytest.mark.parametrize("f", [1, 7, 8, 63, 64, 65, 70, 99, 128, 142, 144,
                               145, 173, 300, kxtx.MAX_FEATURES])
@pytest.mark.parametrize("n", [0, 1, 517, 70001, 1_000_003])
def test_covar_xtx_matches_plain(cuda_device, n, f):
    """Row counts that are no multiple of a chunk or a staged row step,
    widths on and off the 64-row bands and 48-column pieces, in one group
    (F <= 144) and in groups of consecutive pieces past it (TPC-DS's 173 in
    two; 300 in five, one splitting two runs of columns) up to the widest
    the kernel takes,
    and a 0/1 w with zeros (the validity of padded
    rows in the reference): within 1e-4 of the plain version's Σ|terms| per
    entry, exactly symmetric."""
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


@pytest.mark.parametrize("n,f", [(20_000_003, 3), (3_000_017, 173)])
def test_covar_xtx_is_bit_reproducible(cuda_device, n, f):
    """No atomics: chunks combine in a fixed order, so two launches give the
    same bits; a 0/1 column's count is exact past 2^24.  At TPC-DS's 173
    features the grid's two groups of pieces write their own pieces: still
    the same bits, exactly symmetric, the count exact."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(cuda_device)
    x[:, 0] = 1.0
    a, b = ops.covar_xtx(x), ops.covar_xtx(x)
    assert torch.equal(a, b) and torch.equal(a, a.t())
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


def _sorted_codes(kind, S, n, rng):
    """Codes over ``S`` segments: uniform, zipf-skewed (a heavy head, many
    rows of one range), or uniform with about 4% out of range, 2% on each
    side."""
    if kind == "zipf":
        c = np.minimum(rng.zipf(1.2, n), S) - 1
    elif kind == "spill":
        spill = S // 50
        c = rng.integers(-spill, S + spill, n)
    else:
        c = rng.integers(0, S, n)
    return c.astype(np.int32)


@pytest.mark.parametrize("codes", ["uniform", "zipf", "spill"])
def test_sorted_path_matches_plain(cuda_device, codes):
    """Thousands of segment ranges take the sorted path (2,000 ranges at
    99 columns; 2^20 + 3 rows): each range reads only its
    rows from the pre-pass's list, on uniform codes, on zipf-skewed ones
    (one range holding most rows, cut into chunks) and with codes out of
    range; within 1e-4 of the plain version's Σ|terms|, and counted as a
    sorted-path reduction."""
    rng = np.random.default_rng(21)
    n, width = (1 << 20) + 3, 99
    S = kseg.range_segments(width) * 2000
    assert kseg.reduction_mode("seg", S, width) == 2
    seg = torch.from_numpy(_sorted_codes(codes, S, n, rng)).to(cuda_device)
    pay = torch.from_numpy(rng.normal(size=(n, width)).astype(np.float32)).to(cuda_device)
    ops.reset_launches()
    got = ops.seg_aggregate(seg, pay, S)
    assert ops.RANGE_REDUCTIONS == {"scan": 0, "sorted": 1}
    want = ref.seg_aggregate_ref(seg, pay, S)
    assert _scaled_err(got, want, ref.seg_aggregate_ref(seg, pay.abs(), S)) <= 1e-4


def test_sorted_path_integer_sums_are_exact(cuda_device):
    """Every row on one segment, 20,000,003 rows (more than MAX_CHUNK_ROWS
    many times): the sorted path cuts that range into chunks of listed rows,
    no partial past MAX_CHUNK_ROWS, so COUNT-like parts and a histogram's
    Σcond come out exact past 2^24, in every run."""
    n = 20_000_003
    code = torch.full((n,), 5, dtype=torch.int32, device=cuda_device)
    ones = torch.ones(1, 1, device=cuda_device).expand(n, 600)
    y = torch.zeros(n, device=cuda_device)
    S, B = kseg.range_segments(600) * 300, kseg.range_segments(192) * 300
    assert kseg.reduction_mode("seg", S, 600) == 2
    assert kseg.reduction_mode("hist", B, 192) == 2
    for _ in range(2):
        ops.reset_launches()
        seg, hist = ops.fused_scan_parts([
            ops.Parts("seg", code, (ops.Part(ones, 0),), S),
            ops.Parts("hist", code, (ones[:, :64], y), B)])
        assert ops.RANGE_REDUCTIONS["sorted"] == 2
        assert seg[5].cpu().numpy().tolist() == [float(np.float32(n))] * 600
        assert float(seg.abs().sum() - seg[5].sum()) == 0.0
        h = hist[5].view(64, 3)
        assert h[:, 0].cpu().numpy().tolist() == [float(np.float32(n))] * 64
        assert float(h[:, 1:].abs().sum()) == 0.0 and float(hist.sum() - hist[5].sum()) == 0.0


@pytest.mark.parametrize("n_nodes", [16, 64])
def test_sorted_path_histograms_match_plain(cuda_device, n_nodes):
    """HIST on the sorted path: ``tree_hist_batched`` over 300,000 buckets
    (322 ranges at 16 nodes, 1,294 at 64) on 0/1 masks, codes out of range
    on both sides, against the plain version."""
    rng = np.random.default_rng(22 + n_nodes)
    n, S = 1_000_003, 300_000
    assert kseg.reduction_mode("hist", S, 3 * n_nodes) == 2
    codes = torch.from_numpy(_sorted_codes("spill", S, n, rng)).to(cuda_device)
    y = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(cuda_device)
    cond = torch.from_numpy((rng.random((n, n_nodes)) < 0.5).astype(np.float32)).to(cuda_device)
    got = ops.tree_hist_batched(codes, y, cond, S)
    want = ref.tree_hist_batched_ref(codes, y, cond, S)
    assert _scaled_err(got, want, ref.tree_hist_batched_ref(codes, y.abs(), cond, S)) <= 1e-4


def test_sorted_path_reads_parts_where_they_lie(cuda_device):
    """The parts form on the sorted path: seg parts that are strided column
    slices, a (n,) column at an output stride, an expanded scalar (row
    stride 0) and an output column no part names, over 2,000,000 segments
    (313 ranges); a histogram over a transposed (N, n) node mask with y
    formed on the card over 300,000 buckets (322 ranges); beside them one
    with a packed yk read at a column stride, 61 ranges on the scan path;
    one launch, against the plain version."""
    rng = np.random.default_rng(23)
    n, S, B = 300_007, 2_000_000, 300_000
    big = torch.from_numpy(rng.normal(size=(n, 20)).astype(np.float32)).to(cuda_device)
    mask = torch.from_numpy((rng.random((16, n)) < 0.3).astype(np.float32)).to(cuda_device)
    code = torch.from_numpy(_sorted_codes("spill", S, n, rng)).to(cuda_device)
    hcode = torch.from_numpy(_sorted_codes("spill", B, n, rng)).to(cuda_device)

    def reds(f):
        return [ops.Parts("seg", code, (ops.Part(f(big[:, 2:7]), 0, 2),
                                        ops.Part(f(big[:, 10]), 1, 3),
                                        ops.Part(torch.full((1,), 2.5, device=cuda_device)
                                                 .expand(n), 13)), S, 15),
                ops.Parts("hist", hcode, (mask.t(), f(big[:, 11])), B),
                ops.Parts("hist", hcode, (mask.t()[:, :3], f(big[:, 12:18:2])), B)]
    assert [kseg.reduction_mode("seg", S, 7), kseg.reduction_mode("hist", B, 48),
            kseg.reduction_mode("hist", B, 9)] == [2, 2, 1]
    ops.reset_launches()
    got = ops.fused_scan_parts(reds(lambda t: t))
    assert ops.LAUNCHES["fused_scan_block"] == 1
    assert ops.RANGE_REDUCTIONS == {"scan": 1, "sorted": 2}
    assert _within(got, ref.fused_scan_parts_ref(reds(lambda t: t)),
                   ref.fused_scan_parts_ref(reds(torch.abs)))
    assert not bool(got[0][:, 3].any()) and not bool(got[0][:, 12].any())


@pytest.fixture
def sorted_min_ranges():
    """Sets ``SORTED_MIN_RANGES`` for the plans made inside, and restores it
    and the plan cache after."""
    keep = kseg.SORTED_MIN_RANGES

    def set_to(value):
        kseg.SORTED_MIN_RANGES = value
        kseg.launch_plan.cache_clear()
    yield set_to
    set_to(keep)


@pytest.mark.parametrize("side", [-1, 0])
def test_paths_agree_across_the_crossover(cuda_device, side, sorted_min_ranges):
    """A shape one range below the crossover (scan path) and one at it
    (sorted path), each run on both paths on the same inputs, skewed codes
    out of range included: the two paths agree with each other and with
    the plain version, and an integer-valued column exactly."""
    ranges = kseg.SORTED_MIN_RANGES + side
    n, width = 1_000_003, 99
    S = kseg.range_segments(width) * ranges
    assert kseg.range_count(S, width) == ranges
    assert kseg.reduction_mode("seg", S, width) == (1 if side < 0 else 2)
    rng = np.random.default_rng(24 + ranges)
    c = _sorted_codes("spill", S, n, rng)
    heavy = rng.random(n) < 0.25
    c[heavy] = rng.integers(0, 124, int(heavy.sum())) * (S // 124)
    seg = torch.from_numpy(c).to(cuda_device)
    pay = torch.from_numpy(rng.normal(size=(n, width)).astype(np.float32)).to(cuda_device)
    pay[:, 0] = 1.0
    want = ref.seg_aggregate_ref(seg, pay, S)
    scale = ref.seg_aggregate_ref(seg, pay.abs(), S)
    outs = {}
    for path, crossover in (("scan", 1 << 30), ("sorted", 1)):
        sorted_min_ranges(crossover)
        ops.reset_launches()
        outs[path] = ops.seg_aggregate(seg, pay, S)
        assert ops.RANGE_REDUCTIONS[path] == 1
        assert _scaled_err(outs[path], want, scale) <= 1e-4
    assert _scaled_err(outs["sorted"], outs["scan"], scale) <= 1e-4
    assert torch.equal(outs["sorted"][:, 0], outs["scan"][:, 0])
    assert torch.equal(outs["sorted"][:, 0], want[:, 0])


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


def _scaled_err(got, want, scale):
    """max |got − want| ÷ (Σ|terms| + 1e-30) over the entries."""
    return float(((got - want).abs() / (scale + 1e-30)).max())


@pytest.mark.parametrize("n_segments", [1, 13, 4960, 60000, 120000])
@pytest.mark.parametrize("width", [1, 3, 4, 7, 11, 99, 100, 1500])
def test_seg_aggregate_edges(cuda_device, width, n_segments):
    """Widths from one column to past one block's threads (1,500: two
    column tiles), segment counts from one to three segment ranges,
    50,003 rows (no multiple of 4 or of a ring stage), a payload that
    starts 4 bytes past a 16-byte boundary, and codes up to 5 outside the
    domain on both sides: within 1e-4 of the plain version's Σ|terms|."""
    rng = np.random.default_rng(width * 7 + n_segments)
    n = 50_003
    seg = torch.from_numpy(rng.integers(-5, n_segments + 5, n).astype(np.int32)).to(cuda_device)
    flat = torch.from_numpy(rng.normal(size=n * width + 1).astype(np.float32)).to(cuda_device)
    pay = flat[1:].view(n, width)
    assert pay.is_contiguous() and pay.data_ptr() % 16 != 0
    ops.reset_launches()
    got = ops.seg_aggregate(seg, pay, n_segments)
    assert ops.LAUNCHES["seg_aggregate"] == 1
    want = ref.seg_aggregate_ref(seg, pay, n_segments)
    scale = ref.seg_aggregate_ref(seg, pay.abs(), n_segments)
    assert tuple(got.shape) == (n_segments, width)
    assert _scaled_err(got, want, scale) <= 1e-4


def test_seg_aggregate_fact_bucket_plan(cuda_device):
    """The covar plan's widest fact bucket (4,960 segments, 99 columns)
    runs in segment ranges, one wave of blocks of which the card holds at
    least one, and agrees with the plain version."""
    plan = kseg.seg_plan(1_000_003, 4960, 99, cuda_device)
    (grid,) = plan.launch.grids
    assert plan.launch.layouts[0].mode == kseg.reduction_mode("seg", 4960, 99) >= 1
    assert grid.wave_blocks >= 1
    assert grid.n_chunks * grid.chunk_rows >= 1_000_003
    rng = np.random.default_rng(3)
    seg = torch.from_numpy(rng.integers(-200, 5160, 1_000_003).astype(np.int32)).to(cuda_device)
    pay = torch.from_numpy(rng.normal(size=(1_000_003, 99)).astype(np.float32)).to(cuda_device)
    got = ops.seg_aggregate(seg, pay, 4960)
    want = ref.seg_aggregate_ref(seg, pay, 4960)
    assert _scaled_err(got, want, ref.seg_aggregate_ref(seg, pay.abs(), 4960)) <= 1e-4


def test_covar_xtx_takes_unaligned_rows(cuda_device):
    """x and w that start 4 bytes past a 16-byte boundary (a slice of a
    larger buffer): the ring's 16-byte copies start after the unaligned
    head."""
    rng = np.random.default_rng(8)
    n, f = 70001, 70
    flat = torch.from_numpy(rng.normal(size=n * f + 1).astype(np.float32)).to(cuda_device)
    x = flat[1:].view(n, f)
    w = torch.from_numpy((rng.random(n + 1) < 0.8).astype(np.float32)).to(cuda_device)[1:]
    assert x.data_ptr() % 16 != 0 and w.data_ptr() % 16 != 0
    got = ops.covar_xtx(x, w)
    want = ref.covar_xtx_ref(x, w)
    assert _scaled_err(got, want, ref.covar_xtx_ref(x.abs(), w)) <= 1e-4
    assert torch.equal(got, got.t())


def test_covar_xtx_raises_past_its_widest_input(cuda_device):
    x = torch.ones(100, kxtx.MAX_FEATURES + 1, device=cuda_device)
    with pytest.raises(ValueError, match="columns"):
        ops.covar_xtx(x)


def _tf32(t):
    """Round float32 to TF32 (10 explicit mantissa bits), to nearest."""
    bits = t.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def test_covar_xtx_check_sees_planted_faults(cuda_device):
    """The check the kernel passes (1e-4 of Σ|terms| per entry) reads
    above its limit for two faults of the kernel's own kind: one 32-row
    stage dropped out of 70,001 rows, and products in 1xTF32 (no low
    parts) on gathered-like features, whose few positive values repeat in
    every row, so their rounding does not average out; on the latter the
    kernel itself stays within the limit."""
    rng = np.random.default_rng(9)
    n, f = 70001, 70
    x = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).to(cuda_device)
    w = torch.ones(n, device=cuda_device)
    want, scale = ref.covar_xtx_ref(x, w), ref.covar_xtx_ref(x.abs(), w)
    assert _scaled_err(ops.covar_xtx(x, w), want, scale) <= 1e-4
    dropped = w.clone()
    dropped[64:96] = 0.0
    assert _scaled_err(ref.covar_xtx_ref(x, dropped), want, scale) > 1e-4
    # eight values 0.45 of a TF32 unit above one: each rounds down, alike
    values = torch.from_numpy((1.0 + (rng.integers(0, 512, 8) + 0.45) * 2.0 ** -10)
                              .astype(np.float32)).to(cuda_device)
    g = values[torch.from_numpy(rng.integers(0, 8, (n, f))).to(cuda_device)]
    want, scale = ref.covar_xtx_ref(g, w), ref.covar_xtx_ref(g.abs(), w)
    assert _scaled_err(ops.covar_xtx(g, w), want, scale) <= 1e-4
    assert _scaled_err(ref.covar_xtx_ref(_tf32(g), w), want, scale) > 1e-4


#: the fused launches of chip_smoke.py's kernel cases, packed as the covar
#: plan packs them: (kind, segments, width, n_cond) a reduction
PLAN_STEPS = {
    "covar_fact": [("seg", 4960, 99, 0), ("seg", 40, 4, 0), ("seg", 480, 20, 0)],
    "covar_items": [("seg", 4800, 1, 0), ("seg", 3840, 1, 0), ("seg", 12000, 1, 0),
                    ("hist", 480, 3, 1)],
    "tree_fact": [("seg", 4960, 48, 0), ("hist", 40, 48, 16), ("hist", 480, 48, 16)],
}


def _packed(rows, n, rng, skew=False):
    """codes (n, C) up to 4% outside each domain on each side (with
    ``skew``, a quarter of the rows on 124 segments of the first), and a
    payload packed as the covar plan packs it: seg slices, then the hist
    views' 0/1 conds, then one random yk triple they share."""
    specs, codes, off = [], [], 0
    n_hist = sum(k == "hist" for k, *_ in rows)
    yk_off = sum(w for k, _, w, _ in rows if k == "seg") + sum(
        nc for k, _, _, nc in rows if k == "hist")
    for i, (kind, S, w, nc) in enumerate(rows):
        spill = max(1, S // 25)
        c = rng.integers(-spill, S + spill, n)
        if skew and i == 0:
            heavy = rng.random(n) < 0.25
            c[heavy] = rng.integers(0, 124, int(heavy.sum())) * (S // 124)
        codes.append(c)
        if kind == "seg":
            specs.append(ops.ReduceSpec("seg", i, S, w, off))
            off += w
        else:
            specs.append(ops.ReduceSpec("hist", i, S, w, off, n_cond=nc,
                                        yk_off=yk_off))
            off += nc
    fpay = rng.normal(size=(n, yk_off + 3 * (n_hist > 0))).astype(np.float32)
    for sp in specs:
        if sp.kind == "hist":
            fpay[:, sp.pay_off:sp.pay_off + sp.n_cond] = (
                fpay[:, sp.pay_off:sp.pay_off + sp.n_cond] > 0)
    return (torch.from_numpy(np.stack(codes, 1).astype(np.int32)),
            torch.from_numpy(fpay), tuple(specs))


def _within(got, want, scale, tol=1e-4):
    return all(_scaled_err(g, w, a) <= tol for g, w, a in zip(got, want, scale))


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("step", sorted(PLAN_STEPS))
def test_fused_plan_steps_match_plain(cuda_device, step, skew):
    """chip_smoke.py's three fused launches at 1,000,003 rows: the covar
    fact step mixes range (4,960 x 99) and one-block reductions, the tree
    fact step a range reduction and two 16-node histograms; codes out of
    range on both sides, and with Retailer-like skew (a quarter of the rows
    on 124 of the first reduction's segments).  One launch each."""
    rng = np.random.default_rng(11)
    codes, fpay, specs = _packed(PLAN_STEPS[step], 1_000_003, rng, skew)
    c, f = codes.to(cuda_device), fpay.to(cuda_device)
    ops.reset_launches()
    got = ops.fused_scan_block(c, f, specs)
    assert ops.LAUNCHES["fused_scan_block"] == 1
    want = ref.fused_scan_block_ref(c, f, specs)
    scale = ref.fused_scan_block_ref(c, f.abs(), specs)
    assert [tuple(g.shape) for g in got] == [(sp.n_segments, sp.width) for sp in specs]
    assert _within(got, want, scale)


def test_fused_parts_read_where_they_lie(cuda_device):
    """The parts form: seg parts that are strided column slices of a wider
    matrix, a (n,) column at an output stride, an expanded scalar (row
    stride 0), an output column no part names (0); a hist over a transposed
    (N, n) node mask with y formed on the card, and one with a packed random
    yk read at a column stride; all in one launch, against the plain
    version of the same parts."""
    rng = np.random.default_rng(12)
    n = 300_007
    big = torch.from_numpy(rng.normal(size=(n, 20)).astype(np.float32)).to(cuda_device)
    mask = torch.from_numpy((rng.random((16, n)) < 0.3).astype(np.float32)).to(cuda_device)
    code = torch.from_numpy(rng.integers(-3, 4963, n).astype(np.int32)).to(cuda_device)
    hcode = torch.from_numpy(rng.integers(-20, 500, n).astype(np.int32)).to(cuda_device)
    reds = [ops.Parts("seg", code, (ops.Part(big[:, 2:7], 0, 2),
                                    ops.Part(big[:, 10], 1, 3),
                                    ops.Part(torch.full((1,), 2.5, device=cuda_device).expand(n), 13)),
                      4960, 15),
            ops.Parts("hist", hcode, (mask.t(), big[:, 11]), 480),
            ops.Parts("hist", hcode, (mask.t()[:, :3], big[:, 12:18:2]), 480)]
    ops.reset_launches()
    got = ops.fused_scan_parts(reds)
    assert ops.LAUNCHES["fused_scan_block"] == 1
    want = ref.fused_scan_parts_ref(reds)
    absr = [ops.Parts("seg", code, tuple(ops.Part(p.values.abs(), p.ocol, p.ostride)
                                         for p in reds[0].parts), 4960, 15),
            ops.Parts("hist", hcode, (mask.t(), big[:, 11].abs()), 480),
            ops.Parts("hist", hcode, (mask.t()[:, :3], big[:, 12:18:2].abs()), 480)]
    assert _within(got, want, ref.fused_scan_parts_ref(absr))
    assert not bool(got[0][:, 3].any()) and not bool(got[0][:, 12].any())


#: the covar fact bucket's parts as the lowering passes them: 45 aggregate
#: columns of one view, then five one-aggregate views of pulled widths
FACT_PART_WIDTHS = (1,) * 45 + (5, 6, 10, 25, 8)


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("step", ["covar_fact", "tree_fact"])
def test_fused_parts_at_the_fact_steps(cuda_device, step, skew):
    """The fact steps as the lowering passes them, 1,000,003 rows: the
    covar fact bucket (4,960 x 99) as 45 one-column parts (one a strided
    column, one expanded: row stride 0) and five row-major pulled blocks,
    some across tile edges, beside 40 x 4 in four column parts and 480 x
    20; the tree fact bucket as 48 one-column parts beside two 16-node
    histograms over a transposed mask with y formed on the card.  The wide
    reduction runs in segment ranges, the rest in one block; codes out of
    range on both sides, and with Retailer-like skew."""
    rng = np.random.default_rng(15)
    n = 1_000_003
    dev = cuda_device

    def codes(S):
        spill = max(1, S // 25)
        c = rng.integers(-spill, S + spill, n)
        if skew:
            heavy = rng.random(n) < 0.25
            c[heavy] = rng.integers(0, 124, int(heavy.sum())) * (S // 124)
        return torch.from_numpy(c.astype(np.int32)).to(dev)

    def rand(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    if step == "covar_fact":
        wide = rand(n, 3)
        cols = [rand(n) if w == 1 else rand(n, w) for w in FACT_PART_WIDTHS]
        cols[7] = wide[:, 1]                                        # strided
        cols[20] = torch.full((1,), 1.5, device=dev).expand(n)      # row stride 0
        offs = np.cumsum((0,) + FACT_PART_WIDTHS)[:-1]
        small = rand(n, 4)
        reds = [ops.Parts("seg", codes(4960), tuple(ops.Part(c, int(o)) for c, o in
                                                     zip(cols, offs)), 4960, 99),
                ops.Parts("seg", codes(40), tuple(ops.Part(small[:, j], j)
                                                  for j in range(4)), 40),
                ops.Parts("seg", codes(480), (ops.Part(rand(n, 20), 0),), 480)]
    else:
        mask = torch.from_numpy((rng.random((16, n)) < 0.5).astype(np.float32)).to(dev)
        y = rand(n)
        reds = [ops.Parts("seg", codes(4960), tuple(ops.Part(rand(n), j) for j in range(48)),
                          4960, 48),
                ops.Parts("hist", codes(40), (mask.t(), y), 40),
                ops.Parts("hist", codes(480), (mask.t(), y), 480)]
    ops.reset_launches()
    got = ops.fused_scan_parts(reds)
    assert ops.LAUNCHES["fused_scan_block"] == 1
    want = ref.fused_scan_parts_ref(reds)

    def absolute(r):
        if r.kind == "hist":
            return ops.Parts("hist", r.codes, (r.parts[0], r.parts[1].abs()), r.n_segments)
        return ops.Parts("seg", r.codes, tuple(ops.Part(p.values.abs(), p.ocol, p.ostride)
                                               for p in r.parts), r.n_segments, r.width)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert _within(got, want, ref.fused_scan_parts_ref([absolute(r) for r in reds]))


@pytest.mark.parametrize("n_nodes", [16, 200])
def test_histograms_carry_non_finite_y_in_every_mode(cuda_device, n_nodes):
    """A y that is NaN on a few rows: the reference adds cond · y for every
    cond, 0 too, so each bucket holding such a row reads NaN in its y and y²
    statistics for every node.  One block (16 nodes) and segment ranges
    (200 nodes) give the same answer."""
    rng = np.random.default_rng(16)
    n, d = 300_007, 480
    codes = torch.from_numpy(rng.integers(-20, d + 20, n).astype(np.int32)).to(cuda_device)
    y = rng.normal(size=n).astype(np.float32)
    y[rng.integers(0, n, 5)] = np.nan
    y = torch.from_numpy(y).to(cuda_device)
    node = torch.from_numpy(rng.integers(-1, n_nodes, n)).to(cuda_device)
    cond = (node[:, None] == torch.arange(n_nodes, device=cuda_device)).float()
    got = ops.tree_hist_batched(codes, y, cond, d)
    want = ref.tree_hist_batched_ref(codes, y, cond, d)
    assert bool(torch.isnan(want).any())
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    scale = ref.tree_hist_batched_ref(codes, torch.nan_to_num(y).abs(), cond, d)
    assert _scaled_err(got[ok], want[ok], scale[ok]) <= 1e-4


@pytest.mark.parametrize("n_nodes", [1, 2, 16, 200])
def test_tree_hist_batched_node_counts(cuda_device, n_nodes):
    """One to 200 frontier nodes at 480 buckets: one block holds the (480,
    3N) accumulator up to 16 nodes and more; 200 nodes cut it into segment
    ranges of whole nodes.  Masks of a frontier (each row in at most one
    node) and random 0/1 masks; tree_hist is the one-node case."""
    rng = np.random.default_rng(n_nodes)
    n, d = 1_000_003, 480
    codes = torch.from_numpy(rng.integers(-20, d + 20, n).astype(np.int32)).to(cuda_device)
    y = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(cuda_device)
    node = torch.from_numpy(rng.integers(-1, n_nodes, n)).to(cuda_device)
    frontier = (node[:, None] == torch.arange(n_nodes, device=cuda_device)).float()
    rand = torch.from_numpy((rng.random((n, n_nodes)) < 0.5).astype(np.float32)).to(cuda_device)
    for cond in (frontier, rand):
        got = ops.tree_hist_batched(codes, y, cond, d)
        want = ref.tree_hist_batched_ref(codes, y, cond, d)
        assert _scaled_err(got, want, ref.tree_hist_batched_ref(codes, y.abs(), cond, d)) <= 1e-4
    if n_nodes == 1:
        got = ops.tree_hist(codes, y, rand[:, 0].contiguous(), d)
        want = ref.tree_hist_ref(codes, y, rand[:, 0].contiguous(), d)
        assert _scaled_err(got, want, ref.tree_hist_ref(codes, y.abs(), rand[:, 0].contiguous(), d)) <= 1e-4


def test_fused_integer_sums_are_exact_past_2_24(cuda_device):
    """COUNT-like parts through the parts form and a histogram's Σcond:
    exact past 2^24 in every run (chunk partials below 2^24, chunks
    combined in double), in one-block and range mode."""
    rng = np.random.default_rng(13)
    n = 20_000_003
    ones = torch.ones(1, device=cuda_device).expand(n)
    code = torch.from_numpy((rng.random(n) < 0.9).astype(np.int32)).to(cuda_device)
    y = torch.zeros(n, device=cuda_device)
    want = np.bincount(code.cpu().numpy(), minlength=2).astype(np.float32)
    assert want.max() > 2 ** 24
    wide = torch.ones(1, 1, device=cuda_device).expand(n, 600)   # 600 staged: ranges
    for _ in range(2):
        seg, hist, rng_mode = ops.fused_scan_parts([
            ops.Parts("seg", code, (ops.Part(ones, 0),), 2),
            ops.Parts("hist", code, (ones[:, None], y), 2),
            ops.Parts("seg", code, (ops.Part(wide, 0),), 2)])
        assert seg[:, 0].cpu().numpy().tolist() == want.tolist()
        assert hist[:, 0].cpu().numpy().tolist() == want.tolist()
        assert rng_mode[:, 599].cpu().numpy().tolist() == want.tolist()


def test_scan_check_sees_a_planted_fault(cuda_device):
    """The check the fused launch passes (1e-4 of Σ|terms| per entry) reads
    above its limit for a fault of the kernel's own kind: one 32-row ring
    stage dropped, or one row of a segment's run added twice."""
    rng = np.random.default_rng(14)
    codes, fpay, specs = _packed(PLAN_STEPS["covar_fact"], 70_001, rng)
    c, f = codes.to(cuda_device), fpay.to(cuda_device)
    want = ref.fused_scan_block_ref(c, f, specs)
    scale = ref.fused_scan_block_ref(c, f.abs(), specs)
    assert _within(ops.fused_scan_block(c, f, specs), want, scale)
    dropped = c.clone()
    dropped[4096:4128] = -1
    assert not _within(ref.fused_scan_block_ref(dropped, f, specs), want, scale)
    twice = torch.cat([c, c[:1]]), torch.cat([f, f[:1]])
    assert not _within(ref.fused_scan_block_ref(*twice, specs), want, scale)


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


@pytest.mark.parametrize("block_size", [4096, 1 << 16])
def test_torch_backend_on_card_matches_cpu(cuda_device, block_size):
    """backend="torch" on the card: index_add_ adds in an order that varies
    by run, so the covar holds the 1e-4 rule against the CPU run; no
    hand-written kernel launches.  Blocks of 4,096 rows reduce in one copy
    of the segments, of 2¹⁶ rows in sixteen."""
    ds = TD.make("retailer", scale=0.5)
    cfg = ExecutionConfig(backend="torch", block_size=block_size)
    ops.reset_launches()
    C, N, _, batch = compute_covar(ds, database=connect(ds, config=cfg,
                                                        device=cuda_device))
    assert sum(ops.LAUNCHES.values()) == 0 and batch.stats.n_kernel_launches == 0
    Cc, Nc, _, _ = compute_covar(ds, config=cfg, device="cpu")
    assert N == Nc
    np.testing.assert_allclose(C, Cc, rtol=1e-4, atol=1e-4 * np.abs(Cc).max())


def test_segment_sum_on_card_matches_float64(cuda_device):
    """The torch backend's float32 segment sum on the card, in copies of
    the segments per 4,096 rows, against a float64 sum on the host."""
    from repro_torch.core.lowering.torch import segment_sum

    rng = np.random.default_rng(5)
    n, n_seg = 1 << 20, 480
    ids = rng.integers(0, n_seg, n)
    pay = rng.normal(1.0, 1.0, (n, 9)).astype(np.float32)
    got = segment_sum(torch.from_numpy(ids).to(cuda_device),
                      torch.from_numpy(pay).to(cuda_device), n_seg)
    want = np.zeros((n_seg, 9))
    np.add.at(want, ids, pay.astype(np.float64))
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-5, atol=1e-4)


def test_auto_blocking_on_card(cuda_device, tmp_path):
    """block_size="auto" on the card: probes timed with CUDA events under
    cuda-platform keys, the tuned covar against the static one, the
    launches the chosen blocks give, and a second session that times
    nothing."""
    ds = TD.make("retailer", scale=0.5)
    cache = str(tmp_path / "autotune.json")
    db = connect(ds, config=ExecutionConfig(block_size="auto",
                                            autotune_cache=cache),
                 device=cuda_device)
    C, N, _, batch = compute_covar(ds, database=db)
    rep = batch.plan.last_autotune
    assert all("/cuda/cuda/" in r["key"] for r in rep)
    assert batch.plan.autotuner.n_timed > 0
    sizes = db.sizes()
    ops.reset_launches()
    batch(db.data)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fused_scan_block"] == sum(
        -(-sizes[r["rel"]] // min(r["block_size"], sizes[r["rel"]])) for r in rep)
    Cs, Ns, _, _ = compute_covar(ds, database=db.with_config(block_size=4096))
    assert N == Ns
    np.testing.assert_allclose(C, Cs, rtol=1e-4, atol=1e-4 * np.abs(Cs).max())
    _, _, _, warm = compute_covar(ds, database=db.with_config())
    assert warm.plan.autotuner.n_timed == 0


def _fact_updates(ds, n_ticks, seed=0, frac=0.01):
    """``frac`` of the fact rows inserted (drawn with replacement) and as
    many distinct rows deleted, ``n_ticks`` times (benchmarks/bench_ivm.py)."""
    rng = np.random.default_rng(seed)
    fact = ds.tables[ds.fact]
    n = len(next(iter(fact.values())))
    k = max(int(n * frac), 1)
    out = []
    for _ in range(n_ticks):
        pick = rng.integers(0, n, k)
        out.append(DeltaBatchUpdate()
                   .insert(ds.fact, {a: c[pick] for a, c in fact.items()})
                   .delete(ds.fact, rng.choice(n, k, replace=False)))
    return out


def test_ivm_steady_tick_syncs_nothing(cuda_device):
    """OnlineRidge's maintained covar on the card: after two warm ticks,
    four equal-shape 1% fact ticks run under sync_debug_mode "error" (no
    host sync) and build no tick runner; the maintained covar then agrees
    with a fresh pass over the post-update relations."""
    ds = TD.make("retailer", scale=1.0)
    db = connect(ds, config=ExecutionConfig(block_size=1 << 14), device=cuda_device)
    olr = OnlineRidge(ds, database=db)
    olr.fit()
    mb = olr.maintained
    updates = _fact_updates(ds, 6)
    for upd in updates[:2]:
        olr.view.apply(upd)
    builds = mb.n_fold_traces
    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for upd in updates[2:]:
            out = olr.view.apply(upd)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert mb.n_fold_traces == builds
    # a tick's 1,024 + 1,024 delta rows are one block of 2¹⁴
    assert ops.LAUNCHES["fused_scan_block"] == 4
    C, N = assemble_covar({k: v.cpu().numpy() for k, v in out.items()}, olr.layout)
    Cf, Nf = assemble_covar({k: v.cpu().numpy() for k, v in mb.batch(mb.db).items()},
                            olr.layout)
    assert N == Nf == 60_000
    d = np.sqrt(np.outer(np.diag(Cf), np.diag(Cf)))
    assert (np.abs(C - Cf) / d).max() <= 1e-4


@pytest.mark.parametrize("profiler", [False, True], ids=["obs", "obs_and_profiler"])
def test_traced_steady_tick_syncs_nothing(cuda_device, profiler):
    """The port's spans keep the no-sync rule: four steady 1% ticks with
    obs tracing on (and a profiler recording, which adds the annotations)
    sync nothing, and leave the tick's spans with their launches' work."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs

    ds = TD.make("retailer", scale=1.0)
    db = connect(ds, config=ExecutionConfig(block_size=1 << 14), device=cuda_device)
    olr = OnlineRidge(ds, database=db)
    olr.fit()
    updates = _fact_updates(ds, 6, seed=2)
    for upd in updates[:2]:
        olr.view.apply(upd)
    torch.cuda.synchronize()
    obs.clear_trace()
    obs.enable_tracing()
    prof = profile(activities=[ProfilerActivity.CUDA]) if profiler else None
    try:
        if prof is not None:
            prof.__enter__()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for upd in updates[2:]:
                olr.view.apply(upd)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            if prof is not None:
                prof.__exit__(None, None, None)
    finally:
        obs.disable_tracing()
    evs = obs.get_tracer().events()
    obs.clear_trace()
    names = [e["name"] for e in evs]
    for n in ("ivm.stage", "ivm.scan", "ivm.compact"):
        assert names.count(n) == 4, n
    launches = [e["args"] for e in evs if e["name"] == "kernel.fused_scan_block"]
    assert len(launches) == 4 and all(a["bytes"] > 0 and a["ops"] > 0 for a in launches)


def test_auto_delta_lane_steady_tick_syncs_nothing(cuda_device, tmp_path):
    """A maintained covar under block_size="auto": the delta lane tunes at
    the first tick's runner build; later ticks of the same shape probe
    nothing, build nothing and sync nothing; explain() shows both lanes."""
    ds = TD.make("retailer", scale=1.0)
    cfg = ExecutionConfig(block_size="auto",
                          autotune_cache=str(tmp_path / "autotune.json"))
    db = connect(ds, config=cfg, device=cuda_device)
    olr = OnlineRidge(ds, database=db)
    olr.fit()
    mb = olr.maintained
    updates = _fact_updates(ds, 4, seed=1)
    olr.view.apply(updates[0])
    delta = mb.plan.last_autotune_delta
    assert delta and all(r["delta"] and r["key"].endswith("/d1") for r in delta)
    builds, timed = mb.n_fold_traces, mb.plan.autotuner.n_timed
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for upd in updates[1:]:
            out = olr.view.apply(upd)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert mb.n_fold_traces == builds and mb.plan.autotuner.n_timed == timed
    s = olr.view.explain().summary()
    assert "autotune[batch]:" in s and "autotune[delta]:" in s
    C, N = assemble_covar({k: v.cpu().numpy() for k, v in out.items()}, olr.layout)
    Cf, Nf = assemble_covar({k: v.cpu().numpy() for k, v in mb.batch(mb.db).items()},
                            olr.layout)
    assert N == Nf == 60_000
    d = np.sqrt(np.outer(np.diag(Cf), np.diag(Cf)))
    assert (np.abs(C - Cf) / d).max() <= 1e-4


def test_compaction_at_capacity_2_24(cuda_device):
    """ResidentRelation.advance at a capacity of 2²⁴: 1% of the rows
    deleted (pads at the capacity) and as many appended, row for row
    against a numpy boolean-mask delete; the old buffers untouched."""
    n, k = 12_000_000, 120_000
    rng = np.random.default_rng(0)
    cols = {"a": rng.integers(0, 1000, n).astype(np.int32),
            "u": rng.normal(size=n).astype(np.float32)}
    ins = {"a": rng.integers(0, 1000, k).astype(np.int32),
           "u": rng.normal(size=k).astype(np.float32)}
    dels = rng.choice(n, k, replace=False)
    rr = ResidentRelation.from_relation(Relation(
        "T", {a: torch.from_numpy(c).to(cuda_device) for a, c in cols.items()}))
    assert rr.capacity == 1 << 24
    pad = next_pow2(k)
    got = rr.advance(
        {a: torch.from_numpy(np.pad(c, (0, pad - k))).to(cuda_device) for a, c in ins.items()},
        torch.from_numpy(np.pad(dels, (0, pad - k), constant_values=rr.capacity)).to(cuda_device),
        k, k)
    keep = np.ones(n, bool)
    keep[dels] = False
    assert got.n_valid == n and got.capacity == rr.capacity
    for a, c in cols.items():
        np.testing.assert_array_equal(got.columns()[a].cpu().numpy(),
                                      np.concatenate([c[keep], ins[a]]), err_msg=a)
        np.testing.assert_array_equal(rr.columns()[a].cpu().numpy(), c, err_msg=a)


@pytest.mark.parametrize("fuse_kernels", [True, False])
def test_weighted_delta_scan_matches_plain(cuda_device, fuse_kernels):
    """Every step of a batch scanned with row weights of -1, 0 and +1,
    through fused_scan_block (fused) or seg_aggregate (unfused) on the
    card and through the plain versions on the CPU.  Integer-valued data:
    every sum is an integer below 2²⁴, exact in float32 in any order, so
    the two agree exactly."""
    rng = np.random.default_rng(1)
    spec = ([("x1", "categorical", 3), ("x2", "key", 40), ("x3", "key", 50),
             ("x4", "categorical", 7), ("u", "continuous", 0)],
            [("R1", ["x1", "x2"]), ("R2", ["x2", "x3", "u"]), ("R3", ["x3", "x4"])])
    sizes = {"R1": 517, "R2": 70_001, "R3": 313}
    tables = {"R1": {"x1": rng.integers(0, 3, 517), "x2": rng.integers(0, 40, 517)},
              "R2": {"x2": rng.integers(0, 40, 70_001), "x3": rng.integers(0, 50, 70_001),
                     "u": rng.integers(-3, 4, 70_001).astype(np.float32)},
              "R3": {"x3": rng.integers(0, 50, 313), "x4": rng.integers(0, 7, 313)}}
    qs = [query("q_count", [], [COUNT]),
          query("q_sums", [], [sum_of("u"), agg(Pow("u", 2))]),
          query("q_g", ["x1", "x4"], [COUNT, sum_of("u")]),
          query("q_delta", ["x4"], [agg(Var("u"), Delta("x1", "==", 1))])]
    weights = {r: rng.integers(-1, 2, n).astype(np.float32) for r, n in sizes.items()}
    cfg = ExecutionConfig(block_size=1 << 14, fuse_kernels=fuse_kernels)
    arrays = {}
    for device in ("cpu", cuda_device):
        sess = connect(schema(*spec), tables=tables, config=cfg, device=device)
        plan = sess.views(qs).compiled.plan
        out = {}
        ops.reset_launches()
        for step, prog in zip(plan.schedule.steps, plan.step_programs):
            plan.backend.run_step(
                prog, sess.data.relation(step.rel).columns, out, {},
                n_valid=sizes[step.rel], config=plan.config,
                weights=torch.from_numpy(weights[step.rel]).to(device))
        arrays[str(device)] = {vid: v.cpu() for vid, v in out.items()}
    launched = dict(ops.LAUNCHES)
    assert launched["fused_scan_block" if fuse_kernels else "seg_aggregate"] > 0
    cpu, card = arrays["cpu"], arrays[str(cuda_device)]
    assert cpu.keys() == card.keys()
    for vid in cpu:
        assert torch.equal(card[vid], cpu[vid]), vid


def test_ivm_pinned_epoch_bitwise_across_apply(cuda_device):
    """A pinned epoch's results and relation buffers on the card are
    bitwise unchanged after an apply publishes the next epoch."""
    ds = TD.make("retailer", scale=0.5)
    db = connect(ds, config=ExecutionConfig(block_size=4096), device=cuda_device)
    olr = OnlineRidge(ds, database=db)
    olr.fit()
    mb = olr.maintained
    upd, = _fact_updates(ds, 1, seed=3)
    with mb.pinned() as e:
        before = {k: v.clone() for k, v in mb.results(epoch=e).items()}
        bufs = {name: {a: c.clone() for a, c in rr.buffers.items()}
                for name, rr in mb.epoch_state(e).relations.items()}
        olr.view.apply(upd)
        assert mb.epoch == e + 1
        for k, v in mb.results(epoch=e).items():
            assert torch.equal(v, before[k]), k
        for name, rr in mb.epoch_state(e).relations.items():
            for a, c in rr.buffers.items():
                assert torch.equal(c, bufs[name][a]), (name, a)


def _route_session(device):
    ds = TD.make("retailer", scale=1.0)
    db = connect(ds, config=ExecutionConfig(block_size=1 << 14,
                                            route_cache_capacity=2), device=device)
    wide = query("wide", ["date", "locn", "sku"],
                 [COUNT, sum_of("inventoryunits"), sum_of("maxtemp")])
    return ds, db, db.views([wide], maintain=True).serve(max_pinned_epochs=4)


HIT_ROUTES = {"q_exact": (["sku", "locn", "date"],
                          [sum_of("maxtemp"), COUNT, sum_of("inventoryunits")]),
              "q_locn": (["locn"], [COUNT, sum_of("inventoryunits")]),
              "q_date_sku": (["sku", "date"], [sum_of("maxtemp")]),
              "q_total": ([], [COUNT])}


def test_hit_routes_launch_nothing_and_sync_nothing(cuda_device):
    """Routed queries answered from a maintained view on the card: after a
    warm round, the exact and subsumed tiers run under sync_debug_mode
    "error" (no host sync) and launch no kernel; their answers (tensors on
    the card) equal the same routes on the CPU session; a compiled miss
    launches fused_scan_block."""
    answers = {}
    for device in ("cpu", cuda_device):
        _, db, _ = _route_session(device)
        for name, (gb, aggs) in HIT_ROUTES.items():     # warm: index tensors
            db.route(query(name, gb, aggs))
        ops.reset_launches()
        if device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            routed = {name: db.route(query(name, gb, aggs))
                      for name, (gb, aggs) in HIT_ROUTES.items()}
        finally:
            if device != "cpu":
                torch.cuda.set_sync_debug_mode(0)
        assert sum(ops.LAUNCHES.values()) == 0
        assert {n: r.tier for n, r in routed.items()} == {
            "q_exact": "exact", "q_locn": "subsumed", "q_date_sku": "subsumed",
            "q_total": "subsumed"}
        assert all(r.value.device.type == torch.device(device).type
                   for r in routed.values())
        answers[str(device)] = {n: r.value.cpu() for n, r in routed.items()}
        miss = db.route(query("q_rgn", ["rgn_cd"], [COUNT]))
        assert miss.tier == "compiled"
        if device != "cpu":
            assert ops.LAUNCHES["fused_scan_block"] > 0
    for name in HIT_ROUTES:
        torch.testing.assert_close(answers[str(cuda_device)][name], answers["cpu"][name],
                                   **TOL)


def test_view_server_tick_and_pinned_read_on_card(cuda_device):
    """ViewServer.apply of a 1% fact tick under sync_debug_mode "error"
    (after a warm tick), a snapshot held across it reads bitwise the same,
    and the routed subsumed answer reports the new epoch."""
    ds, db, srv = _route_session(cuda_device)
    updates = _fact_updates(ds, 2, seed=4)
    srv.apply(updates[0])
    q = query("q_locn", ["locn"], [COUNT, sum_of("inventoryunits")])
    db.route(q)
    with srv.snapshot() as snap:
        first = snap["wide"].clone()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            srv.apply(updates[1])
            r = db.route(q)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.equal(srv.maintained.results(epoch=snap.epoch)["wide"], first)
        assert r.epoch == snap.epoch + 1 and r.tier == "subsumed"
    st = srv.stats()
    assert st["n_updates"] == 2 and st["tick_us"]["count"] == 2


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


@pytest.mark.parametrize("name,p", [("retailer", 70), ("tpcds", 173)])
def test_fused_covar_on_card_matches_cpu(cuda_device, name, p):
    """The gathered-XᵀX covar (30,000 fact rows, blocks of 4,096 rows and a
    short last one) on the card against a CPU session of the same tables:
    every block went through the kernel.  TPC-DS's 173 features (4
    continuous, 16 categorical dimensions) run in two groups of pieces."""
    ds = TD.make(name, scale=0.5)
    ops.reset_launches()
    fn, layout = make_fused_covar(ds, block_size=4096,
                                  database=connect(ds, device=cuda_device))
    card = fn()
    assert card.device.type == "cuda" and layout.p == p
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


#: the float32 kernel (3xTF32) against float64 attention: float32-class,
#: which one TF32 product a term (2^-11 a product) cannot meet
F32_CLASS = 1e-5


def _check_f32(q, k, v, causal, window):
    """The float32 kernel against the plain version in float32 (allclose at
    2e-3, per query row ≤ 1e-3 of the row's rms, chip_smoke.py's limit)
    and against float64 attention within F32_CLASS; a row without keys
    must come back exactly 0."""
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.LAUNCHES["flash_attention"] == 1
    assert got.dtype == torch.float32
    assert tuple(got.shape) == tuple(q.shape[:3]) + (v.shape[3],)
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    tol = ATTN_TOL[torch.float32]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    err = (got - want).abs().amax(-1, keepdim=True)
    assert bool((err <= 1e-3 * rms).all()), float((err / rms.clamp_min(1e-30)).max())
    exact = ref.attention_ref(q.double(), k.double(), v.double(), causal=causal,
                              window=window)
    worst = float((got.double() - exact).abs().max())
    assert worst <= F32_CLASS, worst


@pytest.mark.parametrize("s", [63, 64, 65, 127, 128, 129, 255, 4096])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_f32_tile_edges(cuda_device, s, causal):
    """64-row query tiles and 64-key tiles (D_q ≤ 128) that end on and
    inside a tile's edge."""
    q, k, v = _qkv(2, 4, 2, s, 128, torch.float32, cuda_device, seed=s)
    _check_f32(q, k, v, causal, 0)


@pytest.mark.parametrize("s", [31, 32, 33, 100])
def test_flash_attention_f32_tile_edges_at_d_192(cuda_device, s):
    """The 32-key tiles of D_q = 192."""
    _check_f32(*_qkv_widths(2, 4, 2, s, s, 192, 128, torch.float32, cuda_device,
                            seed=s), True, 0)


@pytest.mark.parametrize("sq,sk", [(100, 300), (300, 100), (129, 1000),
                                   (1000, 129), (256, 255)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 100)])
def test_flash_attention_f32_sq_ne_sk(cuda_device, sq, sk, causal, window):
    """More keys than queries and fewer, with every mask."""
    rng = np.random.default_rng(sq + sk)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, n, s, 64)).astype(np.float32))
               .to(cuda_device) for n, s in ((8, sq), (4, sk), (4, sk)))
    _check_f32(q, k, v, causal, window)


@pytest.mark.parametrize("window", [100, 129, 4097])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_f32_windows(cuda_device, window, causal):
    """Windows whose edge falls inside a key tile, on a tile's edge + 1,
    and one key past a 4,096-key span."""
    q, k, v = _qkv(1, 4, 2, 5000, 128, torch.float32, cuda_device, seed=window)
    _check_f32(q, k, v, causal, window)


@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_flash_attention_f32_gqa_groups(cuda_device, group):
    q, k, v = _qkv(2, 8, 8 // group, 700, 128, torch.float32, cuda_device,
                   seed=group)
    _check_f32(q, k, v, True, 0)


@pytest.mark.parametrize("d", [8, 16, 64, 120, 128, 136, 192])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 200)])
def test_flash_attention_f32_head_dims(cuda_device, d, causal, window):
    """Head dims each instance covers only in part (8 ... 136) or whole."""
    q, k, v = _qkv(2, 4, 2, 600, d, torch.float32, cuda_device, seed=d)
    _check_f32(q, k, v, causal, window)


@pytest.mark.parametrize("dq,dv", [(192, 128), (192, 192)])
@pytest.mark.parametrize("sq,sk,causal,window", [(333, 333, True, 0), (100, 300, True, 0),
                                                 (300, 100, False, 0),
                                                 (777, 777, True, 100)])
def test_flash_attention_f32_wide_instances(cuda_device, dq, dv, sq, sk, causal, window):
    """<192, 128> (MLA) and <192, 192>: ragged tiles, S_q ≠ S_k, a window,
    on the model's strided views."""
    _check_f32(*_qkv_widths(2, 4, 2, sq, sk, dq, dv, torch.float32, cuda_device,
                            seed=sq + sk + dv), causal, window)


def test_flash_attention_f32_rows_without_keys_are_zero(cuda_device):
    """The float32 kernel under a window of 1 with more query rows than
    keys: a query tile wholly past S_k splits no key tile; S_k = 0."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(1, 2, 300, 64)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(1, 2, 70, 64)).astype(np.float32))
            for _ in range(2))
    q, k, v = (t.to(cuda_device) for t in (q, k, v))
    got = ops.flash_attention(q, k, v, causal=True, window=1)
    assert not bool(got[0, :, 70:].any())
    torch.testing.assert_close(got[0, :, :70], v[0], rtol=0, atol=1e-6)
    _check_f32(q, k, v, True, 1)
    none = ops.flash_attention(q, k[:, :, :0], v[:, :, :0], causal=False)
    assert tuple(none.shape) == tuple(q.shape) and not bool(none.any())


@pytest.mark.parametrize("dq,dv", [(128, 128), (192, 128), (192, 192)])
def test_flash_attention_f32_is_float32_class(cuda_device, dq, dv):
    """At D 128 and 192 over 2,048 keys the float32 kernel reads within
    1e-5 of float64 attention: 3xTF32, not one TF32 product a term."""
    q, k, v = _qkv_widths(2, 8, 4, 2048, 2048, dq, dv, torch.float32, cuda_device,
                          seed=dq + dv)
    got = ops.flash_attention(q, k, v, causal=True)
    exact = ref.attention_ref(q.double(), k.double(), v.double(), causal=True)
    worst = float((got.double() - exact).abs().max())
    assert worst <= F32_CLASS, worst


def test_flash_attention_raises_on_what_the_kernel_does_not_take(cuda_device):
    q, k, v = _qkv(1, 4, 2, 64, 64, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.flash_attention(*_qkv(1, 4, 2, 64, 12, torch.float32, cuda_device))
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.flash_attention(*_qkv(1, 4, 2, 64, 100, torch.float32, cuda_device))
    with pytest.raises(ValueError, match="bfloat16"):
        ops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="key/value heads"):
        ops.flash_attention(*_qkv(1, 4, 3, 64, 64, torch.float32, cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)


def _qkv_widths(b, h, hkv, sq, sk, dq, dv, dtype, device, seed=0):
    """q (B, H, S_q, D_q), k (B, H_kv, S_k, D_q), v (B, H_kv, S_k, D_v) as
    (B, H, S, D) views of (B, S, H, D) tensors, as the model passes them."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, s, n, d)).astype(np.float32))
            .to(device=device, dtype=dtype).transpose(1, 2)
            for n, s, d in ((h, sq, dq), (hkv, sk, dq), (hkv, sk, dv))]


def _check_widths(q, k, v, causal):
    """The kernel against the plain version in float32 at D_q ≠ D_v: the
    output is V's width; allclose at the dtype's tolerance and, in bf16,
    per query row within 5e-2 of the row's rms."""
    ops.reset_launches()
    got = ops.flash_attention(q, k, v, causal=causal)
    assert ops.LAUNCHES["flash_attention"] == 1
    assert got.dtype == q.dtype
    assert tuple(got.shape) == tuple(q.shape[:3]) + (v.shape[3],)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal)
    tol = ATTN_TOL[q.dtype]
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    err = (got.float() - want).abs().amax(-1, keepdim=True)
    assert bool((err <= tol * rms).all()), float((err / rms.clamp_min(1e-30)).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,causal", [(777, 777, True), (777, 777, False),
                                          (300, 1000, False), (1000, 300, True)])
def test_flash_attention_mla_widths(cuda_device, dtype, sq, sk, causal):
    """MLA's prefill widths, D_q = 192 and D_v = 128 (the <192, 128>
    instance), in both dtypes, ragged tiles, S_q ≠ S_k."""
    _check_widths(*_qkv_widths(2, 4, 4, sq, sk, 192, 128, dtype, cuda_device,
                               seed=sq + sk), causal)


@pytest.mark.parametrize("dq,dv", [(136, 64), (192, 8), (64, 32), (128, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_narrower_values(cuda_device, dq, dv, dtype):
    """D_v < D_q inside each instance: V's boxes only in part."""
    _check_widths(*_qkv_widths(1, 4, 2, 300, 300, dq, dv, dtype, cuda_device,
                               seed=dq + dv), True)


@pytest.mark.parametrize("dq,dv", [(192, 192), (192, 136)])
def test_flash_attention_f32_wide_values(cuda_device, dq, dv):
    """float32 takes D_v past 128 at D_q = 192 (<192, 192>); bf16 raises,
    its tile would not fit a block's shared memory."""
    q, k, v = _qkv_widths(1, 4, 2, 300, 300, dq, dv, torch.float32, cuda_device)
    _check_widths(q, k, v, True)
    with pytest.raises(ValueError, match="D_v up to 128"):
        ops.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())


@pytest.mark.parametrize("sq,sk", [(4096, 1024), (1000, 300), (300, 1000)])
def test_flash_attention_bf16_cross_attention(cuda_device, sq, sk):
    """The VLM's cross-attention: non-causal, S_q ≠ S_k, GQA 8:1, on the
    bf16 wgmma path (its query tiles in the causal order)."""
    _check_widths(*_qkv_widths(1, 16, 2, sq, sk, 128, 128, torch.bfloat16,
                               cuda_device, seed=sq + 2 * sk), False)


@pytest.mark.parametrize("sq", [1500, 448])
def test_flash_attention_bf16_audio_encoder(cuda_device, sq):
    """whisper's encoder (S 1,500, non-causal, D 64: the last key tile
    ragged at 92 keys) and its decoder's cross-attention (448 text rows
    against 1,500 frames)."""
    _check_widths(*_qkv_widths(2, 12, 12, sq, 1500, 64, 64, torch.bfloat16,
                               cuda_device, seed=sq), False)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "llama-3.2-vision-90b",
                                  "whisper-small"])
def test_new_families_on_card_match_cpu(cuda_device, arch):
    """The MLA, VLM and audio smoke configs: the forward on the card (the
    kernel, once an attention layer) against the dense forward on the CPU,
    and a teacher-forced decode step that launches nothing."""
    cfg = configs.get_smoke(arch)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    host = init_params(M.model_specs(cfg), gen, cfg.torch_dtype, "cpu")

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        return tree.to(cuda_device)

    card = to_card(host)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)))}
    if cfg.family == "vlm":
        batch["vision"] = torch.from_numpy(
            rng.normal(size=(2, cfg.vision_tokens, cfg.d_model)).astype(np.float32))
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(
            rng.normal(size=(2, cfg.encoder_frames, cfg.d_model)).astype(np.float32))
    want, _ = M.forward(host, batch, cfg, impl="dense")
    ops.reset_launches()
    got, _ = M.forward(card, to_card(batch), cfg)
    n_attn = cfg.n_layers + (cfg.encoder_layers + cfg.n_layers
                             if cfg.family == "audio" else 0)
    assert ops.LAUNCHES["flash_attention"] == n_attn
    torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=2e-3)
    context = M.encode_context(card, to_card(batch), cfg)
    cache = M.init_cache(cfg, 2, 8, cuda_device)
    ops.reset_launches()
    M.decode_step(card, cache, batch["tokens"][:, :1].to(cuda_device), 0, cfg,
                  context=context)
    assert sum(ops.LAUNCHES.values()) == 0


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


def test_kernel_wrappers_raise_under_grad_on_card(cuda_device):
    """The kernels have no backward: under grad each wrapper raises on the
    card as on the CPU, instead of returning a detached result."""
    q = torch.randn(1, 2, 64, 64, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_attention has no backward"):
        ops.flash_attention(q, q.detach(), q.detach())
    x = torch.randn(100, 8, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="covar_xtx has no backward"):
        ops.covar_xtx(x)
    codes = torch.zeros(100, dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match="seg_aggregate has no backward"):
        ops.seg_aggregate(codes, x, 2)
    ops.reset_launches()
    with torch.no_grad():
        ops.flash_attention(q, q, q)
    assert ops.LAUNCHES["flash_attention"] == 1


def _train_setup(device, **kw):
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.train.step import TrainConfig, init_state

    cfg = configs.get_smoke("internlm2-1.8b")
    tcfg = TrainConfig(peak_lr=1e-2, warmup=2, total_steps=30, ce_chunk=8, **kw)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    host = init_state(cfg, tcfg, gen, "cpu")

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        return tree.to(device)

    pipe = TokenPipeline(PipelineConfig(4, 16, cfg.vocab, seed=0), cfg, device=device)
    return cfg, tcfg, to(host), pipe


@pytest.mark.parametrize("kw", [dict(attn_impl="dense"),
                                dict(attn_impl="chunked", grad_accum=2),
                                dict(attn_impl="chunked", compress_grads=True)])
def test_train_step_on_card_matches_cpu(cuda_device, kw):
    """A float32 smoke-config train step on the card against the same step
    on the CPU, to 1e-4.  Adam's first step moves each parameter by about
    ±lr: an element whose gradient sits within float noise of 0 (or of an
    int8 rounding boundary) may move the other way, so parameters are held
    to 1e-4 on all but 1% of a leaf and to 2·lr everywhere."""
    from repro_torch.train.adamw import tree_leaves
    from repro_torch.train.step import make_train_step

    cfg, tcfg, card, pipe = _train_setup(cuda_device, **kw)
    _, _, host, hpipe = _train_setup("cpu", **kw)
    step = make_train_step(cfg.with_(remat=True), tcfg)
    ops.reset_launches()
    new, met = step(card, pipe.batch_at(0))
    want, wmet = step(host, hpipe.batch_at(0))
    assert sum(ops.LAUNCHES.values()) == 0
    for k in ("loss", "grad_norm", "lr"):
        torch.testing.assert_close(met[k].cpu(), wmet[k], rtol=1e-4, atol=0)
    lr = float(wmet["lr"])
    for g, w in zip(tree_leaves(new["m"]) + tree_leaves(new["v"]),
                    tree_leaves(want["m"]) + tree_leaves(want["v"])):
        off = (g.cpu() - w).abs() > 1e-4 * (w.abs() + w.abs().max())
        assert float(off.float().mean()) <= 0.01
    for g, w in zip(tree_leaves(new["params"]), tree_leaves(want["params"])):
        d = (g.cpu() - w).abs()
        assert float(d.max()) <= 2 * lr * (1 + 1e-5)
        assert float((d > 1e-4 * (lr + w.abs())).float().mean()) <= 0.01


def test_warm_train_step_syncs_nothing(cuda_device):
    """After a first step, a dense train step (pipeline batch, forward,
    backward, AdamW, schedule) runs under sync-debug "error"; the loss is
    read after."""
    from repro_torch.train.step import make_train_step

    cfg, tcfg, state, pipe = _train_setup(cuda_device, attn_impl="dense")
    step = make_train_step(cfg, tcfg)
    state, _ = step(state, pipe.batch_at(0))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in (1, 2):
            state, met = step(state, pipe.batch_at(i))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(met["loss"])) and int(state["step"]) == 3


# -------------------------------------------------- domain parallelism

def _card_ranks(world, tmp_path, backend):
    from torch_dist_harness import card_covar_case, run_ranks
    return run_ranks(card_covar_case, world, tmp_path, 2, 3, backend=backend)


def _scaled(C, D):
    d = np.sqrt(np.maximum(np.outer(np.diag(D), np.diag(D)), 1e-300))
    return float((np.abs(C - D) / d).max())


def test_world_size_1_nccl_covar_and_ticks(cuda_device, tmp_path):
    """World size 1 over NCCL, in a subprocess: the sharded covar launches
    what the unsharded one does and sums the same rows (the scan kernels
    add in an order that varies by run, so two unsharded runs are not
    bitwise alike either: held at 1e-4 of each entry's Cauchy–Schwarz
    bound, N exact); a sharded maintained copy's ticks after the first
    run under sync-debug "error" and build no runner."""
    r, = _card_ranks(1, tmp_path, "nccl")
    assert r["launches_s"] == r["launches_l"] > 0
    assert r["N_s"] == r["N_l"] == 2 * 60_000
    assert _scaled(r["C_s"], r["C_l"]) <= 1e-4
    assert r["builds"] == [1, 0, 0]
    for C, N in r["ticks"]:
        assert np.isfinite(C).all() and N == r["N_l"]


def test_two_gloo_ranks_on_the_card_sum_to_one_rank(cuda_device, tmp_path):
    """Two ranks over gloo on one card: each scans half the fact rows, the
    all-reduced covar is the same on both (bitwise) and equals one rank's
    unsharded covar; each rank launches fewer blocks than the whole."""
    ranks = _card_ranks(2, tmp_path, "gloo")
    np.testing.assert_array_equal(ranks[0]["C_s"], ranks[1]["C_s"])
    for r in ranks:
        assert r["N_s"] == r["N_l"]
        assert _scaled(r["C_s"], r["C_l"]) <= 1e-4
        assert 0 < r["launches_s"] < r["launches_l"]
    for (C0, N0), (C1, N1) in zip(ranks[0]["ticks"], ranks[1]["ticks"]):
        np.testing.assert_array_equal(C0, C1)
        assert N0 == N1


# ------------------------------------------------------ the LM on a mesh

def test_world_size_1_nccl_sharded_prefill_and_train(cuda_device, tmp_path):
    """World size 1 over NCCL, in a subprocess, on a (1, 1) mesh: the
    sharded bf16 prefill launches ``flash_attention`` once a layer on the
    local heads and reads the unsharded prefill's logits (the same kernels
    on the same tensors); a kernel wrapper refuses a DTensor; warm sharded
    train steps run under sync-debug "error"."""
    from torch_dist_harness import card_lm_case, run_ranks

    r, = run_ranks(card_lm_case, 1, tmp_path, backend="nccl")
    cfg = configs.get_smoke("internlm2-1.8b")
    assert r["launches"]["flash_attention"] == cfg.n_layers
    assert sum(r["launches"].values()) == cfg.n_layers
    scale = np.abs(r["want"]).max()
    assert np.abs(r["got"] - r["want"]).max() <= 1e-2 * scale
    assert r["refused"] is not None and "not DTensors" in r["refused"]
    assert all(np.isfinite(r["losses"]))

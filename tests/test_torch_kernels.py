"""The port's scan kernels against the reference's.

On the CPU the port's wrappers run their plain versions; those must agree
with the reference Pallas kernels (interpret mode) and the reference's jnp
oracles on the same numpy inputs, in the manner of tests/test_kernels.py.
Tolerance: rtol/atol 1e-4, the reference's own for float32 segment sums
(the two sum in different orders).  The CUDA kernels themselves are held
against the plain versions in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import fused_scan, ops
from repro_torch.kernels import seg_aggregate as kseg

TOL = dict(rtol=1e-4, atol=1e-4)


def _fused_case(n, n_cond=1, extra_hist=False, seed=0, spill=0):
    """Two seg buckets + hist(s) over one shared row block (the packing of
    tests/test_kernels.py::_fused_case, with every hist reading the one
    [1, y, y²] triple at the end); ``spill`` draws codes up to that far
    outside each domain.  Specs are raw tuples
    (kind, code_col, n_segments, width, pay_off, n_cond, yk_off)."""
    rng = np.random.default_rng(n + n_cond + seed)
    S1, W1, S2, W2 = 13, 5, 7, 3
    doms = [S1, S2, 6] + ([9] if extra_hist else [])
    codes = np.stack([rng.integers(-spill, d + spill, n).astype(np.int32)
                      for d in doms], axis=1)
    pay_cols = [rng.normal(size=(n, W1)).astype(np.float32),
                rng.normal(size=(n, W2)).astype(np.float32)]
    n_hist = len(doms) - 2
    pay_cols += [(rng.random((n, n_cond)) < 0.5).astype(np.float32)
                 for _ in range(n_hist)]
    y = rng.normal(size=n).astype(np.float32)
    pay_cols.append(np.stack([np.ones(n, np.float32), y, y * y], axis=1))
    yk_off = W1 + W2 + n_hist * n_cond
    specs = [("seg", 0, S1, W1, 0, 0, 0), ("seg", 1, S2, W2, W1, 0, 0)]
    specs += [("hist", 2 + h, doms[2 + h], 3 * n_cond, W1 + W2 + h * n_cond,
               n_cond, yk_off) for h in range(n_hist)]
    return codes, np.concatenate(pay_cols, axis=1), specs


def _specs(mod, raw):
    return tuple(mod.ReduceSpec(k, c, s, w, o, n_cond=nc, yk_off=yo)
                 for k, c, s, w, o, nc, yo in raw)


@pytest.mark.parametrize("n", [1, 100, 513, 517])
@pytest.mark.parametrize("spill", [0, 3])
def test_fused_plain_matches_reference(n, spill):
    codes, fpay, raw = _fused_case(n, spill=spill)
    got = ops.fused_scan_block(torch.from_numpy(codes),
                               torch.from_numpy(fpay), _specs(ops, raw))
    jspecs = _specs(jops, raw)
    want_ref = jref.fused_scan_block_ref(jnp.asarray(codes),
                                         jnp.asarray(fpay), jspecs)
    for g, w in zip(got, want_ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if spill == 0 and n in (1, 517):
        # the reference kernel itself (in-range codes), at a single row and a
        # ragged block edge
        want = jops.fused_scan_block(jnp.asarray(codes), jnp.asarray(fpay),
                                     jspecs, block_rows=128, interpret=True,
                                     double_buffer=False)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("n,n_cond", [(257, 1), (1000, 4)])
def test_fused_plain_multi_hist_shared_yk(n, n_cond):
    codes, fpay, raw = _fused_case(n, n_cond=n_cond, extra_hist=True)
    got = ops.fused_scan_block(torch.from_numpy(codes),
                               torch.from_numpy(fpay), _specs(ops, raw))
    want = jops.fused_scan_block(jnp.asarray(codes), jnp.asarray(fpay),
                                 _specs(jops, raw), block_rows=256,
                                 interpret=True)
    for sp, g, w in zip(raw, got, want):
        assert tuple(g.shape) == (sp[2], sp[3])
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("n", [1, 100, 513, 517])
def test_seg_and_hist_plain_match_reference(n):
    rng = np.random.default_rng(n)
    d = 6
    codes = rng.integers(-2, d + 2, n).astype(np.int32)   # some out of range
    y = rng.normal(size=n).astype(np.float32)
    cond = (rng.random(n) < 0.5).astype(np.float32)
    pay = rng.normal(size=(n, 3)).astype(np.float32)
    got = ops.tree_hist(torch.from_numpy(codes), torch.from_numpy(y),
                        torch.from_numpy(cond), d)
    want = jref.tree_hist_ref(jnp.asarray(codes), jnp.asarray(y),
                              jnp.asarray(cond), d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = ops.seg_aggregate(torch.from_numpy(codes), torch.from_numpy(pay), d)
    want = jref.seg_aggregate_ref(jnp.asarray(codes), jnp.asarray(pay), d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if n != 517:
        return
    # and the reference's padded kernel wrappers on in-range codes
    ok = np.clip(codes, 0, d - 1)
    got = ops.seg_aggregate(torch.from_numpy(ok), torch.from_numpy(pay), d)
    want = jops.seg_aggregate(jnp.asarray(ok), jnp.asarray(pay), d,
                              block_rows=256, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = ops.tree_hist(torch.from_numpy(ok), torch.from_numpy(y),
                        torch.from_numpy(cond), d)
    want = jops.tree_hist(jnp.asarray(ok), jnp.asarray(y), jnp.asarray(cond),
                          d, block_rows=256, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_tensors_run_plain_versions_uncounted():
    codes, fpay, raw = _fused_case(64)
    ops.reset_launches()
    ops.fused_scan_block(torch.from_numpy(codes), torch.from_numpy(fpay),
                         _specs(ops, raw))
    ops.seg_aggregate(torch.zeros(4, dtype=torch.int32), torch.ones(4, 2), 3)
    ops.tree_hist(torch.zeros(4, dtype=torch.int32), torch.ones(4),
                  torch.ones(4), 3)
    ops.tree_hist_batched(torch.zeros(4, dtype=torch.int32), torch.ones(4),
                          torch.ones(4, 2), 3)
    ops.covar_xtx(torch.ones(4, 3), torch.ones(4))
    ops.flash_attention(torch.ones(1, 2, 5, 8), torch.ones(1, 1, 5, 8),
                        torch.ones(1, 1, 5, 8))
    assert ops.LAUNCHES == {"covar_xtx": 0, "flash_attention": 0,
                            "fused_scan_block": 0, "seg_aggregate": 0,
                            "tree_hist": 0, "tree_hist_batched": 0}


@pytest.mark.parametrize("n_segments,width", [(4960, 99), (12000, 1),
                                              (1, 250), (480, 3)])
def test_column_tiles_cover_width_within_shared_memory(n_segments, width):
    tiles = fused_scan.column_tiles(n_segments, width)
    cols = [c0 + j for c0, t in tiles for j in range(t)]
    assert cols == list(range(width))
    assert all(n_segments * t * 4 <= fused_scan.SMEM_BYTES for _, t in tiles)
    assert all(t <= fused_scan.THREADS for _, t in tiles)


def test_column_tiles_reject_a_spec_no_tile_fits():
    with pytest.raises(ValueError, match="does not fit"):
        fused_scan.column_tiles(fused_scan.SMEM_BYTES // 4 + 1, 1)


@pytest.mark.parametrize("n_segments", [1, 58112, 58113, 120000, 400000])
def test_segment_ranges_cover_segments_within_shared_memory(n_segments):
    ranges = fused_scan.segment_ranges(n_segments)
    assert [s0 + i for s0, k in ranges for i in range(k)] == \
        list(range(n_segments))
    assert all(k <= fused_scan.MAX_TILE_SEGMENTS for _, k in ranges)
    assert len(ranges) == -(-n_segments // fused_scan.MAX_TILE_SEGMENTS)


def test_launch_plan_cuts_a_wide_reduction_into_segment_ranges(monkeypatch):
    """A single-root Chow-Liu view grouped by sku × category × subcategory
    (120,000 segments): every (segment, column) in exactly one item."""
    import types
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=132))
    specs = (ops.ReduceSpec("seg", 0, 120000, 2, 0),
             ops.ReduceSpec("seg", 1, 40, 4, 2))
    plan = fused_scan.launch_plan.__wrapped__(specs, ("seg",) * 2, 70001,
                                              torch.device("cpu"))
    items = plan.items.tolist()
    cells = sorted((it[8], it[12] + s, it[6] + c) for it in items
                   for s in range(it[2]) for c in range(it[7]))
    want = sorted([(0, s, c) for s in range(120000) for c in range(2)]
                  + [(240000, s, c) for s in range(40) for c in range(4)])
    assert cells == want
    assert all(4 * it[2] * it[7] <= fused_scan.SMEM_BYTES for it in items)


@pytest.mark.parametrize("n", [1, 4097, 4960, 1 << 20])
def test_launch_plan_covers_rows_and_scratch(monkeypatch, n):
    """Work items of the fact step's fused launch: every output column of
    every spec in exactly one item, every row in one chunk of each item,
    and disjoint partial tiles in the scratch buffer."""
    import types
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=132))
    specs = (ops.ReduceSpec("seg", 0, 4960, 99, 0),
             ops.ReduceSpec("seg", 1, 40, 4, 99),
             ops.ReduceSpec("seg", 2, 480, 20, 103))
    plan = fused_scan.launch_plan.__wrapped__(specs, ("seg",) * 3, n,
                                              torch.device("cpu"))
    items = plan.items.tolist()
    assert len(items) == plan.n_items == 11
    spans = []
    for sp, (off, s, w) in zip(specs, plan.outputs):
        mine = [it for it in items if it[8] == off]
        assert sorted(c for it in mine for c in range(it[6], it[6] + it[7])) \
            == list(range(w))
    for it in items:
        size, n_chunks, chunk_rows = it[2] * it[7], it[10], it[11]
        assert (n_chunks - 1) * chunk_rows < n <= n_chunks * chunk_rows
        assert 4 * size <= plan.smem_bytes <= fused_scan.SMEM_BYTES
        spans.append((it[9], it[9] + n_chunks * size))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] == plan.scratch_numel
    assert plan.n_chunks == max(it[10] for it in items)


@pytest.mark.parametrize("n,chunk_rows", [(4960, 131), (40, 20), (30, 30)])
def test_launch_plan_spreads_a_short_scan(monkeypatch, n, chunk_rows):
    """The covar plan's last Weather step (seven narrow reductions, 4,960
    rows) gets about two blocks per SM, in chunks of no fewer than
    MIN_CHUNK_ROWS rows: short chunks keep integer count partials below
    2^24, where float32 adds are exact."""
    import types
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=132))
    specs = (ops.ReduceSpec("seg", 0, 1, 55, 0),) + tuple(
        ops.ReduceSpec("seg", 1 + i, s, w, 55) for i, (s, w) in enumerate(
            [(2, 64), (4, 1), (4, 1), (2, 64), (4, 1), (2, 64)]))
    plan = fused_scan.launch_plan.__wrapped__(specs, ("seg",) * 7, n,
                                              torch.device("cpu"))
    items = plan.items.tolist()
    assert len(items) == 7
    assert {it[11] for it in items} == {chunk_rows}
    assert all(it[10] * it[11] >= n > (it[10] - 1) * it[11] for it in items)


SEG_SHAPES = [(4960, 99), (4800, 1), (480, 20), (40, 4), (1, 1), (13, 1500),
              (60000, 3), (120000, 3), (4960, 1024), (4960, 1025), (2, 513),
              (100000, 1), (7, 4096), (30000, 7), (64, 512), (3, 2)]


@pytest.mark.parametrize("n_segments,width", SEG_SHAPES)
def test_seg_layout_covers_every_cell_once(n_segments, width):
    """seg_aggregate's work items: every (segment, column) of the output in
    exactly one block, each block within the shared-memory budget, and one
    block for an accumulator that fits one."""
    lay = kseg.seg_layout(n_segments, width)
    assert lay.smem_bytes <= kseg.SMEM_BYTES
    assert lay.mode == (0 if kseg.fits_one_block(n_segments, width) else 1)
    cells = np.zeros((n_segments, width), dtype=np.int64)
    for s0, ns, c0, t, _ in lay.items:
        assert ns > 0 and t > 0
        cells[s0:s0 + ns, c0:c0 + t] += 1
        assert ns * t <= lay.max_size <= lay.part_stride
    assert (cells == 1).all()
    if lay.mode == 0:
        assert len(lay.items) == 1 and lay.stage_rows % 32 == 0


def test_seg_layout_at_the_fact_bucket():
    """The covar plan's widest fact bucket: 11 ranges of 450-451 segments
    with all 99 columns, a block each."""
    lay = kseg.seg_layout(4960, 99)
    assert lay.mode == 1 and len(lay.items) == 11
    assert {it[1] for it in lay.items} == {450, 451}
    assert {it[3] for it in lay.items} == {99}


@pytest.mark.parametrize("n,per_chunk,wave", [(1, 1, 264), (4960, 1, 264),
                                              (1_000_003, 11, 132),
                                              (1_048_576, 1, 264),
                                              (84_000_000, 11, 132),
                                              (300_007, 1, 7)])
def test_seg_chunks_cover_rows(n, per_chunk, wave):
    """Every row in exactly one chunk, no chunk empty or past
    MAX_CHUNK_ROWS, and the grid whole waves where the cap cuts chunks."""
    chunk_rows, n_chunks = kseg.seg_chunks(n, per_chunk, wave)
    assert 0 < chunk_rows <= kseg.MAX_CHUNK_ROWS
    assert (n_chunks - 1) * chunk_rows < n <= n_chunks * chunk_rows
    if n >= kseg.MIN_CHUNK_ROWS * max(1, wave // per_chunk):
        assert n_chunks * per_chunk <= wave or n_chunks % (wave // per_chunk) == 0

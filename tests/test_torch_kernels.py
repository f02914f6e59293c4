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
from repro_torch.kernels import fused_scan as kfused
from repro_torch.kernels import ops
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


def _as_parts(codes, fpay, raw, formed):
    """The reduction of ``_fused_case``'s packed inputs in the parts form,
    each laid out another way than packed: the first seg's columns a
    strided slice of a wider matrix (every other column), the second seg's
    columns 0 and 2 one part at an output stride of 2, its constant column 1
    (set to 2.5 by the caller) an expanded scalar (row stride 0); each
    hist's cond read
    transposed from an (N, n) array, its yk either random columns read at
    a column stride or formed from y on the card."""
    n = codes.shape[0]
    c = torch.from_numpy(codes)
    (_, _, s1, w1, o1, _, _), (_, _, s2, w2, o2, _, _) = raw[:2]
    wide = torch.zeros((n, 2 * w1))
    wide[:, ::2] = torch.from_numpy(fpay[:, o1:o1 + w1])
    p2 = torch.from_numpy(fpay[:, [o2, o2 + 2]].copy())
    reds = [ops.Parts("seg", c[:, 0], (ops.Part(wide[:, ::2], 0),), s1),
            ops.Parts("seg", c[:, 1], (ops.Part(p2, 0, 2),
                                       ops.Part(torch.tensor(2.5).expand(n), 1)),
                      s2, w2)]
    for k, cc, s, _, po, nc, yo in raw[2:]:
        cond_t = torch.from_numpy(np.ascontiguousarray(fpay[:, po:po + nc].T))
        if formed:
            y = torch.from_numpy(fpay[:, yo + 1].copy())
        else:
            yk = torch.zeros((n, 6))
            yk[:, ::2] = torch.from_numpy(fpay[:, yo:yo + 3])
            y = yk[:, ::2]
        reds.append(ops.Parts("hist", c[:, cc], (cond_t.t(), y), s))
    return reds


@pytest.mark.parametrize("formed", [False, True])
@pytest.mark.parametrize("n", [1, 517, 1000])
def test_fused_parts_plain_matches_reference(n, formed):
    """The parts form, through the plain version, against the reference's
    fused_scan_block (interpret mode) on the same values packed: strided
    seg parts, an expanded (row stride 0) column, transposed conds, random
    yk columns or yk formed from y."""
    codes, fpay, raw = _fused_case(n, n_cond=3, extra_hist=True, spill=0)
    yo = raw[2][6]
    if formed:
        y = fpay[:, yo + 1]
        fpay[:, yo] = 1.0
        fpay[:, yo + 2] = y * y
    else:
        fpay[:, yo:yo + 3] = np.random.default_rng(n).normal(
            size=(n, 3)).astype(np.float32)
    fpay[:, raw[1][4] + 1] = 2.5
    got = ops.fused_scan_parts(_as_parts(codes, fpay, raw, formed))
    want = jops.fused_scan_block(jnp.asarray(codes), jnp.asarray(fpay),
                                 _specs(jops, raw), block_rows=256,
                                 interpret=True)
    for sp, g, w in zip(raw, got, want):
        assert tuple(g.shape) == (sp[2], sp[3])
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("parts", [((0, 1, 2), (1, 1, 1)),    # column 1 twice
                                   ((0, 2, 2), (2, 1, 1))])   # column 2 twice
def test_fused_parts_reject_overlapping_columns(parts):
    """Two parts that name one output column are refused (the kernel's
    blocks would write it in no fixed order), by the plain version too."""
    n = 8
    reds = [ops.Parts("seg", torch.zeros(n, dtype=torch.int32),
                      tuple(ops.Part(torch.ones(n, w) if w > 1 else torch.ones(n),
                                     ocol, ostride)
                            for ocol, ostride, w in parts), 2, 4)]
    with pytest.raises(ValueError, match="one output column"):
        ops.fused_scan_parts(reds)
    assert kfused.disjoint_columns(4, parts) is False
    assert kfused.disjoint_columns(4, ((0, 2, 2), (1, 2, 2))) is True


def test_cpu_tensors_run_plain_versions_uncounted():
    codes, fpay, raw = _fused_case(64)
    ops.reset_launches()
    ops.fused_scan_block(torch.from_numpy(codes), torch.from_numpy(fpay),
                         _specs(ops, raw))
    ops.fused_scan_parts(_as_parts(codes, fpay, raw, True))
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


def _hist(S, n_cond, y_cols=1):
    return kseg.Shape("hist", S, (n_cond, y_cols), 3 * n_cond)


def _seg(S, *parts, width=None):
    return kseg.Shape("seg", S, tuple(parts), width or sum(parts))


#: launches of several reductions and their rows: chip_smoke.py's three
#: fused plan steps (packed, and the covar fact step as the lowering passes
#: it, one part per aggregate column; the tree fact step too),
#: tree_hist_batched at 1, 16 and 200 nodes, a single-root Chow-Liu
#: view of 120,000 segments (packed, and in parts), a width past
#: MAX_TILE_B, polyreg's one-segment 540 columns, reductions of both range
#: paths and kinds (three sorted, one of two column tiles), and a 30-row scan
LAUNCHES = {
    "covar_fact": ([_seg(4960, 99), _seg(40, 4), _seg(480, 20)], 1_000_003),
    "covar_fact_parts": ([_seg(4960, *([1] * 45), 5, 6, 10, 25, 8),
                          _seg(40, *([1] * 4)), _seg(480, 20)], 1_000_003),
    "covar_items": ([_seg(4800, 1), _seg(3840, 1), _seg(12000, 1),
                     _hist(480, 1, 3)], 1_000_003),
    "tree_fact": ([_seg(4960, 48), _hist(40, 16, 3), _hist(480, 16, 3)],
                  1_000_003),
    "tree_hist_batched_1": ([_hist(480, 1)], 1_000_003),
    "tree_hist_batched_16": ([_hist(480, 16)], 1_000_003),
    "tree_hist_batched_200": ([_hist(480, 200)], 1_000_003),
    "chowliu_single_root": ([_seg(120000, 2), _seg(40, 4)], 70_001),
    "chowliu_single_root_parts": ([_seg(120000, 1, 1), _seg(40, 1, 1, 1, 1)],
                                  70_001),
    "tree_fact_parts": ([_seg(4960, *([1] * 48)), _hist(40, 16), _hist(480, 16)],
                        1_000_003),
    "wide": ([_seg(4960, 700, 800, width=1600), _seg(13, 1)], 84_000_000),
    "polyreg": ([_seg(1, *([1] * 540))], 1 << 20),
    "sorted_mixed": ([_hist(90_000, 64), _seg(20_000, 700, 900, width=1600),
                      _seg(2_000_000, 3, 4), _seg(60_000, 3, 4)], 1_000_003),
    "short": ([_seg(1, 55)] + [_seg(s, w) for s, w in [(2, 64), (4, 1), (4, 1),
                                                       (2, 64), (4, 1), (2, 64)]],
              30),
}


@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("case", sorted(LAUNCHES))
def test_launch_layout_covers_every_cell_once(case, per_sm):
    """Every (reduction, segment, accumulator column) cell in exactly one
    work item; the grids taking the items in order, a partial kernel each,
    their blocks within the shared-memory budget; each scan item's chunks
    covering the rows, none past MAX_CHUNK_ROWS; a sorted-path reduction in
    a grid of its own, its chunks of listed rows none past MAX_CHUNK_ROWS;
    disjoint partials and sort areas in scratch; each reduction in the mode
    its shape fits."""
    shapes, n = LAUNCHES[case]
    lay = kseg.launch_layout(n, shapes, lambda kernel, smem: per_sm * 132)
    assert len(lay.layouts) == len(shapes)
    grid_of = [g for g in lay.grids for _ in range(g.n_items)]
    assert len(grid_of) == len(lay.items)
    cells = [np.zeros((sh.n_segments, sh.acc_width), np.int8) for sh in shapes]
    by_out = {off: i for i, (off, _, _) in enumerate(lay.outputs)}
    order, spans, regions = [], [], {}
    for it, g in zip(lay.items, grid_of):
        (s0, ns, c0, t, soff, kind, width, out, code, src0, nsrc, ncond,
         srows, nch, crows, pst, copies, sort, rng, n_ranges, n_tiles, n_segs) = it
        i = by_out[out]
        sh, sub = shapes[i], lay.layouts[i]
        assert g.kernel == kseg.kernel_of(sh, sub)
        assert kind == kseg.KINDS[sh.kind] and width == sh.width
        assert nsrc == len(sh.parts) and src0 == code + 1
        assert ncond == (sh.parts[0] if sh.kind == "hist" else 0)
        cells[i][s0:s0 + ns, c0:c0 + t] += 1
        unit = 3 if sh.kind == "hist" else 1
        assert ns * t <= sub.part_stride and c0 % unit == 0 and t % unit == 0
        assert copies == sub.copies >= 1
        assert 0 < crows <= min(g.chunk_rows, kseg.MAX_CHUNK_ROWS)
        assert (nch - 1) * crows < n <= nch * crows and nch <= g.n_chunks
        assert sub.smem_bytes <= g.smem_bytes <= kseg.SMEM_BYTES
        if sort < 0:
            assert nch <= 65535 and g.blocks == (g.n_items, g.n_chunks)
            assert pst == sub.part_stride
            spans.append((soff, soff + nch * pst))
        else:
            assert sub.mode == 2 and g.sort_off == sort and g.n_items == len(sub.items)
            assert (n_ranges, n_tiles, n_segs) == (sub.n_ranges, g.blocks[1], sh.n_segments)
            assert sub.items.index((s0, ns, c0, t, 0)) // n_tiles == rng
            assert pst == n_tiles * sub.part_stride and crows == g.chunk_rows
            regions.setdefault(i, (g, []))[1].append(soff)
        order.append(g.kernel)
    for i, (g, offs) in regions.items():
        sub = lay.layouts[i]
        spans.append((min(offs), min(offs) + g.blocks[0] * g.blocks[1] * sub.part_stride))
        spans.append((g.sort_off, g.sort_off + kseg.sort_words(n, sub.n_ranges,
                                                                 g.blocks[0])))
        assert g.sort_off % 4 == 0
    assert all((c == 1).all() for c in cells)
    assert order == sorted(order)
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] == lay.scratch_numel
    assert lay.scratch_base % 4 == 0 and lay.scratch_base >= lay.out_numel
    assert 0 < lay.combine_blocks <= kseg.COMBINE_BLOCKS
    for sh, sub in zip(shapes, lay.layouts):
        fits = (kseg.fits_one_block(sh.n_segments, sh.acc_width) if sh.kind == "seg"
                else sh.parts[0] <= kseg.THREADS
                and 4 * sh.n_segments * sh.width <= kseg.SMEM_BYTES)
        assert sub.mode == (0 if fits else 2 if sub.n_ranges >= kseg.SORTED_MIN_RANGES else 1)
        assert sub.mode == kseg.reduction_mode(sh.kind, sh.n_segments, sh.acc_width)
    assert lay.range_paths == tuple(sum(sub.mode == m for sub in lay.layouts) for m in (1, 2))
    srcs = sum(1 + len(sh.parts) for sh in shapes)
    assert max(it[8] for it in lay.items) < srcs


#: range-mode reductions as the cells' plans launch them, their rows, and
#: the path each takes: the covar fact (Inventory) step's three
#: reductions on Retailer (the (dateid, locn) view 489 columns wide in
#: 13,170 ranges; (ksn) 42 wide; (locn)), Favorita's Sales step's
#: (date, store_nbr) and (date) buckets, a tree level's (date, store)
#: histograms, and the maintained ridge's delta step (one segment, 3,817
#: columns in four tiles of one range)
PATH_CASES = {
    "retailer_fact_dateid_locn": ("seg", 1_158_960, 489, 1 << 20, 2),
    "retailer_fact_ksn": ("seg", 5_618, 42, 1 << 20, 1),
    "retailer_fact_locn": ("seg", 1_317, 6, 1 << 20, 0),
    "favorita_date_store": ("seg", 90_936, 374, 1 << 20, 2),
    "favorita_date": ("seg", 1_684, 442, 1 << 20, 1),
    "favorita_tree_date_store_64": ("hist", 90_936, 192, 1 << 20, 2),
    "ivm_delta": ("seg", 1, 3_817, 840_558, 1),
    "one_block_hist": ("hist", 480, 48, 1 << 20, 0),
}


@pytest.mark.parametrize("case", sorted(PATH_CASES))
def test_range_path_follows_the_shape(case):
    """The sorted path is taken by shape alone (SORTED_MIN_RANGES ranges
    or more): the covar cells' wide fact buckets
    take it, the maintained ridge's delta step and one-block shapes do not;
    the kernel spans' mode string follows the same rule."""
    kind, S, width, n, mode = PATH_CASES[case]
    n_cond = width // 3
    sh = (kseg.Shape("hist", S, (n_cond, 1), width) if kind == "hist"
          else kseg.Shape("seg", S, (1,) * width, width))
    assert kseg.reduction_mode(kind, S, width) == mode
    lay = kseg.launch_layout(n, [sh], lambda kernel, smem: 132)
    assert lay.layouts[0].mode == mode
    assert lay.range_paths == ((1, 0) if mode == 1 else (0, 1) if mode == 2 else (0, 0))
    args = ops._launch_args(n, [], [(kind, S, width, width, 1)])
    assert args["reductions"][0][0] == kind + ("", ".range", ".sorted")[mode]


def test_sorted_path_refuses_rows_past_int32():
    """The sorted path lists a row by its int32 index: a launch of 2^31
    rows with a sorted-path reduction fails on the host rather than taking
    another path, and one row fewer is laid out."""
    sh = kseg.Shape("seg", 1_158_960, (1,) * 489, 489)
    with pytest.raises(ValueError, match="int32"):
        kseg.launch_layout(1 << 31, [sh], lambda kernel, smem: 132)
    lay = kseg.launch_layout((1 << 31) - 1, [sh], lambda kernel, smem: 132)
    assert lay.layouts[0].mode == 2


def _counts(kind: str, n: int, n_ranges: int, rng) -> np.ndarray:
    """Rows a range: uniform, zipf-skewed, or every row in one range."""
    if kind == "one":
        c = np.zeros(n_ranges, np.int64)
        c[n_ranges // 2] = n
        return c
    if kind == "zipf":
        return np.bincount(np.minimum(rng.zipf(1.3, n), n_ranges) - 1, minlength=n_ranges)
    return np.bincount(rng.integers(0, n_ranges, n), minlength=n_ranges)


@pytest.mark.parametrize("counts", ["uniform", "zipf", "one"])
@pytest.mark.parametrize("n,n_ranges,scan_chunks", [
    (1 << 20, 13_170, 4), (1 << 20, 784, 4), (1 << 20, 8, 4), (1 << 20, 17, 4),
    (100_000, 50, 1), (262_144, 8, 1), (300_000, 8, 2), (5, 13_170, 1),
    (84_055_817, 13_170, 321)])
def test_sorted_chunks_bound_every_partial(n, n_ranges, scan_chunks, counts):
    """The sorted path's chunks, whatever the skew: no partial adds more
    than MAX_CHUNK_ROWS rows (so integer payloads stay exact, every row in
    one segment too), the grid's slots hold every range's chunks, and the
    partials are no more than the scan path's n_ranges × scan_chunks."""
    chunk, slots = kseg.sorted_chunks(n, n_ranges, scan_chunks)
    assert 0 < chunk <= kseg.MAX_CHUNK_ROWS
    assert 0 < slots <= n_ranges * scan_chunks
    c = _counts(counts, n, n_ranges, np.random.default_rng(n_ranges))
    assert c.sum() == n
    assert int((-(-c // chunk)).sum()) <= slots


@pytest.mark.parametrize("case", sorted(LAUNCHES) + sorted(PATH_CASES)[:6])
def test_sorted_path_scratch_within_the_scan_paths(case, monkeypatch):
    """A sorted-path reduction's partials are no more than its items take
    on the scan path, and a launch's no more than on the scan path: only
    the sort areas (the list, n × 8 bytes, four counts a range and a word a
    chunk) come on top.  The scan-path reductions beside it are cut as in a
    launch of them alone."""
    if case in LAUNCHES:
        shapes, n = LAUNCHES[case]
    else:
        kind, S, width, n, _ = PATH_CASES[case]
        shapes = [kseg.Shape("hist", S, (width // 3, 1), width) if kind == "hist"
                  else kseg.Shape("seg", S, (1,) * width, width)]
    wave = lambda kernel, smem: 132  # noqa: E731
    lay = kseg.launch_layout(n, shapes, wave)
    sorted_grids = [g for g in lay.grids if g.sort_off >= 0]
    sort = sum(kseg.sort_words(n, g.n_items // g.blocks[1], g.blocks[0]) for g in sorted_grids)
    on_scan = [sh for sh, sub in zip(shapes, lay.layouts) if sub.mode < 2]
    alone = kseg.launch_layout(n, on_scan, wave) if on_scan else None
    monkeypatch.setattr(kseg, "SORTED_MIN_RANGES", 1 << 40)
    scan = kseg.launch_layout(n, shapes, wave)
    assert all(sub.mode < 2 for sub in scan.layouts)
    assert lay.scratch_numel - sort <= scan.scratch_numel
    outs = [o for o, _, _ in lay.outputs]
    for g in sorted_grids:
        i = outs.index(next(it for it in lay.items if it[17] == g.sort_off)[7])
        sub = lay.layouts[i]
        assert g.blocks[0] * g.blocks[1] * sub.part_stride <= sum(
            it[13] * it[15] for it in scan.items if it[7] == outs[i])
    if alone is not None:
        def cut(it):
            return it[:4] + it[5:7] + it[10:17]
        assert [cut(it) for it in lay.items if it[17] < 0] == [cut(it) for it in alone.items]


def test_reset_launches_clears_the_range_counter():
    """``ops.RANGE_REDUCTIONS`` is the counter the card's launches add to,
    and ``reset_launches`` clears it with the launch counts."""
    assert ops.RANGE_REDUCTIONS is kseg.RANGE_REDUCTIONS
    ops.RANGE_REDUCTIONS["sorted"] += 2
    ops.RANGE_REDUCTIONS["scan"] += 1
    ops.reset_launches()
    assert ops.RANGE_REDUCTIONS == {"scan": 0, "sorted": 0}


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

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
#: MAX_TILE_B, polyreg's one-segment 540 columns, and a 30-row scan
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
    "short": ([_seg(1, 55)] + [_seg(s, w) for s, w in [(2, 64), (4, 1), (4, 1),
                                                       (2, 64), (4, 1), (2, 64)]],
              30),
}


@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("case", sorted(LAUNCHES))
def test_launch_layout_covers_every_cell_once(case, per_sm):
    """Every (reduction, segment, accumulator column) cell in exactly one
    work item; a grid a partial kernel, its blocks within the shared-memory
    budget; each item's chunks covering the rows, none past MAX_CHUNK_ROWS;
    disjoint partials in scratch; the items grid by grid, each reduction in
    the mode its shape fits."""
    shapes, n = LAUNCHES[case]
    lay = kseg.launch_layout(n, shapes, lambda kernel, smem: per_sm * 132)
    assert len(lay.layouts) == len(shapes)
    grids = {g.kernel: g for g in lay.grids}
    assert len(grids) == len(lay.grids)
    cells = [np.zeros((sh.n_segments, sh.acc_width), np.int64) for sh in shapes]
    by_out = {off: i for i, (off, _, _) in enumerate(lay.outputs)}
    order, spans = [], []
    for it in lay.items:
        (s0, ns, c0, t, soff, kind, width, out, code, src0, nsrc, ncond,
         srows, nch, crows, pst, copies) = it
        i = by_out[out]
        sh, sub = shapes[i], lay.layouts[i]
        g = grids[kseg.kernel_of(sh, sub)]
        assert kind == kseg.KINDS[sh.kind] and width == sh.width
        assert nsrc == len(sh.parts) and src0 == code + 1
        assert ncond == (sh.parts[0] if sh.kind == "hist" else 0)
        cells[i][s0:s0 + ns, c0:c0 + t] += 1
        unit = 3 if sh.kind == "hist" else 1
        assert ns * t <= pst and c0 % unit == 0 and t % unit == 0
        assert copies == sub.copies >= 1
        assert nch <= g.n_chunks <= 65535 and 0 < crows <= min(g.chunk_rows, kseg.MAX_CHUNK_ROWS)
        assert (nch - 1) * crows < n <= nch * crows
        assert sub.smem_bytes <= g.smem_bytes <= kseg.SMEM_BYTES
        order.append(g.kernel)
        spans.append((soff, soff + nch * pst))
    assert all((c == 1).all() for c in cells)
    assert order == sorted(order)
    assert all(g.n_items == order.count(g.kernel) for g in lay.grids)
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] == lay.scratch_numel
    assert 0 < lay.combine_blocks <= kseg.COMBINE_BLOCKS
    for sh, sub in zip(shapes, lay.layouts):
        fits = (kseg.fits_one_block(sh.n_segments, sh.acc_width) if sh.kind == "seg"
                else sh.parts[0] <= kseg.THREADS
                and 4 * sh.n_segments * sh.width <= kseg.SMEM_BYTES)
        assert sub.mode == (0 if fits else 1)
    srcs = sum(1 + len(sh.parts) for sh in shapes)
    assert max(it[8] for it in lay.items) < srcs


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

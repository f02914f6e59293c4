"""CUDA kernel ``seg_aggregate``: ``out[s, a] = Σ_{seg[n]=s} payload[n, a]``;
the port of ``seg_aggregate_pallas`` (``repro/kernels/seg_aggregate.py:39``).

The device code (``csrc/seg_reduce.cuh``, entry point
``csrc/seg_aggregate.cu``) keeps the ``(S, A)`` accumulator in shared
memory: whole in one block where it fits, else cut into segment ranges, a
block each, which read the payload only of their own rows; a second kernel
sums the chunks' partial tiles in double.  A range finds its rows in one of
two ways, chosen by the reduction's shape alone (:func:`reduction_mode`):
below ``SORTED_MIN_RANGES`` ranges (the scan path) each range's blocks read
every code of their row chunk; at or above it (the sorted path) a pre-pass
counting-sorts the launch's rows by range once, and each block reads only
its range's slice of that list.  Ids outside ``[0, n_segments)`` contribute
nowhere, so no padding rows or sacrificial segment are needed, and the
payload may start at any float.

This module also holds the host side of every launch of that header, which
``fused_scan_block``, ``tree_hist`` and ``tree_hist_batched`` share: the
geometry as pure functions (:func:`fits_one_block`, :func:`fits_hist_block`,
:func:`segment_ranges`, :func:`column_tiles`, :func:`seg_layout`,
:func:`hist_layout`, :func:`reduction_mode`, :func:`seg_chunks`,
:func:`item_chunks`, :func:`sorted_chunks`, :func:`launch_layout`), so the
CPU tests reach it;
:func:`launch_plan`, which puts a launch's work items on the card; and
:func:`run`, which launches an entry point over a table of sources, each
read where it lies.  ``seg_aggregate`` is the launch of one reduction of
one payload part.  :data:`RANGE_REDUCTIONS` counts the range-mode
reductions the card runs, by path (``ops`` exports it and
``ops.reset_launches`` clears it).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

#: shared memory a block may use on sm_90 (227 KB, opt-in above 48 KB)
SMEM_BYTES = 232448
#: threads of a block of the partial pass (``kThreads`` in seg_reduce.cuh)
THREADS = 512
#: one-block mode: ring stages of whole rows (``kStagesA``), and the bytes
#: of codes and values a stage aims at
STAGES_A, STAGE_BYTES_A = 4, 16384
MIN_STAGE_ROWS, MAX_STAGE_ROWS = 32, 4096
#: range mode: codes a stage (``kStageRowsB``), and the rest of a block's
#: shared memory beside the accumulator: the stage's codes, the list of
#: its rows in range, (row, segment) each, a count a warp and the counting
#: sort's buckets, two a thread
STAGE_ROWS_B = 4096
FIXED_B = 4 * STAGE_ROWS_B + 8 * STAGE_ROWS_B + 4 * THREADS // 32 + 8 * THREADS
#: range mode: the fewest segment ranges of a reduction that takes the
#: sorted path (its launch's rows counting-sorted by range once, each block
#: reading only its range's rows) rather than the scan path (each range's
#: blocks reading every code of their chunk, which costs ranges x rows).
#: Set from both paths timed at 2^20 rows, 489 columns in parts, over 2 to
#: 13,170 ranges on an H100 (``tools/scan_ablation.py --ranges``, PERF.md):
#: the scan path the faster up to 192 ranges (19.1 ms against 20.4), the
#: sorted path from 256 (17.8 against 22.7; at 13,170, 24 against 725).
#: Histograms take it at the same count, though their crossover lies lower:
#: at a tree level's 90,936 buckets the sorted path was the faster from 49
#: ranges up (PERF.md)
SORTED_MIN_RANGES = 256
#: range mode: the widest column tile
MAX_TILE_B = 1024
#: most rows of a chunk: integer counts in a chunk's float32 partial stay
#: far below 2^24, where float32 adds of integers are exact
MAX_CHUNK_ROWS = 1 << 18
#: fewest rows of a chunk: a short scan spreads over the card down to this
MIN_CHUNK_ROWS = 32
#: int64 fields of a work item (``N_FIELDS`` in seg_reduce.cuh), and of a
#: grid as ``run`` takes it (``kGridInts``)
N_FIELDS, GRID_INTS = 22, 6
KINDS = {"seg": 0, "hist": 1}
#: the combine kernel (``kCombine*``): threads a block, groups of chunks a
#: block sums apart for an item of COMBINE_SPLIT chunks or more, most
#: blocks an item
COMBINE_THREADS, COMBINE_GROUPS, COMBINE_SPLIT, COMBINE_BLOCKS = 256, 8, 64, 4096


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
                 device: torch.device, contiguous: bool = True) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected a {ndim}-d {dtype} tensor, got "
                         f"{t.dim()}-d {t.dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _acc_bytes(n_segments: int, tile: int) -> int:
    return 16 * -(-n_segments * tile // 4)


def stage_rows_a(width: int) -> int:
    """One-block mode: rows of a ring stage, about ``STAGE_BYTES_A`` of
    codes and values, a multiple of 32."""
    rows = STAGE_BYTES_A // (4 * (width + 1)) // 32 * 32
    return max(MIN_STAGE_ROWS, min(MAX_STAGE_ROWS, rows))


def smem_a(n_segments: int, width: int) -> int:
    """One-block mode: the accumulator and ``STAGES_A`` stages."""
    return (_acc_bytes(n_segments, width)
            + 4 * STAGES_A * stage_rows_a(width) * (width + 1))


def fits_one_block(n_segments: int, width: int) -> bool:
    """Whether the whole accumulator and the ring fit one block, with a
    thread for every column."""
    return width <= THREADS and smem_a(n_segments, width) <= SMEM_BYTES


def fits_hist_block(n_segments: int, n_cond: int) -> bool:
    """Whether a histogram of ``n_cond`` conds runs in one block: a thread
    for every cond, the ``(n_segments, 3 n_cond)`` accumulator in shared
    memory."""
    return n_cond <= THREADS and _acc_bytes(n_segments, 3 * n_cond) <= SMEM_BYTES


def _even(total: int, parts: int) -> List[Tuple[int, int]]:
    """``(first, count)`` of ``parts`` runs of about equal size."""
    base, extra = divmod(total, parts)
    out, first = [], 0
    for i in range(parts):
        out.append((first, base + (i < extra)))
        first += base + (i < extra)
    return out


def column_tiles(width: int, unit: int = 1) -> List[Tuple[int, int]]:
    """Range mode: ``(first column, columns)`` tiles of at most
    ``MAX_TILE_B`` columns, each a whole number of ``unit`` columns (a
    histogram keeps a cond's three columns together)."""
    units, per = width // unit, MAX_TILE_B // unit
    return [(u0 * unit, k * unit) for u0, k in _even(units, -(-units // per))]


def range_segments(tile: int) -> int:
    """Range mode: the most segments of a range whose ``tile``-column
    accumulator fits a block beside the stage."""
    per = (SMEM_BYTES - FIXED_B) // (4 * tile) // 4 * 4
    if per < 1:
        raise ValueError(f"a {tile}-column tile does not fit one block")
    return per


def range_count(n_segments: int, tile: int) -> int:
    """Range mode: the fewest ranges of ``n_segments`` of at most
    :func:`range_segments` each."""
    return -(-n_segments // range_segments(tile))


def segment_ranges(n_segments: int, tile: int) -> List[Tuple[int, int]]:
    """Range mode: :func:`range_count` ``(first segment, segments)`` ranges
    of about equal size."""
    return _even(n_segments, range_count(n_segments, tile))


@dataclasses.dataclass(frozen=True)
class SegLayout:
    """The work items of one reduction, before the rows are cut."""

    mode: int                            # 0: one block, 1: ranges (scan path), 2: (sorted path)
    items: Tuple[Tuple[int, ...], ...]  # (seg0, n_seg, col0, tile, 0) a block
    smem_bytes: int
    stage_rows: int                      # one-block SEG: rows a stage
    part_stride: int                     # floats of one chunk's partial tile
    max_size: int                        # most n_seg * tile over the items
    copies: int = 1                      # one-block mode: accumulator copies
    n_ranges: int = 1                    # range mode: segment ranges (items range-major)


def range_layout(n_segments: int, width: int, unit: int = 1) -> SegLayout:
    """Range mode: an item for every (segment range, column tile of whole
    ``unit``s)."""
    tiles = column_tiles(width, unit)
    tile = max(t for _, t in tiles)
    ranges = segment_ranges(n_segments, tile)
    items = tuple((s0, ns, c0, t, 0) for s0, ns in ranges for c0, t in tiles)
    max_size = max(it[1] * it[3] for it in items)
    acc = _acc_bytes(max(ns for _, ns in ranges), tile)
    return SegLayout(mode=1, items=items,
                     smem_bytes=acc + FIXED_B, stage_rows=0,
                     part_stride=-(-max_size // 4) * 4, max_size=max_size,
                     n_ranges=len(ranges))


def seg_layout(n_segments: int, width: int) -> SegLayout:
    """One block for the whole ``(n_segments, width)`` accumulator where it
    fits beside its ring (in :func:`acc_copies` copies, or a copy a row slot
    where they fit half an SM beside a ring of at least ``MIN_STAGE_ROWS``
    rows a stage); else an item for every (segment range, column tile)."""
    if not fits_one_block(n_segments, width):
        return range_layout(n_segments, width)
    size, acc = n_segments * width, _acc_bytes(n_segments, width)
    rows, slots = stage_rows_a(width), THREADS // width
    own = (SMEM_BYTES // 2 - slots * acc) // (4 * STAGES_A * (width + 1)) // 32 * 32
    if own >= MIN_STAGE_ROWS:
        rows, k = min(rows, own), slots
    else:
        k = acc_copies(acc, 4 * STAGES_A * rows * (width + 1))
    return SegLayout(mode=0, items=((0, n_segments, 0, width, 0),),
                     smem_bytes=k * acc + 4 * STAGES_A * rows * (width + 1),
                     stage_rows=rows, part_stride=-(-size // 4) * 4,
                     max_size=size, copies=k)


def acc_copies(acc_bytes: int, other_bytes: int) -> int:
    """One-block mode: copies of an ``acc_bytes`` accumulator beside
    ``other_bytes`` of other shared memory, a copy for every few warps (a
    power of two up to a copy a warp, warp w adding into copy w mod k) while
    the block stays within half an SM's shared memory, so that two blocks
    share an SM; at least one."""
    k = 1
    while 2 * k <= THREADS // 32 and 2 * k * acc_bytes + other_bytes <= SMEM_BYTES // 2:
        k *= 2
    return k


def hist_layout(n_segments: int, n_cond: int) -> SegLayout:
    """A histogram of ``n_cond`` conds: one block (no ring, the accumulator
    in :func:`acc_copies` copies) where the ``(n_segments, 3 n_cond)``
    accumulator fits, with a thread for every cond; else segment ranges of
    whole conds."""
    width = 3 * n_cond
    acc = _acc_bytes(n_segments, width)
    if fits_hist_block(n_segments, n_cond):
        k = acc_copies(acc, 0)
        size = n_segments * width
        return SegLayout(mode=0, items=((0, n_segments, 0, width, 0),),
                         smem_bytes=k * acc, stage_rows=0,
                         part_stride=-(-size // 4) * 4, max_size=size,
                         copies=k)
    return range_layout(n_segments, width, 3)


def reduction_mode(kind: str, n_segments: int, acc_width: int) -> int:
    """How the card runs a reduction of ``acc_width`` accumulator columns
    (a histogram's ``3 N``), as :func:`launch_layout` lays it out: 0 in one
    block, 1 in segment ranges on the scan path, 2 on the sorted path (at
    ``SORTED_MIN_RANGES`` ranges or more).  The shape alone decides, not
    the rows."""
    if kind == "hist":
        if fits_hist_block(n_segments, acc_width // 3):
            return 0
        tile = max(t for _, t in column_tiles(acc_width, 3))
    else:
        if fits_one_block(n_segments, acc_width):
            return 0
        tile = max(t for _, t in column_tiles(acc_width))
    return 2 if range_count(n_segments, tile) >= SORTED_MIN_RANGES else 1


def sorted_chunks(n: int, n_ranges: int, scan_chunks: int) -> Tuple[int, int]:
    """The sorted path's ``(chunk_rows, slots)`` for a reduction of
    ``n_ranges`` ranges over ``n`` rows, whose items the scan path cuts into
    ``scan_chunks`` chunks each.  A chunk holds at most ``chunk_rows``
    listed rows, about twice a range's mean, so that a range of many rows
    (skewed keys, every row on one segment) spreads over blocks of at most
    that; never past ``MAX_CHUNK_ROWS``.  ``slots`` bounds the chunks of all
    ranges whatever their rows (Σ⌈c_r / chunk⌉ ≤ R + ⌊(n − R) / chunk⌋, and
    ≤ n): the grid, and the partials, which stay within the scan path's
    ``n_ranges × scan_chunks``."""
    extra = n_ranges * (scan_chunks - 1)
    least = (n - n_ranges) // (extra + 1) + 1 if n > n_ranges else 1
    chunk = min(MAX_CHUNK_ROWS, max(least, -(-2 * n // n_ranges)))
    return chunk, min(n, n_ranges + max(0, (n - n_ranges) // chunk))


def sort_words(n: int, n_ranges: int, slots: int) -> int:
    """Scratch words of a sorted-path reduction's sort area (``Sorted`` in
    seg_reduce.cuh): four counts a range, the (row, segment) list and a
    chunk's range for each of ``slots``, rounded up to 16 bytes."""
    return -(-(4 * n_ranges + 2 + 2 * n + slots) // 4) * 4


def seg_chunks(n: int, blocks_per_chunk: int,
               wave_blocks: int) -> Tuple[int, int]:
    """``(chunk_rows, n_chunks)``: as many chunks as fill one wave of
    ``wave_blocks`` blocks, or whole waves of them where a chunk would pass
    ``MAX_CHUNK_ROWS`` rows; no chunk shorter than ``MIN_CHUNK_ROWS`` rows
    where that leaves a choice, and none empty."""
    want = max(1, wave_blocks // blocks_per_chunk)
    chunks = -(-(-(-n // MAX_CHUNK_ROWS)) // want) * want
    chunks = max(1, min(chunks, -(-n // MIN_CHUNK_ROWS)))
    chunk_rows = -(-n // chunks)
    return chunk_rows, -(-n // chunk_rows)


class Shape(NamedTuple):
    """The static shape of one reduction of a launch.  ``kind`` "seg" sums
    payload parts of ``parts`` columns each, which follow one another in the
    accumulator, into ``width`` output columns (``sum(parts)`` unless some
    output column is named by no part and stays 0); "hist" forms cond ⊗
    [1, y, y²] from ``parts = (N, y_cols)``: N cond columns and a y part of
    1 column (y, the triple formed on chip) or 3 (the triple itself), into
    ``3 N`` output columns.  A tuple, so that a wrapper builds and hashes one
    cheaply on every call; :func:`launch_layout` checks it once a plan."""

    kind: str
    n_segments: int
    parts: Tuple[int, ...]
    width: int

    @property
    def acc_width(self) -> int:
        """Columns of the accumulator: the parts' (seg), the output's
        (hist)."""
        return sum(self.parts) if self.kind == "seg" else self.width

    @property
    def vals(self) -> int:
        """Floats a row holds for the reduction."""
        return sum(self.parts)


def check_shape(sh: Shape) -> None:
    ok = (sh.kind in KINDS and sh.n_segments > 0 and len(sh.parts) > 0
          and all(w > 0 for w in sh.parts))
    if sh.kind == "hist":
        ok = ok and (len(sh.parts) == 2 and sh.parts[1] in (1, 3)
                     and sh.width == 3 * sh.parts[0])
    else:
        ok = ok and sh.width >= sum(sh.parts)
    if not ok:
        raise ValueError(f"not a reduction's shape: {sh}")


def seg_shape(n_segments: int, width: int) -> Shape:
    """One reduction of one ``width``-column payload part."""
    return Shape("seg", n_segments, (width,), width)


@dataclasses.dataclass(frozen=True)
class Grid:
    """One partial grid of a launch, on the partial kernel ``kernel``
    (:func:`kernel_of`): its items, each over its own row chunks
    (:func:`item_chunks`), the most chunks and the longest chunk of any.  A
    sorted-path grid holds one reduction: its blocks are (a bound on the
    chunks of all its ranges, its column tiles), its chunks' rows listed
    rows, and its pre-pass keeps the sort area at ``sort_off``."""

    kernel: int
    n_items: int
    n_chunks: int
    chunk_rows: int
    smem_bytes: int
    wave_blocks: int             # blocks the card holds at once
    blocks: Tuple[int, int]      # the grid's blocks along x and y
    sort_off: int = -1           # sorted path: the sort area in scratch (floats)


@dataclasses.dataclass(frozen=True)
class Layout:
    """The work items of one launch of several reductions, before they go
    to the device, grid by grid."""

    shapes: Tuple[Shape, ...]
    layouts: Tuple[SegLayout, ...]           # one a reduction
    grids: Tuple[Grid, ...]                  # one a partial kernel present
    items: Tuple[Tuple[int, ...], ...]       # N_FIELDS ints an item
    scratch_numel: int
    combine_blocks: int                      # blocks an item of the combine grid
    outputs: Tuple[Tuple[int, int, int], ...]   # (offset, S, width) a reduction
    out_numel: int
    scratch_base: int                        # scratch's offset in the buffer: 16-byte aligned
    range_paths: Tuple[int, int]             # range-mode reductions: (scan, sorted) path


def shape_layout(sh: Shape) -> SegLayout:
    """The work items of one reduction."""
    if sh.kind == "hist":
        return hist_layout(sh.n_segments, sh.parts[0])
    return seg_layout(sh.n_segments, sh.acc_width)


def kernel_of(sh: Shape, lay: SegLayout) -> int:
    """The partial kernel a reduction's grid runs (``partial_kernel`` in
    seg_reduce.cuh): 0 one-block SEG, 1 segment-range SEG, 2 one-block
    HIST, 3 segment-range HIST, 4 sorted-path SEG, 5 sorted-path HIST."""
    return (0, 1, 4)[lay.mode] + (1 if lay.mode == 2 else 2) * (sh.kind == "hist")


def row_cost(sh: Shape, lay: SegLayout) -> float:
    """What a row costs a block of the reduction, to share one grid's wave
    among its items (:func:`item_chunks`): a one-block SEG block takes a
    ring stage at a time, at about the same time a stage; any other block
    reads the row's code and its share of the values."""
    if lay.mode == 0 and sh.kind == "seg":
        return 1 / lay.stage_rows
    return 1 + sh.vals / len(lay.items)


def item_chunks(n: int, weights: Sequence[float],
                wave_blocks: int) -> List[Tuple[int, int]]:
    """``(chunk_rows, n_chunks)`` of each item of one grid: items of equal
    ``weights`` (:func:`row_cost`) get :func:`seg_chunks`'s even share;
    unequal ones shares of the wave in proportion to their weights, so that
    the blocks of a cheap item take more rows and finish with the others.
    No chunk past ``MAX_CHUNK_ROWS`` rows, none shorter than
    ``MIN_CHUNK_ROWS`` where that leaves a choice, none empty."""
    if len(set(weights)) == 1:
        return [seg_chunks(n, len(weights), wave_blocks)] * len(weights)
    out = []
    for w in weights:
        chunks = max(1, int(wave_blocks * w / sum(weights)), -(-n // MAX_CHUNK_ROWS))
        chunks = max(1, min(chunks, -(-n // MIN_CHUNK_ROWS)))
        chunk_rows = -(-n // chunks)
        out.append((chunk_rows, -(-n // chunk_rows)))
    return out


def launch_layout(n: int, shapes: Sequence[Shape],
                  wave: Callable[[int, int], int]) -> Layout:
    """Lay out the items of one launch over ``n`` rows: each reduction's
    :func:`shape_layout`, its items in the grid of its partial kernel
    (:func:`kernel_of`; the grids run one after another on the stream, the
    reductions of a kernel side by side in one grid, which hides each
    one's latency behind the others'); each grid's wave of blocks,
    ``wave(kernel, smem_bytes)`` (the occupancy query on the card, times
    the SMs), shared among its items by :func:`item_chunks`.  A range-mode
    reduction of enough ranges (:func:`reduction_mode`) takes the sorted path
    in a grid of its own after the others, its partials within the scan
    path's (:func:`sorted_chunks`: its items chunked as if every range-mode
    reduction of the launch shared the scan path's grid), then its sort
    area in scratch, which lists a row by its int32 index: such a launch
    takes fewer than 2^31 rows.  Sources are numbered reduction by
    reduction: its codes, then its parts."""
    for sh in shapes:
        check_shape(sh)
    layouts = tuple(dataclasses.replace(lay, mode=2)
                    if lay.mode == 1 and lay.n_ranges >= SORTED_MIN_RANGES else lay
                    for lay in map(shape_layout, shapes))
    if n >= 1 << 31 and any(lay.mode == 2 for lay in layouts):
        raise ValueError(f"{n} rows: the sorted path lists a row by its int32 index, "
                         "so a launch takes fewer than 2^31")
    # the partial kernel of each reduction on the scan path
    scan_kernels = [min(lay.mode, 1) + 2 * (sh.kind == "hist")
                    for sh, lay in zip(shapes, layouts)]
    first_src = [0]
    for sh in shapes:
        first_src.append(first_src[-1] + 1 + len(sh.parts))
    out_off = [0]
    for sh in shapes:
        out_off.append(out_off[-1] + sh.n_segments * sh.width)

    def item(i, s0, ns, c0, t, scratch_off, n_chunks, chunk_rows, part_stride,
             copies, sort=(-1, 0, 0, 0, 0)):
        sh, lay = shapes[i], layouts[i]
        return (s0, ns, c0, t, scratch_off, KINDS[sh.kind], sh.width, out_off[i],
                first_src[i], first_src[i] + 1, len(sh.parts),
                sh.parts[0] if sh.kind == "hist" else 0, lay.stage_rows, n_chunks,
                chunk_rows, part_stride, copies, *sort)

    def chunked(mine, k):
        """The grid of kernel ``k`` over reductions ``mine``: its shared
        memory, its wave, and each item's (chunk_rows, n_chunks)."""
        smem = max(layouts[i].smem_bytes for i in mine)
        blocks = wave(k, smem)
        return smem, blocks, item_chunks(
            n, [row_cost(shapes[i], layouts[i]) for i in mine for _ in layouts[i].items],
            blocks)

    grids, rows, scratch = [], [], 0
    for k in sorted({kk for kk, lay in zip(scan_kernels, layouts) if lay.mode < 2}):
        mine = [i for i, kk in enumerate(scan_kernels) if kk == k and layouts[i].mode < 2]
        smem, blocks, per_item = chunked(mine, k)
        per_item = iter(per_item)
        most, longest, n_items = 0, 0, 0
        for i in mine:
            lay = layouts[i]
            for s0, ns, c0, t, _ in lay.items:
                chunk_rows, n_chunks = next(per_item)
                if n_chunks > 65535:
                    raise ValueError(f"{n} rows need {n_chunks} chunks, more than "
                                     "one launch takes (65535)")
                rows.append(item(i, s0, ns, c0, t, scratch, n_chunks, chunk_rows,
                                 lay.part_stride, lay.copies))
                scratch += n_chunks * lay.part_stride
                most, longest, n_items = max(most, n_chunks), max(longest, chunk_rows), n_items + 1
        grids.append(Grid(k, n_items, most, longest, smem, blocks, (n_items, most)))
    to_sort = sorted((i for i, lay in enumerate(layouts) if lay.mode == 2),
                     key=lambda i: kernel_of(shapes[i], layouts[i]))
    for i in to_sort:
        sh, lay = shapes[i], layouts[i]
        # the scan path's grid of every range-mode reduction of its kind
        mine = [j for j, kk in enumerate(scan_kernels)
                if kk == scan_kernels[i] and layouts[j].mode > 0]
        _, blocks, per_item = chunked(mine, scan_kernels[i])
        scan_chunks = per_item[sum(len(layouts[j].items) for j in mine[:mine.index(i)])][1]
        n_ranges = lay.n_ranges
        n_tiles = len(lay.items) // n_ranges
        chunk, slots = sorted_chunks(n, n_ranges, scan_chunks)
        partials, sort_off = scratch, scratch + slots * n_tiles * lay.part_stride
        for j, (s0, ns, c0, t, _) in enumerate(lay.items):
            rows.append(item(i, s0, ns, c0, t, partials + j % n_tiles * lay.part_stride,
                             -(-n // chunk), chunk, n_tiles * lay.part_stride, 1,
                             (sort_off, j // n_tiles, n_ranges, n_tiles, sh.n_segments)))
        scratch = sort_off + sort_words(n, n_ranges, slots)
        grids.append(Grid(kernel_of(sh, lay), len(lay.items), -(-n // chunk), chunk,
                          lay.smem_bytes, blocks, (slots, n_tiles), sort_off))
    # the combine kernel's blocks: COMBINE_THREADS partial words each, or a
    # COMBINE_GROUPS-th of that for an item of COMBINE_SPLIT chunks or more
    # (a sorted-path item: counted as one chunk, which most have)
    combine = max(-(-it[1] * it[3] * (COMBINE_GROUPS if it[13] >= COMBINE_SPLIT
                                      and it[17] < 0 else 1) // COMBINE_THREADS)
                  for it in rows)
    out_numel = out_off[-1]
    modes = [lay.mode for lay in layouts]
    return Layout(shapes=tuple(shapes), layouts=layouts, grids=tuple(grids),
                  items=tuple(rows), scratch_numel=scratch,
                  combine_blocks=min(combine, COMBINE_BLOCKS),
                  outputs=tuple((out_off[i], sh.n_segments, sh.width)
                                for i, sh in enumerate(shapes)),
                  out_numel=out_numel, scratch_base=-(-out_numel // 4) * 4,
                  range_paths=(modes.count(1), modes.count(2)))


@dataclasses.dataclass(frozen=True)
class Plan:
    """A :class:`Layout` whose items are on the device, and its grids as the
    entry points take them."""

    launch: Layout
    items: torch.Tensor          # (n_items, N_FIELDS) int64 on the device
    grid_args: ctypes.Array      # GRID_INTS int64 a grid (``run`` in seg_reduce.cuh)


@functools.lru_cache(maxsize=256)
def launch_plan(n: int, shapes: Tuple[Shape, ...], device: torch.device,
                lib=None) -> Plan:
    """The launch of ``shapes`` over ``n`` rows on ``device``: one wave of
    each grid's blocks (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` of
    ``lib``, the package's kernel library unless given).  Cached: the items
    are copied to the device once per shape."""
    from repro_torch.kernels._build import library

    lib = library() if lib is None else lib
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    @functools.lru_cache(maxsize=None)
    def wave(kernel: int, smem: int) -> int:
        with torch.cuda.device(device):
            per_sm = lib.seg_reduce_blocks_per_sm(kernel, smem)
        if per_sm < 1:
            raise RuntimeError(f"seg_reduce: {smem}-byte blocks of kernel "
                               f"{kernel} do not schedule (occupancy query: "
                               f"{per_sm})")
        return per_sm * sms

    lay = launch_layout(n, shapes, wave)
    # copied from pinned memory on the stream, so that a new plan amid a
    # pass does not wait for the card to drain
    return Plan(launch=lay,
                items=torch.tensor(lay.items, dtype=torch.int64).pin_memory().to(
                    device, non_blocking=True),
                grid_args=(ctypes.c_int64 * (GRID_INTS * len(lay.grids)))(*[
                    v for g in lay.grids
                    for v in (g.kernel, g.n_items, *g.blocks, g.smem_bytes, g.sort_off)]))


def seg_plan(n: int, n_segments: int, width: int, device: torch.device,
             lib=None) -> Plan:
    """The launch of one reduction of one ``width``-column payload."""
    return launch_plan(n, (seg_shape(n_segments, width),), device, lib)


def source(t: torch.Tensor, col0: int = 0, ocol: int = 0,
           ostride: int = 1) -> Tuple[int, ...]:
    """The source-table row of a (n,) or (n, w) tensor, read where it lies:
    pointer, row and column strides (elements), first accumulator column,
    width, first output column and output column stride (a HIST cond part:
    the output strides of a segment and of a cond)."""
    cs, w = (t.stride(1), t.shape[1]) if t.dim() == 2 else (0, 1)
    return (t.data_ptr(), t.stride(0), cs, col0, w, ocol, ostride)


#: range-mode reductions the card has run, by path: ``scan`` (each range
#: reads every code of its chunk) or ``sorted`` (rows counting-sorted by
#: range first); a plain counter, as ``ops.LAUNCHES``
RANGE_REDUCTIONS = {"scan": 0, "sorted": 0}

#: source tables kept on the card, by content: a launch whose tensors lie
#: where an earlier one's did (a loop over row blocks of one shape, whose
#: buffers the caching allocator hands out again) copies nothing
_TABLES: "collections.OrderedDict[tuple, torch.Tensor]" = collections.OrderedDict()
TABLES_KEPT = 256


def source_table(sources: Sequence[Tuple[int, ...]],
                 device: torch.device) -> torch.Tensor:
    """The (n_srcs, 7) int64 table of ``sources`` on ``device``: kept from
    an earlier launch of the same table, else copied from pinned memory on
    the current stream (a table holds pointers and strides only, so equal
    tables are interchangeable)."""
    key = (device, tuple(sources))
    table = _TABLES.get(key)
    if table is None:
        table = torch.tensor(sources, dtype=torch.int64).pin_memory().to(
            device, non_blocking=True)
        _TABLES[key] = table
        if len(_TABLES) > TABLES_KEPT:
            _TABLES.popitem(last=False)
    else:
        _TABLES.move_to_end(key)
    return table


def run(entry, plan: Plan, sources: Sequence[Tuple[int, ...]], n: int,
        device: torch.device, zero: bool = False) -> Tuple[torch.Tensor, ...]:
    """Launch ``entry`` of a kernel library on the current stream over the
    ``sources`` table (:func:`source_table`), and split the output per
    reduction.  ``zero``: some output column is named by no part and must
    read 0.  The output and the scratch are one allocation, the outputs
    views of its head.  Counts the launch's range-mode reductions in
    :data:`RANGE_REDUCTIONS`."""
    lay = plan.launch
    buf = torch.empty(lay.scratch_base + lay.scratch_numel, dtype=torch.float32,
                      device=device)
    if zero:
        buf[:lay.out_numel].zero_()
    table = source_table(sources, device)
    ptr = buf.data_ptr()
    args = (plan.items.data_ptr(), table.data_ptr(), n, plan.grid_args,
            len(lay.grids), lay.combine_blocks, ptr + 4 * lay.scratch_base, ptr,
            # the raw handle: no Stream object built (a short launch's time
            # is mostly its wrapper's host time)
            torch._C._cuda_getCurrentRawStream(device.index))
    if device.index == torch.cuda.current_device():
        err = entry(*args)
    else:
        with torch.cuda.device(device):
            err = entry(*args)
    if err != 0:
        raise RuntimeError(
            f"{entry.__name__} launch failed with CUDA error {err} (n={n}, "
            f"shapes={lay.shapes}, grids={lay.grids})")
    scan, srt = lay.range_paths
    RANGE_REDUCTIONS["scan"] += scan
    RANGE_REDUCTIONS["sorted"] += srt
    return tuple(buf.as_strided((s, w), (w, 1), o) for o, s, w in lay.outputs)


def seg_aggregate_cuda(seg: torch.Tensor, payload: torch.Tensor,
                       n_segments: int, lib=None) -> torch.Tensor:
    """``seg`` (n,) int32 and ``payload`` (n, A) float32, contiguous on one
    CUDA device (at any float offset); returns (n_segments, A) float32.
    ``lib``: a kernel library other than the package's, built from other
    sources of the same entry points (``tools/scan_ablation.py``)."""
    from repro_torch.kernels._build import library

    device = seg.device
    check_tensor("seg", seg, torch.int32, 1, device)
    check_tensor("payload", payload, torch.float32, 2, device)
    n, width = payload.shape
    if seg.shape[0] != n or n == 0 or width == 0 or n_segments <= 0:
        raise ValueError(f"seg {tuple(seg.shape)} and payload "
                         f"{tuple(payload.shape)} need the same, non-zero "
                         f"rows, and a column and a segment ({n_segments})")
    lib = library() if lib is None else lib
    plan = seg_plan(n, n_segments, width, device, lib)
    (out,) = run(lib.seg_aggregate, plan, [source(seg), source(payload)], n,
                 device)
    return out

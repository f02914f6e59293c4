"""CUDA kernel ``seg_aggregate``: ``out[s, a] = Σ_{seg[n]=s} payload[n, a]``;
the port of ``seg_aggregate_pallas`` (``repro/kernels/seg_aggregate.py:39``).

The device code (``csrc/seg_reduce.cuh``, entry point
``csrc/seg_aggregate.cu``) keeps the ``(S, A)`` accumulator in shared
memory: whole in one block where it fits, else cut into segment ranges, a
block each, which read every code of their row chunk but the payload only of
their own rows; a second kernel sums the chunks' partial tiles in double.
Ids outside ``[0, n_segments)`` contribute nowhere, so no padding rows or
sacrificial segment are needed, and the payload may start at any float.

This module also holds the host side of every launch of that header, which
``fused_scan_block``, ``tree_hist`` and ``tree_hist_batched`` share: the
geometry as pure functions (:func:`fits_one_block`,
:func:`segment_ranges`, :func:`column_tiles`, :func:`seg_layout`,
:func:`hist_layout`, :func:`seg_chunks`, :func:`item_chunks`,
:func:`launch_layout`), so the CPU tests reach it;
:func:`launch_plan`, which puts a launch's work items on the card; and
:func:`run`, which launches an entry point over a table of sources, each
read where it lies.  ``seg_aggregate`` is the launch of one reduction of
one payload part.
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
#: range mode: the widest column tile
MAX_TILE_B = 1024
#: most rows of a chunk: integer counts in a chunk's float32 partial stay
#: far below 2^24, where float32 adds of integers are exact
MAX_CHUNK_ROWS = 1 << 18
#: fewest rows of a chunk: a short scan spreads over the card down to this
MIN_CHUNK_ROWS = 32
#: int64 fields of a work item (``N_FIELDS`` in seg_reduce.cuh)
N_FIELDS = 17
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


def segment_ranges(n_segments: int, tile: int) -> List[Tuple[int, int]]:
    """Range mode: the fewest ``(first segment, segments)`` ranges of
    about equal size, each small enough that its ``tile``-column
    accumulator fits a block beside the stage."""
    per = (SMEM_BYTES - FIXED_B) // (4 * tile) // 4 * 4
    if per < 1:
        raise ValueError(f"a {tile}-column tile does not fit one block")
    return _even(n_segments, -(-n_segments // per))


@dataclasses.dataclass(frozen=True)
class SegLayout:
    """The work items of one reduction, before the rows are cut."""

    mode: int                            # 0: one block, 1: segment ranges
    items: Tuple[Tuple[int, ...], ...]  # (seg0, n_seg, col0, tile, 0) a block
    smem_bytes: int
    stage_rows: int                      # one-block SEG: rows a stage
    part_stride: int                     # floats of one chunk's partial tile
    max_size: int                        # most n_seg * tile over the items
    copies: int = 1                      # one-block mode: accumulator copies


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
                     part_stride=-(-max_size // 4) * 4, max_size=max_size)


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
    if n_cond <= THREADS and acc <= SMEM_BYTES:
        k = acc_copies(acc, 0)
        size = n_segments * width
        return SegLayout(mode=0, items=((0, n_segments, 0, width, 0),),
                         smem_bytes=k * acc, stage_rows=0,
                         part_stride=-(-size // 4) * 4, max_size=size,
                         copies=k)
    return range_layout(n_segments, width, 3)


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
    (:func:`item_chunks`), the most chunks and the longest chunk of any."""

    kernel: int
    n_items: int
    n_chunks: int
    chunk_rows: int
    smem_bytes: int
    wave_blocks: int             # blocks the card holds at once


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

    @property
    def out_numel(self) -> int:
        off, s, w = self.outputs[-1]
        return off + s * w


def shape_layout(sh: Shape) -> SegLayout:
    """The work items of one reduction."""
    if sh.kind == "hist":
        return hist_layout(sh.n_segments, sh.parts[0])
    return seg_layout(sh.n_segments, sh.acc_width)


def kernel_of(sh: Shape, lay: SegLayout) -> int:
    """The partial kernel a reduction's grid runs (``partial_kernel`` in
    seg_reduce.cuh): 0 one-block SEG, 1 segment-range SEG, 2 one-block
    HIST, 3 segment-range HIST."""
    return lay.mode + 2 * (sh.kind == "hist")


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
    the SMs), shared among its items by :func:`item_chunks`.  Sources are
    numbered reduction by reduction: its codes, then its parts."""
    for sh in shapes:
        check_shape(sh)
    layouts = tuple(shape_layout(sh) for sh in shapes)
    kernels = [kernel_of(sh, lay) for sh, lay in zip(shapes, layouts)]
    first_src = [0]
    for sh in shapes:
        first_src.append(first_src[-1] + 1 + len(sh.parts))
    out_off = [0]
    for sh in shapes:
        out_off.append(out_off[-1] + sh.n_segments * sh.width)
    grids, rows, scratch = [], [], 0
    for k in sorted(set(kernels)):
        mine = [i for i, kk in enumerate(kernels) if kk == k]
        smem = max(layouts[i].smem_bytes for i in mine)
        blocks = wave(k, smem)
        per_item = iter(item_chunks(
            n, [row_cost(shapes[i], layouts[i]) for i in mine for _ in layouts[i].items],
            blocks))
        most, longest, n_items = 0, 0, 0
        for i in mine:
            sh, lay = shapes[i], layouts[i]
            for s0, ns, c0, t, _ in lay.items:
                chunk_rows, n_chunks = next(per_item)
                if n_chunks > 65535:
                    raise ValueError(f"{n} rows need {n_chunks} chunks, more than "
                                     "one launch takes (65535)")
                rows.append((
                    s0, ns, c0, t, scratch, KINDS[sh.kind], sh.width, out_off[i],
                    first_src[i], first_src[i] + 1, len(sh.parts),
                    sh.parts[0] if sh.kind == "hist" else 0,
                    lay.stage_rows, n_chunks, chunk_rows, lay.part_stride, lay.copies))
                scratch += n_chunks * lay.part_stride
                most, longest, n_items = max(most, n_chunks), max(longest, chunk_rows), n_items + 1
        grids.append(Grid(k, n_items, most, longest, smem, blocks))
    # the combine kernel's blocks: COMBINE_THREADS partial words each, or a
    # COMBINE_GROUPS-th of that for an item of COMBINE_SPLIT chunks or more
    combine = max(-(-it[1] * it[3] * (COMBINE_GROUPS if it[13] >= COMBINE_SPLIT else 1)
                    // COMBINE_THREADS) for it in rows)
    return Layout(shapes=tuple(shapes), layouts=layouts, grids=tuple(grids),
                  items=tuple(rows), scratch_numel=scratch,
                  combine_blocks=min(combine, COMBINE_BLOCKS),
                  outputs=tuple((out_off[i], sh.n_segments, sh.width)
                                for i, sh in enumerate(shapes)))


@dataclasses.dataclass(frozen=True)
class Plan:
    """A :class:`Layout` whose items are on the device, and its grids as the
    entry points take them."""

    launch: Layout
    items: torch.Tensor          # (n_items, N_FIELDS) int64 on the device
    grid_args: ctypes.Array      # (kernel, items, chunks, shared memory) a grid


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
                grid_args=(ctypes.c_int * (4 * len(lay.grids)))(*[
                    v for g in lay.grids
                    for v in (g.kernel, g.n_items, g.n_chunks, g.smem_bytes)]))


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
    views of its head."""
    lay = plan.launch
    buf = torch.empty(lay.out_numel + lay.scratch_numel, dtype=torch.float32,
                      device=device)
    if zero:
        buf[:lay.out_numel].zero_()
    table = source_table(sources, device)
    ptr = buf.data_ptr()
    args = (plan.items.data_ptr(), table.data_ptr(), n, plan.grid_args,
            len(lay.grids), lay.combine_blocks, ptr + 4 * lay.out_numel, ptr,
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

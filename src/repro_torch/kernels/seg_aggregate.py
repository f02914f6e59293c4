"""CUDA kernel ``seg_aggregate``: ``out[s, a] = Σ_{seg[n]=s} payload[n, a]``;
the port of ``seg_aggregate_pallas`` (``repro/kernels/seg_aggregate.py:39``).

The device code (``csrc/seg_reduce.cuh``, entry point
``csrc/seg_aggregate.cu``) keeps the ``(S, A)`` accumulator in shared
memory: whole in one block where it fits, else cut into segment ranges, a
block each, which read every code of their row chunk but the payload only of
their own rows; a second kernel sums the chunks' partial tiles in double.
This module holds the host-side geometry as pure functions
(:func:`fits_one_block`, :func:`segment_ranges`, :func:`column_tiles`,
:func:`seg_layout`, :func:`seg_chunks`), so the CPU tests reach it.  Ids
outside ``[0, n_segments)`` contribute nowhere, so no padding rows or
sacrificial segment are needed, and the payload may start at any float.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import torch

from repro_torch.kernels.fused_scan import check_tensor

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
#: int64 fields of a work item (``N_FIELDS``): first segment, segments,
#: first column, columns, scratch offset
N_FIELDS = 5


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


def column_tiles(width: int) -> List[Tuple[int, int]]:
    """Range mode: ``(first column, columns)`` tiles of at most
    ``MAX_TILE_B`` columns."""
    return _even(width, -(-width // MAX_TILE_B))


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
    stage_rows: int                      # one-block mode: rows a stage
    part_stride: int                     # floats of one chunk's partial tile
    max_size: int                        # most n_seg * tile over the items


def seg_layout(n_segments: int, width: int) -> SegLayout:
    """One block for the whole accumulator where it fits; else an item
    for every (segment range, column tile)."""
    if fits_one_block(n_segments, width):
        size = n_segments * width
        return SegLayout(mode=0, items=((0, n_segments, 0, width, 0),),
                         smem_bytes=smem_a(n_segments, width),
                         stage_rows=stage_rows_a(width),
                         part_stride=-(-size // 4) * 4, max_size=size)
    tiles = column_tiles(width)
    tile = max(t for _, t in tiles)
    ranges = segment_ranges(n_segments, tile)
    items = tuple((s0, ns, c0, t, 0) for s0, ns in ranges for c0, t in tiles)
    max_size = max(it[1] * it[3] for it in items)
    acc = _acc_bytes(max(ns for _, ns in ranges), tile)
    return SegLayout(mode=1, items=items,
                     smem_bytes=acc + FIXED_B, stage_rows=0,
                     part_stride=-(-max_size // 4) * 4, max_size=max_size)


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


@dataclasses.dataclass(frozen=True)
class SegPlan:
    layout: SegLayout
    items: torch.Tensor          # (n_items, N_FIELDS) int64 on the device
    wave_blocks: int             # blocks the card holds at once
    chunk_rows: int
    n_chunks: int
    scratch_numel: int


@functools.lru_cache(maxsize=256)
def seg_plan(n: int, n_segments: int, width: int, device: torch.device,
             lib=None) -> SegPlan:
    """The launch of one reduction on ``device``: one wave of its blocks
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` of ``lib``, the
    package's kernel library unless given).  Cached: the items tensor is
    copied to the device once per shape."""
    from repro_torch.kernels._build import library

    layout = seg_layout(n_segments, width)
    with torch.cuda.device(device):
        per_sm = (library() if lib is None else lib).seg_aggregate_blocks_per_sm(
            layout.mode, layout.smem_bytes)
    if per_sm < 1:
        raise RuntimeError(f"seg_aggregate: {layout.smem_bytes}-byte blocks "
                           f"do not schedule (occupancy query: {per_sm})")
    wave = per_sm * torch.cuda.get_device_properties(device).multi_processor_count
    n_items = len(layout.items)
    chunk_rows, n_chunks = seg_chunks(n, n_items, wave)
    if n_chunks > 65535:
        raise ValueError(f"{n} rows need {n_chunks} chunks, more than one "
                         "launch takes (65535)")
    span = n_chunks * layout.part_stride
    items = [list(it[:4]) + [i * span] for i, it in enumerate(layout.items)]
    return SegPlan(layout=layout,
                   items=torch.tensor(items, dtype=torch.int64, device=device),
                   wave_blocks=wave, chunk_rows=chunk_rows,
                   n_chunks=n_chunks, scratch_numel=n_items * span)


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
    lay = plan.layout
    out = torch.empty((n_segments, width), dtype=torch.float32, device=device)
    scratch = torch.empty(plan.scratch_numel, dtype=torch.float32,
                          device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.seg_aggregate(
            seg.data_ptr(), n, payload.data_ptr(), width,
            plan.items.data_ptr(), lay.mode, len(lay.items), plan.n_chunks,
            plan.chunk_rows, lay.part_stride, lay.stage_rows,
            lay.max_size, lay.smem_bytes, scratch.data_ptr(), out.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"seg_aggregate launch failed with CUDA error "
                           f"{err} (n={n}, S={n_segments}, A={width}, "
                           f"smem={lay.smem_bytes} B)")
    return out

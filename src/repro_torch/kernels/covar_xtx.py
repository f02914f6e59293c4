"""CUDA kernel ``covar_xtx``: ``C = Xᵀ·diag(w)·X``, the covar batch as one
blocked product over the gathered feature matrix; the port of
``covar_xtx_pallas`` (``repro/kernels/covar_xtx.py:41``).

The device code (``csrc/covar_xtx.cu``) cuts the padded upper triangle of
``C`` into 64 × 48 pieces that three warpgroups multiply on the tensor cores
in 3xTF32 (``wgmma``), fed by a ring of ``cp.async`` stages.  A block takes
a row chunk and a group of at most six consecutive pieces: the whole
triangle up to F = 144.  A second kernel sums the chunks' pieces in a fixed
order in double.  This module mirrors its geometry as
pure functions (:func:`pieces`, :func:`groups`, :func:`smem_bytes`,
:func:`ring_stages`, :func:`step_rows`, :func:`chunking`), so the CPU tests
reach it.  The TPU kernel's ``block_rows`` (its row grid), ``interpret``
and ``feature_align`` have no counterpart: any ``n`` and any ``F`` up to
:data:`MAX_FEATURES` go in as they are, with no padding rows or columns, at
any float offset.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import torch

from repro_torch.kernels.fused_scan import check_tensor

#: rows a block stages per step (``kRows`` in covar_xtx.cu): 48, 32 or 16
#: (:func:`step_rows`).  Fewer, longer steps pay the step's barriers and
#: waits less often
STEP_ROWS, LONG_STEP_ROWS, SHORT_STEP_ROWS = 32, 48, 16
#: rows and columns of a piece of the triangle (``kM``, ``kN``)
PIECE_ROWS, PIECE_COLS = 64, 48
#: pieces a block's warpgroups hold (``kGroup``: 3 warpgroups, 2 each)
MAX_PIECES = 3 * 2
#: most operand rows (A and B) of a group (``kMaxOperandRows``): those of
#: F = 144's one group, 192 + 176
MAX_OPERAND_ROWS = 368
#: fewest and most ring stages of raw rows (``launch<2..4, rows>``)
MIN_STAGES, MAX_STAGES = 2, 4
#: shared memory a block may use on sm_90 (227 KB, opt-in above 48 KB)
SMEM_BYTES = 232448
#: most rows of one chunk: a 0/1 column's partial sums stay below 2^24,
#: where float32 adds of integers are exact
MAX_CHUNK_ROWS = 1 << 16
#: grid limit of a launch
MAX_CHUNKS = 2 ** 31 - 1


def pieces(f: int) -> List[Tuple[int, int]]:
    """``(first row, first column)`` of each piece of the padded upper
    triangle of an ``(f, f)`` output: each 64-row band from its diagonal
    on, in 48-column steps, band by band."""
    out = []
    for m0 in range(0, f, PIECE_ROWS):
        out += [(m0, n0) for n0 in range(m0, f, PIECE_COLS)]
    return out


class Group(NamedTuple):
    """Pieces ``first .. first + count - 1`` of :func:`pieces` and the
    columns of ``C`` the block's operands hold: A rows ``a_lo .. a_lo + a_n
    - 1``, B rows ``b_lo .. b_lo + b_n - 1`` (``Group`` in covar_xtx.cu)."""

    first: int
    count: int
    a_lo: int
    a_n: int
    b_lo: int
    b_n: int


def groups(f: int) -> List[Group]:
    """The grid's second axis: pieces join a group in order while it holds
    fewer than ``MAX_PIECES`` and its operands (A: whole bands from the
    first piece's to the last's; B: from the least column to the last
    piece's end) stay within ``MAX_OPERAND_ROWS`` rows.  F <= 144 is one
    group."""
    out, g = [], None
    for index, (m0, n0) in enumerate(pieces(f)):
        if g is not None and g.count < MAX_PIECES:
            b_lo = min(g.b_lo, n0)
            b_hi = max(g.b_lo + g.b_n, n0 + PIECE_COLS)
            a_n = m0 + PIECE_ROWS - g.a_lo
            if a_n + b_hi - b_lo <= MAX_OPERAND_ROWS:
                g = Group(g.first, g.count + 1, g.a_lo, a_n, b_lo, b_hi - b_lo)
                continue
        if g is not None:
            out.append(g)
        g = Group(index, 1, m0, PIECE_ROWS, n0, PIECE_COLS)
    return out + [g]


def operand_rows(f: int) -> int:
    """The most operand rows (A and B) a group holds in shared memory."""
    return max(g.a_n + g.b_n for g in groups(f))


def _stage_bytes(f: int, rows: int) -> int:
    """A raw ring stage: ``rows`` rows behind up to 3 floats of alignment
    shift, rounded up to 4 floats, then ``rows`` of w."""
    return 4 * (-(-(rows * f + 3) // 4) * 4 + rows)


def smem_bytes(f: int, stages: int, rows: int = STEP_ROWS) -> int:
    """Two split buffers (A and B, high and low parts, ``rows`` floats a
    row) and ``stages`` raw stages."""
    return 2 * 2 * operand_rows(f) * rows * 4 + stages * _stage_bytes(f, rows)


def ring_stages(f: int, rows: int = STEP_ROWS) -> int:
    """The most ring stages of ``rows`` rows, from ``MIN_STAGES`` up to
    ``MAX_STAGES``, that fit a block's shared memory; 0 when none does."""
    return max((s for s in range(MIN_STAGES, MAX_STAGES + 1)
                if smem_bytes(f, s, rows) <= SMEM_BYTES), default=0)


def step_rows(f: int) -> int:
    """Rows a step: ``LONG_STEP_ROWS`` up to F = 96 and ``STEP_ROWS`` up to
    F = 192 where two ring stages of them fit (the split's task registers
    hold that many columns in such steps: ``kMaxCols``), else
    ``SHORT_STEP_ROWS``."""
    for rows, widest in ((LONG_STEP_ROWS, 96), (STEP_ROWS, 192)):
        if f <= widest and ring_stages(f, rows):
            return rows
    return SHORT_STEP_ROWS


#: the widest x the kernel takes: two ring stages of 16-row steps fit beside
#: split buffers of ``MAX_OPERAND_ROWS`` rows.  A stage grows by 4 * 16
#: bytes a column
_SHORT_SPLIT = 2 * 2 * MAX_OPERAND_ROWS * SHORT_STEP_ROWS * 4
MAX_FEATURES = ((SMEM_BYTES - _SHORT_SPLIT - MIN_STAGES * _stage_bytes(0, SHORT_STEP_ROWS))
                // (MIN_STAGES * 4 * SHORT_STEP_ROWS))


def chunking(n: int, wave: int) -> Tuple[int, int]:
    """``(chunk_rows, n_chunks)`` for ``n`` rows: at least ``wave`` chunks
    (the blocks the card holds at once, over the groups of pieces), each a
    whole number of 32-row steps and at most ``MAX_CHUNK_ROWS`` rows, and
    never an empty chunk."""
    chunks = max(wave, -(-n // MAX_CHUNK_ROWS))
    chunks = max(1, min(chunks, -(-n // STEP_ROWS)))
    chunk_rows = max(STEP_ROWS, -(-n // chunks))
    chunk_rows = -(-chunk_rows // STEP_ROWS) * STEP_ROWS
    return chunk_rows, max(1, -(-n // chunk_rows))


@functools.lru_cache(maxsize=None)
def _wave(device: torch.device, stages: int, rows: int, smem: int, lib) -> int:
    """Blocks of the partial pass the card holds at once: a grid of one full
    wave leaves no SM idle on a last, partial wave."""
    with torch.cuda.device(device):
        per_sm = lib.covar_xtx_blocks_per_sm(stages, rows, smem)
    if per_sm < 1:
        raise RuntimeError("covar_xtx: occupancy query failed")
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


def covar_xtx_cuda(x: torch.Tensor, w: torch.Tensor, lib=None) -> torch.Tensor:
    """``x`` (n, F) float32 and ``w`` (n,) float32, contiguous on one CUDA
    device, ``F`` at most :data:`MAX_FEATURES`; returns the (F, F) float32
    ``C[f, g] = Σ_n w[n]·x[n, f]·x[n, g]`` (``n`` may be 0: C is then
    zero).  ``lib``: a kernel library other than the package's, built from
    other sources of the same entry points (``tools/scan_ablation.py``)."""
    from repro_torch.kernels._build import library

    lib = library() if lib is None else lib
    device = x.device
    check_tensor("x", x, torch.float32, 2, device)
    check_tensor("w", w, torch.float32, 1, device)
    n, f = x.shape
    if w.shape[0] != n:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} need "
                         "the same rows")
    if not 1 <= f <= MAX_FEATURES:
        raise ValueError(f"x has {f} columns; the kernel takes 1 to "
                         f"{MAX_FEATURES}")
    rows = step_rows(f)
    stages = ring_stages(f, rows)
    smem = smem_bytes(f, stages, rows)
    n_groups = len(groups(f))
    chunk_rows, n_chunks = chunking(
        n, max(1, _wave(device, stages, rows, smem, lib) // n_groups))
    out = torch.empty((f, f), dtype=torch.float32, device=device)
    scratch = torch.empty(n_chunks * len(pieces(f)) * PIECE_ROWS * PIECE_COLS,
                          dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.covar_xtx(x.data_ptr(), w.data_ptr(), n, f, chunk_rows,
                            n_chunks, stages, rows, smem, scratch.data_ptr(),
                            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"covar_xtx launch failed with CUDA error {err} "
                           f"(n={n}, F={f}, chunks={n_chunks} x {n_groups} "
                           f"groups, stages={stages} of {rows} rows, "
                           f"smem={smem} B)")
    return out

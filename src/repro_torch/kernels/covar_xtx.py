"""CUDA kernel ``covar_xtx``: ``C = Xᵀ·diag(w)·X``, the covar batch as one
blocked product over the gathered feature matrix; the port of
``covar_xtx_pallas`` (``repro/kernels/covar_xtx.py:41``).

The device code (``csrc/covar_xtx.cu``) computes the upper triangle of
``C`` in 32 × 32 tiles, one block per (tile pair, row chunk), and a second
kernel sums the chunks' partial tiles in a fixed order in double.  The TPU
kernel's ``block_rows`` (its row grid), ``interpret`` and ``feature_align``
have no counterpart: any ``n`` and any ``F`` go in as they are, with no
padding rows and no padding columns.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels.fused_scan import check_tensor

#: side of the output tiles (``kTile`` in covar_xtx.cu)
TILE = 32
#: rows a block stages per step (``kRows``)
STEP_ROWS = 32
#: threads per block of the partial pass (``kThreads``)
THREADS = 64
#: most rows of one chunk: a 0/1 column's partial sums stay below 2^24,
#: where float32 adds of integers are exact
MAX_CHUNK_ROWS = 1 << 16
#: grid.y limit of a launch
MAX_CHUNKS = 65535


def tile_pairs(f: int) -> int:
    """Upper-triangle tile pairs ``(ti ≤ tj)`` of an ``(f, f)`` output."""
    nt = -(-f // TILE)
    return nt * (nt + 1) // 2


def chunking(n: int, f: int, wave: int) -> Tuple[int, int]:
    """``(chunk_rows, n_chunks)`` for ``n`` rows: enough chunks that the
    grid fills ``wave`` blocks (the blocks the card holds at once), each
    chunk a whole number of staged row steps and at most
    ``MAX_CHUNK_ROWS`` rows, and never an empty chunk."""
    want = max(1, wave // tile_pairs(f))
    chunks = max(1, min(want, -(-n // STEP_ROWS)))
    chunk_rows = -(-max(n, 1) // chunks)
    chunk_rows = min(MAX_CHUNK_ROWS, -(-chunk_rows // STEP_ROWS) * STEP_ROWS)
    return chunk_rows, max(1, -(-n // chunk_rows))


@functools.lru_cache(maxsize=None)
def _wave(device: torch.device) -> int:
    """Blocks of the partial pass the card holds at once: a grid of one full
    wave leaves no SM idle on a last, partial wave."""
    from repro_torch.kernels._build import library

    with torch.cuda.device(device):
        per_sm = library().covar_xtx_blocks_per_sm()
    if per_sm < 1:
        raise RuntimeError("covar_xtx: occupancy query failed")
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


def covar_xtx_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` (n, F) float32 and ``w`` (n,) float32, contiguous on one CUDA
    device; returns the (F, F) float32 ``C[f, g] = Σ_n w[n]·x[n, f]·x[n, g]``
    (``n`` may be 0: C is then zero)."""
    from repro_torch.kernels._build import library

    device = x.device
    check_tensor("x", x, torch.float32, 2, device)
    check_tensor("w", w, torch.float32, 1, device)
    n, f = x.shape
    if w.shape[0] != n:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} need "
                         "the same rows")
    if f == 0:
        raise ValueError("x needs at least one column")
    chunk_rows, n_chunks = chunking(n, f, _wave(device))
    if n_chunks > MAX_CHUNKS:
        raise ValueError(f"{n} rows need {n_chunks} chunks of {chunk_rows} "
                         f"rows, more than one launch takes ({MAX_CHUNKS})")
    out = torch.empty((f, f), dtype=torch.float32, device=device)
    scratch = torch.empty(n_chunks * tile_pairs(f) * TILE * TILE,
                          dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = library().covar_xtx(x.data_ptr(), w.data_ptr(), n, f,
                                  chunk_rows, n_chunks, scratch.data_ptr(),
                                  out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"covar_xtx launch failed with CUDA error {err} "
                           f"(n={n}, F={f}, chunks={n_chunks})")
    return out

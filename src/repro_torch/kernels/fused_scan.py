"""CUDA kernel ``fused_scan_block``: every reduction of a scan step in one
launch; the port of ``fused_scan_block_pallas``
(``repro/kernels/fused_scan.py:168``).

Inputs are packed by the lowering backend exactly as for the TPU kernel:

  * ``codes`` (n, C) int32 — one column per reduction: the flattened
    segment id (bucket reductions) or the histogram bucket code;
  * ``fpay`` (n, W) float32 — all float payloads concatenated: bucket view
    payloads, hist cond masks and the shared ``[1, y, y²]`` triples.

Each :class:`ReduceSpec` says which slice belongs to which reduction.  The
device code (``csrc/scan_reduce.cuh``) splits every reduction into column
tiles that fit shared memory; :func:`launch_plan` lays those work items out
and this module's launch function runs them.  Codes outside
``[0, n_segments)`` contribute nothing, so the last, ragged row block needs
no padding rows.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence, Tuple

import torch

#: shared memory a block may use on sm_90 (227 KB, opt-in above 48 KB)
SMEM_BYTES = 232448
#: threads per block of the partial pass (``kThreads`` in scan_reduce.cuh)
THREADS = 1024
#: rows per chunk where the partial tiles are cheap enough: chunks bound
#: how many rows add into one shared-memory word in sequence
CHUNK_ROWS = 4096
#: partial-tile floats (8 MB) an item may write before it gets fewer,
#: longer chunks: a narrow, skewed accumulator such as the fact step's
#: (480 × 20) sku view gets its 4096-row chunks for a few MB of scratch
SCRATCH_FLOATS = 1 << 21
#: fewest rows per chunk.  A short scan gets about two blocks per SM down
#: to chunks this short: the covar plan's last, 4,960-row Weather step runs
#: in 38 chunks of 131 rows instead of 2 of 2,480, which spreads it over the
#: card and keeps its fact-row counts per chunk (about 2.2M at 84M fact
#: rows) below 2^24, where float32 adds of integers are exact
MIN_CHUNK_ROWS = 32
KIND_CODES = {"seg": 0, "hist": 1, "vec_hist": 2}
N_FIELDS = 12


@dataclasses.dataclass(frozen=True)
class ReduceSpec:
    """One fused reduction: ``kind`` "seg" sums ``fpay[:, pay_off:pay_off +
    width]`` into ``n_segments`` rows keyed by ``codes[:, code_col]``;
    ``kind`` "hist" builds the payload ``cond ⊗ [1, y, y²]`` on chip from
    ``n_cond`` mask columns at ``pay_off`` and the y-triple at ``yk_off``
    (output width is ``n_cond * 3``)."""

    kind: str
    code_col: int
    n_segments: int
    width: int
    pay_off: int
    n_cond: int = 0
    yk_off: int = 0

    def __post_init__(self):
        assert self.kind in ("seg", "hist"), self.kind
        if self.kind == "hist":
            assert self.width == self.n_cond * 3, (self.width, self.n_cond)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Work items and buffer sizes of one launch (see scan_reduce.cuh)."""

    items: torch.Tensor          # (n_items, N_FIELDS) int64 on the device
    n_items: int
    n_chunks: int                # the most chunks of any item (grid y)
    max_size: int                # largest S_r * tile over the items
    smem_bytes: int
    scratch_numel: int
    outputs: Tuple[Tuple[int, int, int], ...]   # (offset, S_r, width_r)

    @property
    def out_numel(self) -> int:
        off, s, w = self.outputs[-1]
        return off + s * w


def column_tiles(n_segments: int, width: int):
    """``(first column, columns)`` tiles of one reduction, each sized so
    that its ``n_segments × columns`` float32 accumulator fits a block's
    shared memory.  Raises when not even one column fits."""
    fit = SMEM_BYTES // (4 * n_segments)
    if fit < 1:
        raise ValueError(
            f"a reduction over {n_segments} segments does not fit the "
            f"{SMEM_BYTES}-byte shared-memory tile of one block (at most "
            f"{SMEM_BYTES // 4} segments)")
    tile = min(width, fit, THREADS)
    return [(c0, min(tile, width - c0)) for c0 in range(0, width, tile)]


@functools.lru_cache(maxsize=256)
def launch_plan(specs: Tuple[ReduceSpec, ...], kinds: Tuple[str, ...],
                n: int, device: torch.device) -> LaunchPlan:
    """Lay out the work items of ``specs`` for ``n`` rows.  Cached: the
    items tensor is copied to the device once per (specs, n)."""
    rows, outputs, off = [], [], 0
    for sp, kind in zip(specs, kinds):
        for c0, t in column_tiles(sp.n_segments, sp.width):
            rows.append([KIND_CODES[kind], sp.code_col, sp.n_segments,
                         sp.width, sp.pay_off, sp.yk_off, c0, t, off, 0, 0, 0])
        outputs.append((off, sp.n_segments, sp.width))
        off += sp.n_segments * sp.width
    # chunks per item: one per CHUNK_ROWS rows while its partial tiles stay
    # under SCRATCH_FLOATS, but no fewer than it takes to give the grid
    # about two blocks per SM, down to MIN_CHUNK_ROWS rows; no empty chunk
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    base = -(-2 * sms // len(rows))
    scratch = 0
    for r in rows:
        size = r[2] * r[7]
        want = max(base, min(-(-n // CHUNK_ROWS), SCRATCH_FLOATS // size))
        chunks = max(1, min(-(-n // MIN_CHUNK_ROWS), want))
        chunk_rows = -(-n // chunks)
        r[9], r[10], r[11] = scratch, -(-n // chunk_rows), chunk_rows
        scratch += r[10] * size
    max_size = max(r[2] * r[7] for r in rows)
    return LaunchPlan(
        items=torch.tensor(rows, dtype=torch.int64, device=device),
        n_items=len(rows), n_chunks=max(r[10] for r in rows),
        max_size=max_size, smem_bytes=4 * max_size, scratch_numel=scratch,
        outputs=tuple(outputs))


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
                 device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected a {ndim}-d {dtype} tensor, got "
                         f"{t.dim()}-d {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def run(entry, args: Sequence[int], plan: LaunchPlan, n: int,
        device: torch.device) -> Tuple[torch.Tensor, ...]:
    """Allocate scratch and output, launch ``entry`` of the kernel library
    on the current stream, and split the output per reduction."""
    out = torch.empty(plan.out_numel, dtype=torch.float32, device=device)
    scratch = torch.empty(plan.scratch_numel, dtype=torch.float32,
                          device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = entry(*args, plan.items.data_ptr(), plan.n_items,
                    plan.n_chunks, plan.max_size, plan.smem_bytes,
                    scratch.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{entry.__name__} launch failed with CUDA error "
                           f"{err} (n={n}, items={plan.n_items}, "
                           f"smem={plan.smem_bytes} B)")
    return tuple(out[o:o + s * w].view(s, w) for o, s, w in plan.outputs)


def fused_scan_block_cuda(codes: torch.Tensor, fpay: torch.Tensor,
                          specs: Tuple[ReduceSpec, ...]):
    """Launch the fused kernel; returns one ``(n_segments, width)`` tensor
    per spec.  ``codes`` (n, C) int32 and ``fpay`` (n, W) float32, both
    contiguous on one CUDA device."""
    from repro_torch.kernels._build import library

    device = codes.device
    check_tensor("codes", codes, torch.int32, 2, device)
    check_tensor("fpay", fpay, torch.float32, 2, device)
    n, n_codes = codes.shape
    if fpay.shape[0] != n or n == 0:
        raise ValueError(f"codes {tuple(codes.shape)} and fpay "
                         f"{tuple(fpay.shape)} need the same, non-zero rows")
    width = fpay.shape[1]
    for sp in specs:
        end = (sp.pay_off + sp.width if sp.kind == "seg"
               else max(sp.pay_off + sp.n_cond, sp.yk_off + 3))
        if not (0 <= sp.code_col < n_codes and sp.pay_off >= 0
                and end <= width):
            raise ValueError(f"{sp} does not fit codes {tuple(codes.shape)} "
                             f"/ fpay {tuple(fpay.shape)}")
    plan = launch_plan(specs, tuple(sp.kind for sp in specs), n, device)
    return run(library().fused_scan_block,
               [codes.data_ptr(), n, n_codes, fpay.data_ptr(), width],
               plan, n, device)

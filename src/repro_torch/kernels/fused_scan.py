"""CUDA kernel ``fused_scan_block``: every reduction of a scan step in one
launch; the port of ``fused_scan_block_pallas``
(``repro/kernels/fused_scan.py:168``).

Two forms, one device entry point (``csrc/fused_scan.cu`` over
``csrc/seg_reduce.cuh``):

  * the reference's packed form, :func:`fused_scan_block_cuda`: ``codes``
    (n, C) int32 with one column per reduction, and ``fpay`` (n, W) float32
    holding every payload, cond mask and ``[1, y, y²]`` triple, sliced by
    :class:`ReduceSpec`\\ s.  Its sources point into the two matrices;
  * the parts form, :func:`fused_scan_parts_cuda`: per reduction a
    :class:`Parts`, its codes and payload parts as they lie (strided
    views, transposed masks, expanded columns), which the lowering passes
    so that it stacks nothing.

The host geometry is ``seg_aggregate.py``'s (:func:`launch_plan`): each
reduction's accumulator in one block where it fits, else cut into segment
ranges.  Codes outside ``[0, n_segments)`` contribute nothing, so the
last, ragged row block needs no padding rows.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.seg_aggregate import (Shape, check_tensor,
                                               launch_plan, run, source)


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


class Part(NamedTuple):
    """A payload part of a "seg" :class:`Parts`: ``values`` (n,) or (n, w)
    float32, any strides (0 for an expanded axis), whose element ``i`` of a
    row goes to output column ``ocol + i * ostride``."""

    values: torch.Tensor
    ocol: int
    ostride: int = 1


@dataclasses.dataclass(frozen=True, eq=False)
class Parts:
    """One reduction of the parts form.  ``kind`` "seg": ``parts`` are
    :class:`Part`\\ s, summed into ``width`` output columns (a column no
    part names reads 0); "hist": ``parts = (cond, y)``, cond (n, N) and y
    (n,) (``[1, y, y²]`` formed on chip) or (n, 3), output ``3 N``
    columns ``[node j, stat k]``.  ``codes`` (n,) int32 keys the rows into
    ``n_segments``; every tensor lies on one device, with any strides."""

    kind: str
    codes: torch.Tensor
    parts: Tuple
    n_segments: int
    width: Optional[int] = None

    @property
    def out_width(self) -> int:
        if self.kind == "hist":
            return 3 * self.parts[0].shape[1]
        if self.width is not None:
            return self.width
        return max(p.ocol + (_cols(p.values) - 1) * p.ostride + 1
                   for p in self.parts)


def _cols(t: torch.Tensor) -> int:
    return t.shape[1] if t.dim() == 2 else 1


def _check_part(name: str, t: torch.Tensor, dtype, n: int,
                device: torch.device) -> None:
    """A (n,) or (n, w) tensor of ``dtype`` on ``device``, w > 0, with no
    negative stride (one test on the launch's path, the message after)."""
    if (t.device == device and t.dtype == dtype and 1 <= t.dim() <= 2
            and t.shape[0] == n and t.numel() > 0 and min(t.stride()) >= 0):
        return
    raise ValueError(f"{name}: expected a ({n},) or ({n}, w > 0) {dtype} "
                     f"tensor on {device} with no negative stride, got "
                     f"{tuple(t.shape)} {t.dtype} on {t.device}, strides "
                     f"{t.stride()}")


@functools.lru_cache(maxsize=1024)
def disjoint_columns(width: int, cols: Tuple[Tuple[int, int, int], ...]) -> bool:
    """Whether parts at ``(ocol, ostride, columns)`` name each of ``width``
    output columns at most once (checked once per layout of a launch)."""
    seen = bytearray(width)
    for ocol, ostride, w in cols:
        for c in range(ocol, ocol + w * ostride, ostride):
            if seen[c]:
                return False
            seen[c] = 1
    return True


def fused_scan_parts_cuda(reds: Sequence[Parts], lib=None):
    """Launch the fused kernel over reductions given as :class:`Parts`;
    returns one ``(n_segments, width)`` tensor each.  ``lib``: a kernel
    library other than the package's (``tools/scan_ablation.py``)."""
    from repro_torch.kernels._build import library

    device, f32 = reds[0].codes.device, torch.float32
    n = reds[0].codes.shape[0]
    if n == 0:
        raise ValueError("fused_scan_parts needs at least one row")
    shapes, sources, zero = [], [], False
    for i, red in enumerate(reds):
        _check_part(f"reduction {i} codes", red.codes, torch.int32, n, device)
        if red.codes.dim() != 1:
            raise ValueError(f"reduction {i}: codes must be (n,)")
        sources.append(source(red.codes))
        if red.kind == "hist":
            cond, y = red.parts
            _check_part(f"reduction {i} cond", cond, torch.float32, n, device)
            _check_part(f"reduction {i} y", y, torch.float32, n, device)
            if cond.dim() != 2 or _cols(y) not in (1, 3):
                raise ValueError(f"reduction {i}: hist takes a (n, N) cond "
                                 "and a (n,) y or (n, 3) yk")
            n_cond = cond.shape[1]
            sources += [source(cond, ocol=3 * n_cond, ostride=3),
                        source(y, col0=n_cond)]
            shapes.append(Shape("hist", red.n_segments, (n_cond, _cols(y)),
                                3 * n_cond))
            continue
        if red.kind != "seg" or not red.parts:
            raise ValueError(f"reduction {i}: a seg reduction needs parts")
        # one pass a part, the checks in one test: a launch may name
        # hundreds of parts (polyreg's 540 aggregate columns)
        width, col, widths = red.out_width, 0, []
        for t, ocol, ostride in red.parts:
            shape, st = t.shape, t.stride()
            w = shape[1] if len(shape) == 2 else 1
            if not (t.dtype is f32 and t.device == device and 1 <= len(shape) <= 2
                    and shape[0] == n and w > 0 and min(st) >= 0 and ocol >= 0
                    and ostride > 0 and ocol + (w - 1) * ostride < width):
                _check_part(f"reduction {i} part {len(widths)}", t, f32, n, device)
                raise ValueError(f"reduction {i} part {len(widths)}: output "
                                 f"columns {ocol}+{ostride}·i, i < {w}, "
                                 f"outside {width}")
            sources.append((t.data_ptr(), st[0], st[1] if len(shape) == 2 else 0,
                            col, w, ocol, ostride))
            widths.append((ocol, ostride, w))
            col += w
        if not disjoint_columns(width, tuple(widths)):
            raise ValueError(f"reduction {i}: two parts name one output column")
        zero |= col < width
        shapes.append(Shape("seg", red.n_segments, tuple(w for *_, w in widths), width))
    lib = library() if lib is None else lib
    plan = launch_plan(n, tuple(shapes), device, lib)
    return run(lib.fused_scan_block, plan, sources, n, device, zero=zero)


@functools.lru_cache(maxsize=256)
def _packed(specs: Tuple[ReduceSpec, ...], n_codes: int, width: int):
    """The packed form's shapes, and its sources as (matrix, first element,
    row stride, column stride, first accumulator column, width, first output
    column, output column stride): matrix 0 the codes, 1 the payload."""
    shapes, rows = [], []
    for sp in specs:
        end = (sp.pay_off + sp.width if sp.kind == "seg"
               else max(sp.pay_off + sp.n_cond, sp.yk_off + 3))
        if not (0 <= sp.code_col < n_codes and sp.pay_off >= 0
                and end <= width):
            raise ValueError(f"{sp} does not fit codes (n, {n_codes}) / "
                             f"fpay (n, {width})")
        rows.append((0, sp.code_col, n_codes, 0, 0, 1, 0, 1))
        if sp.kind == "seg":
            rows.append((1, sp.pay_off, width, 1, 0, sp.width, 0, 1))
            shapes.append(Shape("seg", sp.n_segments, (sp.width,), sp.width))
        else:
            rows += [(1, sp.pay_off, width, 1, 0, sp.n_cond, 3 * sp.n_cond, 3),
                     (1, sp.yk_off, width, 1, sp.n_cond, 3, 0, 1)]
            shapes.append(Shape("hist", sp.n_segments, (sp.n_cond, 3), sp.width))
    return tuple(shapes), tuple(rows)


def fused_scan_block_cuda(codes: torch.Tensor, fpay: torch.Tensor,
                          specs: Tuple[ReduceSpec, ...], lib=None):
    """Launch the fused kernel on the reference's packed inputs; returns one
    ``(n_segments, width)`` tensor per spec.  ``codes`` (n, C) int32 and
    ``fpay`` (n, W) float32, both contiguous on one CUDA device: the
    sources point into the two matrices at the specs' offsets."""
    from repro_torch.kernels._build import library

    device = codes.device
    check_tensor("codes", codes, torch.int32, 2, device)
    check_tensor("fpay", fpay, torch.float32, 2, device)
    n, n_codes = codes.shape
    if fpay.shape[0] != n or n == 0:
        raise ValueError(f"codes {tuple(codes.shape)} and fpay "
                         f"{tuple(fpay.shape)} need the same, non-zero rows")
    shapes, rows = _packed(tuple(specs), n_codes, fpay.shape[1])
    base = (codes.data_ptr(), fpay.data_ptr())
    sources = [(base[m] + 4 * off, *rest) for m, off, *rest in rows]
    lib = library() if lib is None else lib
    plan = launch_plan(n, shapes, device, lib)
    return run(lib.fused_scan_block, plan, sources, n, device)

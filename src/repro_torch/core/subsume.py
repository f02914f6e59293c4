"""Subsumption lattice + secondary-program lowering over view tensors;
counterpart of ``repro/core/subsume.py`` (a copy apart from imports, with
:func:`lower_secondary` a plain function on torch tensors).

The serving router answers an ad-hoc group-by aggregate from an
already-materialized view whenever the algebra allows it.  Views are dense
code-domain tensors shaped ``(*group_domains, n_aggs)`` with one axis per
group-by attribute (query order) and a trailing aggregate-column axis.
Group-bys form a lattice under partition refinement: grouping by a
*superset* of attributes refines the partition, so summing a wider view
over its extra attribute axes recovers the coarser grouping exactly —
SUM/COUNT-style aggregates (everything this engine materializes) are
additive across the summed-away cells.  That makes subsumption a purely
structural test:

    wide ⊒ narrow  ⟺  dims(narrow) ⊆ dims(wide)
                       ∧ every aggregate of narrow appears (by canonical
                         render, filters inline) as a column of wide

A :class:`SecondaryProgram` is the lowered answer plan: gather the needed
aggregate columns, sum away the extra attribute axes, permute the kept
axes into the asking query's group-by order.  Like the reference's
``jnp.take/sum/transpose``, these are plain library reductions over view
tensors, never base relations.  Programs are verified structurally at
admission time by ``analysis/verify.py:verify_secondary_program`` (rule
``route-subsume``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.aggregates import Query
from repro_torch.core.schema import DatabaseSchema
from repro_torch.obs.workload import agg_renders

__all__ = ["ViewShape", "view_shape_of", "subsumes", "reagg_cost",
           "SecondaryProgram", "build_secondary_program", "lower_secondary"]


@dataclasses.dataclass(frozen=True)
class ViewShape:
    """Structural shape of a materialized view tensor: axis order, per-axis
    code domains, and the canonical render of each trailing agg column."""

    name: str                   # view (query) name
    dims: Tuple[str, ...]       # tensor axis order = query group_by order
    domains: Tuple[int, ...]    # code-domain size per dim axis
    aggs: Tuple[str, ...]       # canonical render per agg column, in order

    @property
    def cells(self) -> int:
        n = 1
        for d in self.domains:
            n *= d
        return n


def view_shape_of(q: Query, schema: DatabaseSchema,
                  name: Optional[str] = None) -> ViewShape:
    """Shape of the tensor ``q`` materializes under ``schema``."""
    return ViewShape(name=name or q.name,
                     dims=tuple(q.group_by),
                     domains=tuple(schema.domain(a) for a in q.group_by),
                     aggs=agg_renders(q))


def _column_map(wide: ViewShape,
                narrow: ViewShape) -> Optional[Tuple[int, ...]]:
    """Per narrow agg column, the wide column carrying the same canonical
    render — or None if any narrow column is missing from wide."""
    idx: Dict[str, int] = {}
    for i, r in enumerate(wide.aggs):
        idx.setdefault(r, i)
    cols = []
    for r in narrow.aggs:
        i = idx.get(r)
        if i is None:
            return None
        cols.append(i)
    return tuple(cols)


def subsumes(wide: ViewShape, narrow: ViewShape) -> bool:
    """Whether ``narrow`` is answerable from ``wide`` by re-aggregation."""
    if not set(narrow.dims) <= set(wide.dims):
        return False
    return _column_map(wide, narrow) is not None


def reagg_cost(wide: ViewShape) -> int:
    """Cells read to re-aggregate from ``wide`` — the planner prefers the
    smallest subsuming source tensor."""
    return wide.cells


@dataclasses.dataclass(frozen=True)
class SecondaryProgram:
    """Closed-form re-aggregation plan: view tensor of ``source`` shape →
    answer tensor of ``target`` shape.  ``is_exact`` means no axis is
    summed away (pure axis/column shuffle — the exact-match adapter)."""

    source: ViewShape
    target: ViewShape
    col_idx: Tuple[int, ...]    # source agg column per target agg column
    sum_axes: Tuple[int, ...]   # source dim axes summed away (sorted)
    perm: Tuple[int, ...]       # post-sum kept-axis permutation → target
                                # dim order (agg axis stays last)

    @property
    def is_exact(self) -> bool:
        return not self.sum_axes


def build_secondary_program(wide: ViewShape,
                            narrow: ViewShape) -> SecondaryProgram:
    """Derive the re-aggregation plan, or raise ``ValueError`` when
    ``wide`` does not subsume ``narrow``."""
    missing = set(narrow.dims) - set(wide.dims)
    if missing:
        raise ValueError(
            f"view '{wide.name}' cannot answer '{narrow.name}': "
            f"group-by attrs {sorted(missing)} not in source dims "
            f"{wide.dims}")
    cols = _column_map(wide, narrow)
    if cols is None:
        have = set(wide.aggs)
        lost = [r for r in narrow.aggs if r not in have]
        raise ValueError(
            f"view '{wide.name}' cannot answer '{narrow.name}': "
            f"aggregate columns {lost} not materialized")
    keep = set(narrow.dims)
    sum_axes = tuple(i for i, d in enumerate(wide.dims) if d not in keep)
    kept_dims = [d for d in wide.dims if d in keep]
    perm = tuple(kept_dims.index(d) for d in narrow.dims)
    return SecondaryProgram(source=wide, target=narrow, col_idx=cols,
                            sum_axes=sum_axes, perm=perm)


def lower_secondary(sp: SecondaryProgram) -> Callable:
    """Lower to one function over the source view tensor: additive fold
    over the summed-away axes → column gather → axis permute into the
    target's group-by order.  The fold goes first: it reads the source
    (of any strides, e.g. a permuted view) once and writes only the
    narrow result, so the gather copies the small tensor, never the
    source.  The column index tensor is built once per device and kept
    with the function, which the router caches per (source, program)."""
    cols = tuple(sp.col_idx)
    sum_axes = tuple(sp.sum_axes)
    # full permute spec: permuted kept axes, then the trailing agg axis
    out_perm = tuple(sp.perm) + (len(sp.perm),)
    index: Dict[torch.device, torch.Tensor] = {}

    def reagg(arr: torch.Tensor) -> torch.Tensor:
        if sum_axes:
            arr = arr.sum(dim=sum_axes)
        idx = index.get(arr.device)
        if idx is None:
            idx = index[arr.device] = torch.tensor(cols, dtype=torch.int64,
                                                   device=arr.device)
        return arr.index_select(-1, idx).permute(out_perm)

    return reagg

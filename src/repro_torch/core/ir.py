"""Copy of ``repro/core/ir.py`` for the PyTorch port: identical apart
from imports, so that the port compiles the same plans without importing
the JAX package.

Group-program IR: the compile-time form of a multi-output shared scan.

The seed executor re-derived every static fact about a view group (child
gather axes, product alignment, segment layouts, output permutations) on each
``bind``; this module lifts that preparation into a typed, frozen IR built
once at compile time from ``PushdownResult`` + ``ViewGroup``s (DESIGN.md §3).
A :class:`GroupProgram` is the scan program for one view group; the scheduler
(``schedule.py``) fuses programs over the same relation into a
:class:`StepProgram`, and the lowering backends (``lowering/``) consume step
programs without ever touching ``ViewDef``/``ViewGroup`` again.

Layout conventions (shared by every backend):

  * a view's accumulator is ``(n_segments?, *pulled_dims, n_aggs)`` — the
    flattened local group-by key first (if any), pulled-up dense axes next,
    the aggregate column axis last;
  * a product's working axes are ``pulled ++ extra`` where ``extra`` are
    attribute axes used by terms/child columns but marginalized before
    accumulation (paper §3.4's partial aggregates);
  * the finalize step reshapes the flat segment axis back into one axis per
    local attribute and transposes into the view's canonical group-by order.

:class:`HistSpec` marks views matching the decision-tree node-histogram
pattern ``[Σ cond, Σ cond·y, Σ cond·y²]`` grouped by one local attribute —
the shape the fused ``kernels/tree_hist`` Pallas kernel computes in a single
VMEM-resident pass (paper Table 3 row 3).

**Param-batch (node) axis** (DESIGN.md §7.4): a term consuming a
``Param(batched=True)`` makes its :class:`TermApp` *batched*; batchedness
propagates to the product, to the view, and transitively to every view that
gathers a batched child (:func:`compute_batched_vids`).  Batched view
accumulators grow an optional leading node axis of runtime size ``N``
(``acc_shape`` stays the unbatched shape; backends prepend ``N``), so one
relation pass serves all ``N`` parameter settings of the compiled batch.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, FrozenSet, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.aggregates import Pow, Term, Var
from repro_torch.core.groups import ViewGroup
from repro_torch.core.pushdown import ViewDef
from repro_torch.core.schema import DatabaseSchema


@dataclasses.dataclass(frozen=True)
class GatherSpec:
    """How a scan gathers one incoming child view: ``gather`` attrs (local
    columns of the scanned relation) index the child array's axis prefix;
    ``rest`` are the dense axes the gathered slice keeps.  ``batched`` child
    arrays carry a leading node axis the gather must skip."""

    vid: int
    gather: Tuple[str, ...]
    rest: Tuple[str, ...]
    batched: bool = False


@dataclasses.dataclass(frozen=True)
class ChildColRef:
    """One gathered child-view column inside a product, with the dense axes
    (``rest``) it carries after the gather."""

    vid: int
    col: int
    rest: Tuple[str, ...]
    batched: bool = False


@dataclasses.dataclass(frozen=True)
class TermApp:
    """A local term application: ``col_attrs`` bind to scanned columns,
    ``dom_attrs`` bind to domain-iota axes of the product's axis frame.
    ``batched`` terms resolve a batched param and emit a leading node axis."""

    term: Term
    col_attrs: Tuple[str, ...]
    dom_attrs: Tuple[str, ...]
    dom_dims: Tuple[int, ...]
    batched: bool = False


@dataclasses.dataclass(frozen=True)
class ProductProgram:
    """One product Π child-cols × Π local-terms evaluated in the axis frame
    ``axes = pulled ++ extra``; the trailing ``len(axes) - n_keep`` axes are
    marginalized (summed out) before the product joins its column."""

    child_refs: Tuple[ChildColRef, ...]
    local_terms: Tuple[TermApp, ...]
    axes: Tuple[str, ...]
    axis_dims: Tuple[int, ...]
    n_keep: int
    batched: bool = False


@dataclasses.dataclass(frozen=True)
class ColProgram:
    """One output aggregate column: a sum of product programs."""

    products: Tuple[ProductProgram, ...]


@dataclasses.dataclass(frozen=True)
class SegmentSpec:
    """Flattened local group-by key: mixed-radix code over ``attrs``."""

    attrs: Tuple[str, ...]
    dims: Tuple[int, ...]
    n_segments: int


@dataclasses.dataclass(frozen=True)
class HistSpec:
    """Decision-tree node-histogram pattern (see module docstring): the
    view's three columns are ``cond``, ``cond·y``, ``cond·y²`` bucketed by
    ``code_attr`` — routable through ``kernels/tree_hist``."""

    code_attr: str
    n_buckets: int
    y_attr: str
    cond: ColProgram


@dataclasses.dataclass(frozen=True)
class ViewProgram:
    """Complete scan program for one output view."""

    vid: int
    rel: str
    group_by: Tuple[str, ...]
    local: Tuple[str, ...]
    pulled: Tuple[str, ...]
    pulled_dims: Tuple[int, ...]
    n_aggs: int
    seg: Optional[SegmentSpec]
    cols: Tuple[ColProgram, ...]
    acc_shape: Tuple[int, ...]      # unbatched; batched views prepend (N,)
    out_dims: Tuple[int, ...]
    out_perm: Tuple[int, ...]
    hist: Optional[HistSpec]
    batched: bool = False


@dataclasses.dataclass(frozen=True)
class GroupProgram:
    """Scan program for one view group: all its view programs plus the union
    of child gathers they need."""

    gid: int
    rel: str
    views: Tuple[ViewProgram, ...]
    gathers: Tuple[GatherSpec, ...]


@dataclasses.dataclass(frozen=True)
class StepProgram:
    """Scan program for one (possibly fused) scheduler step: the shared scan
    computing every view of every fused group in a single relation pass."""

    rel: str
    gids: Tuple[int, ...]
    views: Tuple[ViewProgram, ...]
    gathers: Tuple[GatherSpec, ...]


# ---------------------------------------------------------------------- build

def compute_batched_vids(views: Mapping[int, ViewDef]) -> FrozenSet[int]:
    """Vids whose accumulators carry the param-batch (node) axis: a view is
    batched iff any of its terms consumes a batched param, or (transitively)
    it gathers a batched child view.  Fixpoint over the view DAG."""
    batched: set = set()
    for vid, w in views.items():
        for col in w.agg_cols:
            for prod in col.products:
                if any(t.is_batched() for t in prod.local_terms):
                    batched.add(vid)
    changed = True
    while changed:
        changed = False
        for vid, w in views.items():
            if vid in batched:
                continue
            refs = {ref.vid for col in w.agg_cols for prod in col.products
                    for ref in prod.child_cols}
            if refs & batched:
                batched.add(vid)
                changed = True
    return frozenset(batched)


def batched_param_names(views: Mapping[int, ViewDef]) -> FrozenSet[str]:
    """Names of all batched params referenced anywhere in the view DAG —
    ``run_batched`` reads the node-batch size ``N`` off their leading axis."""
    return frozenset(p.name for w in views.values() for col in w.agg_cols
                     for prod in col.products for t in prod.local_terms
                     for p in t.params() if p.batched)


def build_group_program(schema: DatabaseSchema, views: Mapping[int, ViewDef],
                        group: ViewGroup,
                        batched_vids: FrozenSet[int] = frozenset()) -> GroupProgram:
    rel_attrs = schema.relation(group.rel).attr_set
    out_views = [views[vid] for vid in group.vids]

    child_vids = sorted({ref.vid
                         for w in out_views
                         for col in w.agg_cols
                         for prod in col.products
                         for ref in prod.child_cols})
    gathers = []
    child_rest: Dict[int, Tuple[str, ...]] = {}
    for vid in child_vids:
        v = views[vid]
        gat = tuple(a for a in v.group_by if a in rel_attrs)
        rest = tuple(a for a in v.group_by if a not in rel_attrs)
        # gather attrs must form the axis prefix of the child array
        if v.group_by[:len(gat)] != gat:
            raise AssertionError(f"view {vid}: gather attrs not a prefix: "
                                 f"{v.group_by} vs {gat}")
        gathers.append(GatherSpec(vid, gat, rest, batched=vid in batched_vids))
        child_rest[vid] = rest

    vps = tuple(_build_view_program(schema, w, rel_attrs, child_rest,
                                    batched_vids)
                for w in out_views)
    return GroupProgram(gid=group.gid, rel=group.rel, views=vps,
                        gathers=tuple(gathers))


def build_programs(schema: DatabaseSchema, views: Mapping[int, ViewDef],
                   groups: Sequence[ViewGroup]) -> Dict[int, GroupProgram]:
    batched_vids = compute_batched_vids(views)
    return {g.gid: build_group_program(schema, views, g, batched_vids)
            for g in groups}


def fuse_programs(progs: Sequence[GroupProgram]) -> StepProgram:
    """Merge same-relation group programs into one shared-scan step program.
    Gather specs for a child view are identical across groups (they depend
    only on the scanned relation), so the union dedups by vid."""
    rel = progs[0].rel
    assert all(p.rel == rel for p in progs), [p.rel for p in progs]
    views = tuple(vp for p in progs for vp in p.views)
    by_vid: Dict[int, GatherSpec] = {}
    for p in progs:
        for gs in p.gathers:
            by_vid[gs.vid] = gs
    return StepProgram(rel=rel, gids=tuple(p.gid for p in progs), views=views,
                       gathers=tuple(by_vid[v] for v in sorted(by_vid)))


def _build_view_program(schema: DatabaseSchema, w: ViewDef,
                        rel_attrs: frozenset,
                        child_rest: Mapping[int, Tuple[str, ...]],
                        batched_vids: FrozenSet[int] = frozenset()) -> ViewProgram:
    local = tuple(a for a in w.group_by if a in rel_attrs)
    pulled = tuple(a for a in w.group_by if a not in rel_attrs)
    pulled_dims = tuple(schema.domain(a) for a in pulled)

    seg = None
    if local:
        dims = tuple(schema.domain(a) for a in local)
        seg = SegmentSpec(attrs=local, dims=dims,
                          n_segments=int(np.prod(dims, dtype=np.int64)))

    cols = []
    for colspec in w.agg_cols:
        prods = []
        for prod in colspec.products:
            used = set()
            refs = []
            for ref in prod.child_cols:
                rest = child_rest[ref.vid]
                used |= set(rest)
                refs.append(ChildColRef(ref.vid, ref.col, rest,
                                        batched=ref.vid in batched_vids))
            term_apps = []
            for t in prod.local_terms:
                col_attrs = tuple(sorted(a for a in t.attrs() if a in rel_attrs))
                dom_attrs = tuple(sorted(a for a in t.attrs() if a not in rel_attrs))
                used |= set(dom_attrs)
                term_apps.append(TermApp(
                    t, col_attrs, dom_attrs,
                    tuple(schema.domain(a) for a in dom_attrs),
                    batched=t.is_batched()))
            extra = tuple(sorted(used - set(pulled)))
            axes = pulled + extra
            prods.append(ProductProgram(
                child_refs=tuple(refs), local_terms=tuple(term_apps),
                axes=axes, axis_dims=tuple(schema.domain(a) for a in axes),
                n_keep=len(pulled),
                batched=(any(r.batched for r in refs)
                         or any(ta.batched for ta in term_apps))))
        cols.append(ColProgram(tuple(prods)))
    cols = tuple(cols)

    acc_shape = (((seg.n_segments,) if seg else ())
                 + pulled_dims + (w.n_aggs,))
    out_dims = tuple(schema.domain(a) for a in local) + pulled_dims
    computed_order = list(local) + list(pulled)
    out_perm = tuple([computed_order.index(a) for a in w.group_by]
                     + [len(computed_order)])

    return ViewProgram(
        vid=w.vid, rel=w.rel, group_by=w.group_by, local=local, pulled=pulled,
        pulled_dims=pulled_dims, n_aggs=w.n_aggs, seg=seg, cols=cols,
        acc_shape=acc_shape, out_dims=out_dims, out_perm=out_perm,
        hist=_detect_hist(schema, rel_attrs, local, pulled, cols),
        batched=w.vid in batched_vids)


def _detect_hist(schema: DatabaseSchema, rel_attrs: frozenset,
                 local: Tuple[str, ...], pulled: Tuple[str, ...],
                 cols: Tuple[ColProgram, ...]) -> Optional[HistSpec]:
    """Match ``[Σ P, Σ P·y, Σ P·y²] GROUP BY code`` with a single local key,
    no pulled/extra axes, and a shared mask product P."""
    if len(local) != 1 or pulled or len(cols) != 3:
        return None
    if any(len(cp.products) != 1 for cp in cols):
        return None
    p0, p1, p2 = (cp.products[0] for cp in cols)
    if p0.axes or p1.axes or p2.axes:
        return None
    if not (p0.child_refs == p1.child_refs == p2.child_refs):
        return None

    def keys(p: ProductProgram):
        return collections.Counter(repr(ta.term.key()) for ta in p.local_terms)

    k0 = keys(p0)
    extras = []
    for p in (p1, p2):
        diff = keys(p) - k0
        if (k0 - keys(p)) or sum(diff.values()) != 1:
            return None
        extra_key = next(iter(diff))
        ta = next(t for t in p.local_terms if repr(t.term.key()) == extra_key)
        extras.append(ta.term)
    t_y, t_y2 = extras
    if not (isinstance(t_y, Var) and isinstance(t_y2, Pow) and t_y2.k == 2
            and t_y.attr == t_y2.attr and t_y.attr in rel_attrs):
        return None
    return HistSpec(code_attr=local[0], n_buckets=schema.domain(local[0]),
                    y_attr=t_y.attr, cond=cols[0])

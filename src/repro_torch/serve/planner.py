"""Copy of ``repro/serve/planner.py`` for the PyTorch port: identical apart
from imports.

Adaptive route planning over the signature lattice (DESIGN.md §13).

The planner is the *decision* half of ad-hoc query serving: given an
arbitrary group-by aggregate and the session's answerable sources —
registered view handles plus the router's compiled-plan cache — it picks
the cheapest sound way to answer, without executing anything:

    tier "exact"     the query's canonical signature equals a source's;
                     the answer is an axis/column shuffle of one view
                     tensor (maintained source → epoch read, no scan;
                     batch/cached source → that handle's shared scan)
    tier "subsumed"  a *wider maintained* view subsumes the query
                     (``core/subsume.py``); the answer re-aggregates its
                     epoch tensor on-device — never a base-relation scan
    miss             nothing answers it; the router compiles a fresh plan

Preference order is by execution cost, not match quality: an epoch read
beats a re-aggregation beats any scan, and among subsuming views the
smallest source tensor wins (``reagg_cost``).  Subsumption is only planned
against maintained sources — re-aggregating a batch view would rescan base
relations anyway, at which point an exact compiled plan is no worse.

Maintained sources bind their parameters at the initial full scan, so a
routed call that passes explicit ``params`` skips them (tiers fall through
to compiled plans, which bind params per run).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.aggregates import Query
from repro_torch.core.subsume import (SecondaryProgram, ViewShape,
                                build_secondary_program, reagg_cost,
                                subsumes, view_shape_of)
from repro_torch.obs.workload import signature_of

__all__ = ["Candidate", "RoutePlan", "AdaptivePlanner",
           "has_batched_params"]


def has_batched_params(q: Query) -> bool:
    """Whether any term carries a ``Param(batched=True)`` — those queries
    need the node-frontier axis (``ViewHandle.run_batched``) and are
    rejected by the router with a pointer there."""
    return any(t.is_batched()
               for a in q.aggregates for p in a.products for t in p.terms)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One answerable source view: a named output of a session handle (or
    of a router cache entry), with its tensor shape."""

    handle: object              # ViewHandle owning the view
    view: str                   # view (query) name within the handle
    shape: ViewShape
    maintained: bool            # epoch source (True) vs scan source


@dataclasses.dataclass
class RoutePlan:
    """The planner's verdict for one query (execution is the router's
    job).  ``secondary`` is always set for view-sourced answers — for
    exact matches it is the pure axis/column adapter (``is_exact``)."""

    tier: str                   # "exact" | "subsumed"
    source: Candidate
    secondary: SecondaryProgram


class AdaptivePlanner:
    """Stateless decision procedure; the router owns all caches."""

    def __init__(self, schema):
        self.schema = schema

    def target_shape(self, q: Query) -> ViewShape:
        return view_shape_of(q, self.schema)

    def candidates_of(self, handle, maintained: bool) -> List[Candidate]:
        """Expand a handle into per-view candidates.  Maintained handles
        only count once initialized — routing must never trigger an
        implicit full scan of an un-run maintained view."""
        if maintained and not handle.maintained.initialized:
            return []
        out = []
        for name, qo in handle.compiled.result.outputs.items():
            out.append(Candidate(
                handle=handle, view=name,
                shape=view_shape_of(qo.query, self.schema, name=name),
                maintained=maintained))
        return out

    def plan(self, q: Query, candidates: Sequence[Candidate], *,
             allow_maintained: bool = True) -> Optional[RoutePlan]:
        """Pick the cheapest sound answer, or None (miss → compile)."""
        target = self.target_shape(q)
        key = signature_of(q).key()
        exact_scan: Optional[Candidate] = None
        best_sub: Optional[Tuple[int, Candidate]] = None
        for c in candidates:
            if c.maintained and not allow_maintained:
                continue
            # handle.signatures() renders once per handle and caches
            c_key = c.handle.signatures()[c.view].key()
            if c_key == key:
                if c.maintained:
                    # epoch read: nothing beats it — decide immediately
                    return RoutePlan(
                        tier="exact", source=c,
                        secondary=build_secondary_program(c.shape, target))
                if exact_scan is None:
                    exact_scan = c
            elif c.maintained and subsumes(c.shape, target):
                cost = reagg_cost(c.shape)
                if best_sub is None or cost < best_sub[0]:
                    best_sub = (cost, c)
        if best_sub is not None:
            c = best_sub[1]
            return RoutePlan(
                tier="subsumed", source=c,
                secondary=build_secondary_program(c.shape, target))
        if exact_scan is not None:
            return RoutePlan(
                tier="exact", source=exact_scan,
                secondary=build_secondary_program(exact_scan.shape, target))
        return None

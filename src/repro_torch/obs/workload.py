"""Copy of ``repro/obs/workload.py`` for the PyTorch port: identical apart
from imports, so that a query renders to the same signature ``key()`` in
both packages.

Bounded in-memory workload recorder — the view advisor's input.

LMFAO's thesis is that a *batch* of aggregates shares structure; applying
it to a live workload (ROADMAP item 2: route ad-hoc queries to maintained
views, advise which wider views to materialize) first requires a record of
what the workload actually asked: which group-by signatures, through which
path (full scan, epoch read, pinned serving read), at what latency.  This
module captures exactly that.

A :class:`QuerySignature` is the *router key* of a query — its group-by
dims, its static filter predicates, and its aggregate shapes, all rendered
structurally (no callables, no array values) so signatures hash, compare,
and serialize stably across sessions.  Two queries with the same signature
are answerable by the same maintained view; a signature that keeps hitting
the fallback path is the advisor's materialization candidate.

The :class:`WorkloadRecorder` is a bounded ring (``capacity`` newest
records kept, older ones counted in ``n_dropped``) fed by every
``ViewHandle.run``/``run_batched`` and ``ViewServer.read`` call.  It is
process-local and lock-cheap — recording is one deque append — and exports
as JSON (``export_json``) in the shape the future advisor consumes:
per-signature hit counts, hit-path mix, and latency aggregates, plus the
raw trailing records.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import numbers
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.core.aggregates import (Constant, Delta, Lambda, Param, Pow,
                                   Query, Var)

__all__ = ["QuerySignature", "signature_of", "agg_renders", "routable",
           "WorkloadRecord", "WorkloadRecorder"]


def _norm_const(v) -> str:
    """Canonical render of a literal constant.  Numeric values normalize
    through float so ``Delta("x", "<", 5)`` and ``Delta("x", "<", 5.0)``
    (or a numpy scalar of either) produce the same signature — the router
    must not miss the cache on spelling."""
    if isinstance(v, numbers.Real) and not isinstance(v, bool):
        return repr(float(v))
    return repr(v)


def _render_term(t) -> str:
    if isinstance(t, Var):
        return t.attr
    if isinstance(t, Pow):
        return f"{t.attr}^{t.k}"
    if isinstance(t, Constant):
        if isinstance(t.value, Param):
            return f"?{t.value.name}"
        return _norm_const(t.value)
    if isinstance(t, Delta):
        # selection factors stay *inside* the aggregate render: two queries
        # share a signature only if each aggregate carries the same filters
        # (a query-level filter pool would conflate, e.g., one filtered +
        # one unfiltered column with the same filter applied to both)
        return f"1[{_render_filter(t)}]"
    if isinstance(t, Lambda):
        return f"udaf:{t.tag or 'anon'}({','.join(t.attr_order)})"
    return repr(t.key())


def _render_filter(t: Delta) -> str:
    thr = t.threshold
    rhs = f"?{thr.name}" if isinstance(thr, Param) else _norm_const(thr)
    return f"{t.attr}{t.op}{rhs}"


@dataclasses.dataclass(frozen=True)
class QuerySignature:
    """Structural identity of a group-by aggregate query: what the serving
    router matches on and the advisor aggregates over."""

    dims: Tuple[str, ...]       # group-by attributes, sorted
    filters: Tuple[str, ...]    # rendered Delta predicates, sorted+deduped
                                # (advisor-facing rollup; matching uses the
                                # per-aggregate renders, where filters are
                                # inline factors)
    aggs: Tuple[str, ...]       # one canonical sum-of-products render per
                                # aggregate, sorted

    def key(self) -> str:
        """Stable string form (dict key / JSON field)."""
        return (f"dims[{','.join(self.dims)}]"
                f"|filters[{','.join(self.filters)}]"
                f"|aggs[{';'.join(self.aggs)}]")

    def to_dict(self) -> Dict[str, list]:
        return {"dims": list(self.dims), "filters": list(self.filters),
                "aggs": list(self.aggs)}


def _render_agg(a) -> str:
    """Canonical sum-of-products render of one aggregate.  Multiplication
    and addition commute, so term renders sort within each product and
    product renders sort within the sum — semantically identical aggregates
    written in different orders render identically."""
    prods = []
    for p in a.products:
        terms = sorted(_render_term(t) for t in p.terms)
        prods.append("*".join(terms) if terms else "1")
    return "+".join(sorted(prods))


def agg_renders(q: Query) -> Tuple[str, ...]:
    """Canonical render of each aggregate **in query order** — the router's
    column map: position i of the query's output agg axis carries the
    aggregate rendered as ``agg_renders(q)[i]``."""
    return tuple(_render_agg(a) for a in q.aggregates)


def signature_of(q: Query) -> QuerySignature:
    """Extract a query's canonical signature.  Group-by order only permutes
    output axes and aggregate order only permutes output columns, so both
    sort: two queries share a ``key()`` iff they are answerable from each
    other by an axis/column shuffle.  ``filters`` is a derived rollup of the
    ``Delta`` factors (sorted, deduped) kept for the advisor; matching
    soundness lives in the per-aggregate renders where each filter stays
    attached to its aggregate."""
    filters = set()
    for a in q.aggregates:
        for p in a.products:
            for t in p.terms:
                if isinstance(t, Delta):
                    filters.add(_render_filter(t))
    return QuerySignature(dims=tuple(sorted(q.group_by)),
                          filters=tuple(sorted(filters)),
                          aggs=tuple(sorted(agg_renders(q))))


def routable(q: Query) -> bool:
    """Whether the query's signature is a *sound* routing key.  Untagged
    ``Lambda`` UDAFs render as ``udaf:anon(...)`` — two different callables
    collide — so queries carrying one must bypass signature matching and
    the plan cache (the router answers them with a one-shot fallback
    scan)."""
    for a in q.aggregates:
        for p in a.products:
            for t in p.terms:
                if isinstance(t, Lambda) and not t.tag:
                    return False
    return True


@dataclasses.dataclass(frozen=True)
class WorkloadRecord:
    """One observed call: which view, through which path, how slow."""

    ts: float                   # wall-clock (time.time) at record time
    kind: str                   # "run" | "run_batched" | "read"
    view: str                   # registered view (query) name
    signature: QuerySignature
    hit: str                    # "full_scan" | "epoch_read" | "batch_scan"
                                # | "sharded_scan" | "pinned_read"
    latency_us: float           # host dispatch wall (no device sync)
    epoch: Optional[int] = None
    route: Optional[str] = None  # router tier for routed queries: "exact" |
                                 # "subsumed" | "compiled" | "fallback_scan";
                                 # None for direct (non-routed) calls

    def to_dict(self) -> Dict[str, object]:
        return {"ts": self.ts, "kind": self.kind, "view": self.view,
                "signature": self.signature.to_dict(), "hit": self.hit,
                "latency_us": self.latency_us, "epoch": self.epoch,
                "route": self.route}


class WorkloadRecorder:
    """Bounded ring of :class:`WorkloadRecord`; ``capacity=0`` disables
    recording entirely (every ``record`` is a cheap no-op)."""

    def __init__(self, capacity: int = 4096):
        if capacity < 0:
            raise ValueError("workload recorder capacity must be >= 0")
        self.capacity = capacity
        # maxlen=0 (disabled) keeps the ring genuinely empty — a disabled
        # recorder allocates nothing beyond this empty deque
        self._records: "collections.deque[WorkloadRecord]" = \
            collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        #: total records ever observed (including those rotated out)
        self.n_recorded = 0

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    @property
    def n_dropped(self) -> int:
        return self.n_recorded - len(self._records)

    def record(self, kind: str, view: str, signature: QuerySignature,
               hit: str, latency_us: float,
               epoch: Optional[int] = None,
               route: Optional[str] = None) -> None:
        if not self.capacity:
            return
        rec = WorkloadRecord(ts=time.time(), kind=kind, view=view,
                             signature=signature, hit=hit,
                             latency_us=latency_us, epoch=epoch,
                             route=route)
        with self._lock:
            self._records.append(rec)
            self.n_recorded += 1

    def records(self) -> List[WorkloadRecord]:
        with self._lock:
            return list(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self.n_recorded = 0

    # -- advisor-facing aggregation ------------------------------------------

    def by_signature(self) -> Dict[str, Dict[str, object]]:
        """Per-signature rollup: call count, hit-path mix, latency mean/max,
        and the views answering it — the advisor's ranking input."""
        out: Dict[str, Dict[str, object]] = {}
        for rec in self.records():
            key = rec.signature.key()
            e = out.get(key)
            if e is None:
                e = out[key] = {"signature": rec.signature.to_dict(),
                                "n": 0, "views": set(), "hits": {},
                                "routes": {},
                                "latency_us_sum": 0.0, "latency_us_max": 0.0}
            e["n"] += 1
            e["views"].add(rec.view)
            e["hits"][rec.hit] = e["hits"].get(rec.hit, 0) + 1
            if rec.route is not None:
                e["routes"][rec.route] = e["routes"].get(rec.route, 0) + 1
            e["latency_us_sum"] += rec.latency_us
            e["latency_us_max"] = max(e["latency_us_max"], rec.latency_us)
        for e in out.values():
            e["views"] = sorted(e["views"])
            e["latency_us_mean"] = e.pop("latency_us_sum") / e["n"]
        return out

    def to_payload(self) -> Dict[str, object]:
        return {"capacity": self.capacity, "n_recorded": self.n_recorded,
                "n_dropped": self.n_dropped,
                "signatures": self.by_signature(),
                "records": [r.to_dict() for r in self.records()]}

    def export_json(self, path: Optional[str] = None) -> Dict[str, object]:
        """The advisor input: write ``path`` if given, return the payload."""
        payload = self.to_payload()
        if path is not None:
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        return payload

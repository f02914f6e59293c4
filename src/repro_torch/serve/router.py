"""Signature router: the serving front door for ad-hoc aggregates;
counterpart of ``repro/serve/router.py``.

``Database.query(q)`` / ``ViewServer.query(q)`` accept an *arbitrary*
group-by aggregate — not just the batches a session compiled up front —
and answer it through these tiers:

    exact          the query's canonical signature matches an answerable
                   source (registered view or cached compiled plan); the
                   answer is an axis/column shuffle of that view's tensor
    subsumed       a wider maintained view subsumes it; the answer is a
                   verified secondary program re-aggregating the epoch
                   tensor on the device (``core/subsume.py``) — no base scan
    compiled       a miss: a fresh single-query plan is compiled through
                   the normal ``_compile`` path, admission-gated by the
                   static verifier, cached (bounded LRU), and answered
                   from its one-shot shared scan (``fused_scan_block``)
    fallback_scan  a one-shot compile-and-scan that is *not* cached:
                   unroutable queries (untagged UDAFs have no stable
                   signature) or a cache disabled with capacity 0

Epoch consistency: every maintained-source answer reads one pinned epoch
(``MaintainedBatch.pinned()``), so a routed answer is never torn across a
concurrent ``apply``.  Scan-tier answers (exact-on-cached, compiled,
fallback_scan) read ``Database.data`` — the session's base-relation
snapshot, which delta folds do NOT advance (maintained state keeps its
own resident copy).  A driver that folds updates and also expects fresh
*scan* answers must keep ``Database.data`` current (``apply_delta``).

Under the session's mesh a scan tier runs domain-parallel and records
``"sharded_scan"`` (else ``"batch_scan"``); hit tiers read the replicated
epoch and launch nothing.

Answers stay tensors on the session's device: the router never copies one
to the host, and a hit-tier route (exact or subsumed on a maintained
source, once its index tensors are built) does not wait for the card.

Every routed query records its tier + latency into the session's
``WorkloadRecorder`` (``route=`` field).

Admission gate: every plan this router compiles — cached or one-shot —
passes ``analysis.verify.verify_plan`` *unconditionally* (the session's
``verify_plans`` tri-state does not apply), and every secondary program
passes ``verify_secondary_program`` before lowering.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.verify import verify_plan, verify_secondary_program
from repro_torch.core.aggregates import Params, Query
from repro_torch.core.subsume import lower_secondary
from repro_torch.obs.metrics import Registry
from repro_torch.obs.workload import QuerySignature, routable, signature_of
from repro_torch.serve.planner import (AdaptivePlanner, Candidate, RoutePlan,
                                 has_batched_params)

__all__ = ["RouteResult", "QueryRouter"]

#: routed-tier labels (also the ``WorkloadRecord.route`` vocabulary)
TIERS = ("exact", "subsumed", "compiled", "fallback_scan")


@dataclasses.dataclass
class RouteResult:
    """One routed answer plus how it was produced (``Database.route``)."""

    query: str                  # the asking query's name
    tier: str                   # one of TIERS
    value: object               # the dense answer tensor (on the device)
    signature: QuerySignature
    source: Optional[str]       # answering view name (None for tier 3/4)
    epoch: Optional[int]        # pinned epoch for maintained sources
    latency_us: float           # host dispatch wall (no device sync)
    scanned: bool               # True iff base relations were scanned


class _CacheEntry:
    __slots__ = ("handle", "hits")

    def __init__(self, handle):
        self.handle = handle
        self.hits = 0           # per-signature hit counter


class QueryRouter:
    """Bounded-LRU routing engine owned by a
    :class:`~repro_torch.api.Database`.

    Thread-safe: planning and cache maintenance run under one lock;
    answer execution relies on the epoch-pin machinery (reads) and each
    handle's own dispatch path (scans)."""

    def __init__(self, database, capacity: int = 32):
        if not isinstance(capacity, int) or isinstance(capacity, bool) \
                or capacity < 0:
            raise ValueError("route cache capacity must be an int >= 0 "
                             "(0 disables caching)")
        self._db = database
        self.capacity = capacity
        self.planner = AdaptivePlanner(database.schema)
        self._lock = threading.RLock()
        self._cache: "collections.OrderedDict[str, _CacheEntry]" = \
            collections.OrderedDict()
        self._cached_ids: Dict[int, str] = {}   # id(handle) -> cache key
        self._cand_cache: Dict[int, List[Candidate]] = {}
        self._secondary: Dict[Tuple[int, object], object] = {}
        # telemetry: tier counters + routed-latency distribution
        self.n_queries = 0
        self.tier_counts: Dict[str, int] = {t: 0 for t in TIERS}
        self.n_plans_compiled = 0
        self.n_evictions = 0
        self.n_admission_checks = 0
        self.n_admission_failures = 0
        self.n_base_scans = 0
        self.n_reaggs = 0
        self.metrics = Registry()
        self._route_hist = self.metrics.histogram("route.us")

    # -- candidate enumeration ----------------------------------------------

    def _candidates(self) -> List[Candidate]:
        out: List[Candidate] = []
        sources = [(h, h.is_maintained) for h in self._db._registered]
        sources += [(e.handle, False) for e in self._cache.values()]
        for h, maintained in sources:
            ck = id(h)
            cands = self._cand_cache.get(ck)
            if cands is None:
                cands = self.planner.candidates_of(h, maintained)
                # an uninitialized maintained handle expands to nothing —
                # don't cache that, it becomes answerable after its first
                # full scan
                if cands or not maintained:
                    self._cand_cache[ck] = cands
            out.extend(cands)
        return out

    # -- admission-gated compilation ----------------------------------------

    def _compile_fresh(self, q: Query):
        """One fresh single-query plan through the session's normal
        compile path (NOT registered — the router's cache owns it)."""
        return self._db.views([q], register=False)

    def _admit(self, handle) -> None:
        """The admission gate: a serving-time compile is a plan no human
        reviewed, so it must pass the static verifier before it answers
        anything or enters the cache — unconditionally, whatever the
        session's ``verify_plans`` setting."""
        self.n_admission_checks += 1
        try:
            verify_plan(handle.compiled.plan)
        except Exception:
            self.n_admission_failures += 1
            raise

    def _secondary_fn(self, cand: Candidate, sp):
        """Verified, lowered, and cached once per (source handle,
        program) — repeat hits reuse the lowered function and its index
        tensor."""
        key = (id(cand.handle), sp)
        fn = self._secondary.get(key)
        if fn is None:
            self.n_admission_checks += 1
            try:
                verify_secondary_program(sp)
            except Exception:
                self.n_admission_failures += 1
                raise
            fn = lower_secondary(sp)
            self._secondary[key] = fn
        return fn

    # -- cache maintenance ---------------------------------------------------

    def _cache_insert(self, key: str, handle) -> None:
        self._cache[key] = _CacheEntry(handle)
        self._cached_ids[id(handle)] = key
        while len(self._cache) > self.capacity:
            old_key, old = self._cache.popitem(last=False)
            self._evict(old_key, old)

    def _evict(self, key: str, entry: _CacheEntry) -> None:
        self.n_evictions += 1
        hid = id(entry.handle)
        self._cached_ids.pop(hid, None)
        self._cand_cache.pop(hid, None)
        for k in [k for k in self._secondary if k[0] == hid]:
            del self._secondary[k]

    def _touch(self, handle) -> Optional[str]:
        """LRU bump + hit count when the answering handle is cached."""
        key = self._cached_ids.get(id(handle))
        if key is not None:
            entry = self._cache[key]
            entry.hits += 1
            self._cache.move_to_end(key)
        return key

    # -- execution -----------------------------------------------------------

    def _execute(self, plan: RoutePlan, params: Optional[Params]):
        cand = plan.source
        fn = self._secondary_fn(cand, plan.secondary)
        if cand.maintained:
            mb = cand.handle.maintained
            with mb.pinned() as epoch:
                value = fn(mb.results(epoch=epoch)[cand.view])
            if not plan.secondary.is_exact:
                self.n_reaggs += 1
            return value, epoch, "epoch_read", False
        out = cand.handle.run(params)
        self.n_base_scans += 1
        return fn(out[cand.view]), None, self._scan_hit(), True

    def _scan_hit(self) -> str:
        """How a base scan ran: sharded under the session's mesh."""
        return ("sharded_scan" if self._db.config.mesh is not None
                else "batch_scan")

    def _compile_and_run(self, q: Query, params: Optional[Params],
                         cache: bool):
        handle = self._compile_fresh(q)
        self.n_plans_compiled += 1
        self._admit(handle)
        if cache:
            self._cache_insert(signature_of(q).key(), handle)
        out = handle.run(params)
        self.n_base_scans += 1
        return out[q.name], self._scan_hit()

    # -- front door ----------------------------------------------------------

    def route(self, q: Query, params: Optional[Params] = None) -> RouteResult:
        """Answer an arbitrary group-by aggregate; returns the value plus
        tier / source / epoch provenance.  ``Database.query`` is the
        value-only convenience wrapper."""
        if has_batched_params(q):
            raise ValueError(
                f"query {q.name!r} carries batched params; the router "
                "serves scalar-param queries — use db.views([q])"
                ".run_batched(params) for the node-frontier axis")
        t0 = time.perf_counter()
        sig = signature_of(q)
        source = epoch = None
        with self._lock:
            self.n_queries += 1
            if not routable(q):
                # untagged UDAFs have no stable signature: never matched,
                # never cached — one verified compile-and-scan
                tier = "fallback_scan"
                value, hit = self._compile_and_run(q, params, cache=False)
                scanned = True
            else:
                plan = self.planner.plan(q, self._candidates(),
                                         allow_maintained=not params)
                if plan is not None:
                    tier = plan.tier
                    value, epoch, hit, scanned = self._execute(plan, params)
                    source = plan.source.view
                    self._touch(plan.source.handle)
                else:
                    cache = self.capacity > 0
                    tier = "compiled" if cache else "fallback_scan"
                    value, hit = self._compile_and_run(q, params,
                                                       cache=cache)
                    scanned = True
            self.tier_counts[tier] += 1
        us = (time.perf_counter() - t0) * 1e6
        self._route_hist.observe(us)
        rec = self._db.workload
        if rec.enabled:
            rec.record("query", q.name, sig, hit, us, epoch=epoch,
                       route=tier)
        return RouteResult(query=q.name, tier=tier, value=value,
                           signature=sig, source=source, epoch=epoch,
                           latency_us=us, scanned=scanned)

    # -- telemetry -----------------------------------------------------------

    @property
    def hit_rate(self) -> float:
        """Fraction of routed queries answered without compiling a fresh
        plan (tiers exact + subsumed)."""
        if not self.n_queries:
            return 0.0
        hits = self.tier_counts["exact"] + self.tier_counts["subsumed"]
        return hits / self.n_queries

    def cache_stats(self) -> List[Dict[str, object]]:
        """Per-signature hit counters, LRU order (oldest first)."""
        with self._lock:
            return [{"signature": k, "hits": e.hits}
                    for k, e in self._cache.items()]

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {"n_queries": self.n_queries,
                    "tiers": dict(self.tier_counts),
                    "hit_rate": self.hit_rate,
                    "cache_size": len(self._cache),
                    "capacity": self.capacity,
                    "n_plans_compiled": self.n_plans_compiled,
                    "n_evictions": self.n_evictions,
                    "n_admission_checks": self.n_admission_checks,
                    "n_admission_failures": self.n_admission_failures,
                    "n_base_scans": self.n_base_scans,
                    "n_reaggs": self.n_reaggs,
                    "route_us": self._route_hist.snapshot(),
                    "cache": self.cache_stats()}

"""Incremental view maintenance: delta programs over the materialized view
DAG; counterpart of ``repro/core/ivm.py``.
The static verifier checks every delta and tick program once, when it is
built, and every resident relation at init, publish and restore, when
``verify_plans`` is on (``MaintainedBatch.last_verifications``).  The
reference's spans (``ivm.init``,
``ivm.apply``, ``ivm.validate``, ``ivm.tick``, ``ivm.publish``) and its
``ivm.tick_us`` histogram ride along, on host clocks only.

A maintained batch (``Database.views(queries, maintain=True)``) keeps every
view's dense accumulator as **persistent state** and, per base relation,
derives a **delta program**: the sub-DAG of views transitively reachable
from that relation, re-derived so that an update batch (inserts and deletes
with signed multiplicities) folds into the stored view tensors with work
proportional to the update, not the database.

Soundness for the engine's SUM-of-products aggregates, updating relation R:

* every view is linear in the rows of its scanned relation, so a view
  scanning R is maintained by running its *unchanged* scan program over the
  delta tuples only, with per-row weights +1 (insert) / -1 (delete) folded
  into the validity (``lowering/cuda.py``'s ``run_step(weights=...)``);
* a view scanning S ≠ R sees R through **exactly one** child edge — join-tree
  subtrees below distinct children are disjoint, so the product rule
  collapses to first order: ``Δ(terms × c_R × rest) = terms × Δc_R × rest``.
  The delta view rescans S, gathering the child's *delta* in place of its
  value; products with no R-dependent factor are dropped, and columns left
  empty contribute zeros so the column layout is preserved.

State is **epoch-versioned and device-resident**: every epoch is an
:class:`EpochState` — view tensors plus capacity-padded
:class:`~repro_torch.data.relations.ResidentRelation` buffers — that is
never written after it is published.  Torch tensors are mutable, so that is
this module's discipline, not the library's: ``apply`` validates the whole
update batch up front, builds ``state + delta`` as new tensors and a new
buffer set for each advanced relation (the previous epoch is the read
buffer), and publishes the next epoch with one reference swap.  Readers
(``results``) resolve an epoch once and see a frozen snapshot; a failed
batch publishes nothing.  A steady-state tick copies the update to the
card once (pinned, asynchronous), runs a cached tick runner, and neither
copies relation columns to the host nor waits for the card.

With a ``mesh`` the batch is **sharded**: one relation (``shard_rel``,
default the largest) lives row-partitioned over ``mesh_axis`` as a
:class:`~repro_torch.data.relations.ShardedResidentRelation`, the rest
whole on every rank.  SPMD: every rank applies the same updates in the
same order.  Delta tuples of the sharded relation partition like its rows
(inserts round-robin, deletes routed by global row id), every view of a
step that scans partitioned rows is all-reduced over the axis right after
the step — before any later gather or the state fold, so the published
state is the same on every rank (psum-before-fold) — and compaction and
append never leave their shard.  The no-sync steady tick is unchanged; the
growth check's exact count is the one documented sync, and only when a
shard's upper bound would overflow its capacity.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Dict, FrozenSet, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.verify import (verification_enabled,
                                         verify_delta_program,
                                         verify_resident,
                                         verify_tick_program)
from repro_torch.core import distributed as shd
from repro_torch.core.engine import _params_on
from repro_torch.core.groups import ViewGroup
from repro_torch.core.ir import StepProgram, build_programs, fuse_programs
from repro_torch.core.plan import all_reduce_views
from repro_torch.core.pushdown import AggColSpec, ViewDef
from repro_torch.core.schedule import build_schedule
from repro_torch.core.schema import DatabaseSchema
from repro_torch.data.relations import (Database, DeltaBatchUpdate, Relation,
                                        ResidentRelation,
                                        ShardedResidentRelation,
                                        _resident_advance, check_delete_idx,
                                        check_update_columns, next_pow2)
from repro_torch.obs.metrics import Registry
from repro_torch.obs.trace import span


# ----------------------------------------------------------- delta derivation

def relation_reach(views: Mapping[int, ViewDef]) -> Dict[int, FrozenSet[str]]:
    """vid → set of base relations its value depends on (scanned relation
    plus, transitively, every child's).  Memoized walk over the view DAG."""
    memo: Dict[int, FrozenSet[str]] = {}

    def reach(vid: int) -> FrozenSet[str]:
        if vid not in memo:
            w = views[vid]
            s = {w.rel}
            for col in w.agg_cols:
                for prod in col.products:
                    for ref in prod.child_cols:
                        s |= reach(ref.vid)
            memo[vid] = frozenset(s)
        return memo[vid]

    for vid in views:
        reach(vid)
    return memo


@dataclasses.dataclass(frozen=True)
class DeltaStep:
    """One fused scan step of a delta program.  ``scans_delta`` steps scan
    the update's delta tuples (weighted); the rest rescan their full base
    relation against child *deltas*."""

    prog: StepProgram
    rel: str
    scans_delta: bool


@dataclasses.dataclass(frozen=True)
class DeltaProgram:
    """Compiled maintenance plan for updates to one base relation."""

    rel: str
    affected: FrozenSet[int]        # vids whose state the update changes
    steps: Tuple[DeltaStep, ...]
    base_rels: Tuple[str, ...]      # relations rescanned in full
    state_vids: Tuple[int, ...]     # state entries the runner needs as input

    @property
    def n_scans(self) -> int:
        return len(self.steps)

    def summary(self) -> str:
        return (f"Δ{self.rel}: {len(self.affected)} views, "
                f"{self.n_scans} scans ({sum(s.scans_delta for s in self.steps)} delta, "
                f"rescans {sorted(self.base_rels)})")


@dataclasses.dataclass(frozen=True)
class TickStep:
    """One step of a tick, with its runtime obligations made declarative:
    ``weighted`` steps fold the update's signed ±1 multiplicities into the
    validity; ``partitioned`` steps scan row-partitioned buffers, so their
    view deltas in ``psum_vids`` must be all-reduced over the mesh axis
    *before* any later gather or the state fold reads them."""

    prog: StepProgram
    rel: str
    scans_delta: bool
    weighted: bool
    partitioned: bool
    psum_vids: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class TickProgram:
    """The declarative form of one relation's tick: which steps apply
    update weights, which all-reduce, and which vids the state fold
    covers.  Both tick runners (local and sharded) execute exactly this
    artifact, so psum-before-fold is data the verifier can check."""

    rel: str
    axis: Optional[str]             # mesh axis name (None = unsharded)
    shard_rel: Optional[str]        # row-partitioned relation (None = local)
    steps: Tuple[TickStep, ...]
    fold_vids: Tuple[int, ...]      # state entries the fold writes

    def summary(self) -> str:
        n_psum = sum(len(ts.psum_vids) for ts in self.steps)
        shard = f", {n_psum} psums @{self.axis}" if self.shard_rel else ""
        return (f"tick Δ{self.rel}: {len(self.steps)} steps, "
                f"folds {len(self.fold_vids)} views{shard}")


def build_tick_program(dp: DeltaProgram, shard_rel: Optional[str] = None,
                       axis: Optional[str] = None) -> TickProgram:
    """Lower a delta program to its tick form under a placement: weights
    ride exactly the delta-tuple scans, and under a mesh every step that
    scans the partitioned relation (a delta scan of its partitioned delta
    tuples, or a rescan of its partitioned rows) all-reduces all of its
    view deltas immediately.  Pure — built and verified without a mesh."""
    steps = []
    for st in dp.steps:
        partitioned = shard_rel is not None and st.rel == shard_rel
        steps.append(TickStep(
            prog=st.prog, rel=st.rel, scans_delta=st.scans_delta,
            weighted=st.scans_delta, partitioned=partitioned,
            psum_vids=(tuple(vp.vid for vp in st.prog.views)
                       if partitioned else ())))
    return TickProgram(rel=dp.rel, axis=axis, shard_rel=shard_rel,
                       steps=tuple(steps),
                       fold_vids=tuple(sorted(dp.affected)))


def build_delta_program(schema: DatabaseSchema, views: Mapping[int, ViewDef],
                        rel: str, fuse: bool = True) -> DeltaProgram:
    """Derive the delta program for updates to base relation ``rel``."""
    reach = relation_reach(views)
    affected = frozenset(vid for vid, rs in reach.items() if rel in rs)
    if not affected:
        return DeltaProgram(rel=rel, affected=affected, steps=(),
                            base_rels=(), state_vids=())

    # delta view defs: tier-1 (scan rel) keep every product — they are linear
    # in rel's rows; tier-2 keep only products with an affected child factor
    delta_defs: Dict[int, ViewDef] = {}
    for vid in affected:
        w = views[vid]
        if w.rel == rel:
            delta_defs[vid] = w
            continue
        cols = []
        for colspec in w.agg_cols:
            kept = []
            for p in colspec.products:
                hit = [r for r in p.child_cols if r.vid in affected]
                if not hit:
                    continue            # R-independent product: delta is zero
                if len(hit) > 1:
                    # would need second-order delta terms; cannot happen for
                    # join-tree pushdown (subtrees below distinct children
                    # are disjoint), so treat it as a soundness bug
                    raise ValueError(
                        f"view {vid}: product with {len(hit)} {rel}-dependent "
                        "factors — first-order delta derivation is unsound")
                kept.append(p)
            cols.append(AggColSpec(tuple(kept)))
        delta_defs[vid] = ViewDef(
            vid=w.vid, edge=w.edge, rel=w.rel, group_by=w.group_by,
            local_keys=w.local_keys, pulled_keys=w.pulled_keys, agg_cols=cols)

    # group the delta sub-DAG: peel dependency levels restricted to affected
    # vids, bucketing ready views per scanned relation (mirrors group_views)
    deps = {vid: {r.vid for col in delta_defs[vid].agg_cols
                  for p in col.products for r in p.child_cols} & affected
            for vid in affected}
    groups: List[ViewGroup] = []
    vid_group: Dict[int, int] = {}
    remaining, done = set(affected), set()
    level = 0
    while remaining:
        ready = sorted(v for v in remaining if deps[v] <= done)
        if not ready:
            raise ValueError("cyclic delta-view dependencies (bug)")
        buckets: Dict[str, List[int]] = {}
        for vid in ready:
            buckets.setdefault(delta_defs[vid].rel, []).append(vid)
        for r in sorted(buckets):
            vids = tuple(buckets[r])
            gdeps = sorted({vid_group[d] for vid in vids for d in deps[vid]})
            gid = len(groups)
            groups.append(ViewGroup(gid=gid, rel=r, vids=vids, level=level,
                                    deps=tuple(gdeps)))
            for vid in vids:
                vid_group[vid] = gid
        done.update(ready)
        remaining.difference_update(ready)
        level += 1

    # lower through the existing IR builder + shared-scan scheduler; child
    # gather specs only need the (unchanged) group_by of each child ViewDef
    merged = dict(views)
    merged.update(delta_defs)
    progs = build_programs(schema, merged, groups)
    sched = build_schedule(groups, fuse=fuse)
    # a fused step scans one relation, so it is either all-delta (rel == R:
    # every view scanning R is tier-1) or all-base — never mixed
    steps = tuple(DeltaStep(prog=fuse_programs([progs[gid] for gid in st.gids]),
                            rel=st.rel, scans_delta=(st.rel == rel))
                  for st in sched.steps)
    base_rels = tuple(sorted({s.rel for s in steps if not s.scans_delta}))
    gathered = {gs.vid for s in steps for gs in s.prog.gathers}
    return DeltaProgram(rel=rel, affected=affected, steps=steps,
                        base_rels=base_rels,
                        state_vids=tuple(sorted(affected | gathered)))


# -------------------------------------------------------------- maintenance

class EpochEvictedError(KeyError):
    """A read hit an epoch whose pin was evicted under the
    ``max_pinned_epochs`` budget.  Long-lived pins retain whole epochs of
    device memory, so the budget force-releases the least-recently-used pin
    once exceeded; a reader holding an evicted handle must re-snapshot."""


@dataclasses.dataclass(frozen=True)
class EpochState:
    """One published version of the maintained state: every view tensor
    plus every base relation's resident buffers.  Never written after
    ``apply`` publishes it, so any number of readers holding (or pinning)
    an epoch see a frozen, mutually consistent snapshot."""

    epoch: int
    step: int
    views: Mapping[int, torch.Tensor]
    relations: Mapping[str, ResidentRelation]

    def database(self, schema) -> Database:
        return Database(schema, {name: rr.to_relation()
                                 for name, rr in self.relations.items()})


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host array on ``device``: on the card through pinned memory and
    an asynchronous copy, so the caller does not wait for the card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class MaintainedBatch:
    """A compiled aggregate batch with epoch-versioned, device-resident view
    state and per-base-relation delta programs.

        mb = handle.maintained          # Database.views(qs, maintain=True)
        mb.init(db)                     # full scan; state on the device
        mb.apply(update)                # work ∝ |update|; publishes epoch+1
        results = mb.results()          # current epoch
        e = mb.pin(); ... mb.results(epoch=e) ...; mb.unpin(e)

    ``apply`` is transactional: the **whole** update batch is validated
    before anything folds, the fold only builds new tensors (one cached
    tick runner per updated relation: delta-tuple assembly, delta scans,
    the state fold and the relation's compaction/append), and the new epoch
    becomes visible in one reference swap — so an invalid batch is a clean
    no-op and readers never observe half-folded state.

    Runners are cached on (relation, pad buckets, capacities): delta
    batches pad to the next power of two with zero-weight rows and resident
    buffers grow by doubling, so a stream of varying batch sizes against
    growing relations builds at most log₂ runners per relation and a
    steady-state tick builds none (``n_fold_traces`` counts the builds).

    With a ``mesh`` the batch is sharded over ``mesh_axis`` (the module's
    docstring): ``shard_rel`` is fixed at the first init or restore."""

    def __init__(self, batch, device=None, mesh=None,
                 mesh_axis: str = "data", shard_rel: Optional[str] = None):
        self.batch = batch
        self.plan = batch.plan
        if self.plan.batched_params:
            raise ValueError(
                "incremental maintenance does not support param-batched "
                f"plans (batched params: {sorted(self.plan.batched_params)})")
        #: the device of the state; ``init`` takes the relations'
        self.device = None if device is None else torch.device(device)
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        if mesh is not None:
            shd.check_axis(mesh, mesh_axis)
        self.shard_rel = shard_rel    # resolved at first init/load_state
        self._ax: Optional[shd.AxisInfo] = None
        self._current: Optional[EpochState] = None
        #: delta scan steps executed across all applied updates
        self.n_delta_scan_steps = 0
        #: tick-runner builds (steady-state applies must not grow this)
        self.n_fold_traces = 0
        self._delta_programs: Dict[str, DeltaProgram] = {}
        self._tick_programs: Dict[str, TickProgram] = {}
        # static verification: checked once per compiled artifact when it
        # is built — never on the per-tick hot path
        self._verify = verification_enabled(self.plan.config.verify_plans)
        #: artifact name -> :class:`~repro_torch.analysis.verify.
        #: VerificationReport` for every delta/tick program verified so far
        #: (``explain()`` shows them); empty when verification is off
        self.last_verifications: Dict[str, object] = {}
        self._runners: Dict[Tuple, object] = {}
        # epoch -> [EpochState, refs]; ordered LRU-first (reads/pins
        # move_to_end) so the pin budget can evict the coldest epoch
        self._pins: "collections.OrderedDict[int, list]" = \
            collections.OrderedDict()
        self._pin_lock = threading.Lock()
        #: pin budget: beyond this many distinct pinned epochs the LRU pin
        #: is force-released (None = unbounded)
        self.max_pinned_epochs: Optional[int] = None
        #: pins force-released under the budget (reads of those epochs
        #: raise :class:`EpochEvictedError`)
        self.n_evicted_pins = 0
        # evicted epoch ids, newest last, for clear read errors; bounded by
        # trimming the oldest records into _evicted_floor
        self._evicted: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self._evicted_floor = -1      # every evicted epoch <= this is trimmed
        #: per-batch telemetry: ``ivm.tick_us`` is the host dispatch wall of
        #: each ``apply`` — no sync, so it reads what the host spends
        self.metrics = Registry()
        self._tick_hist = self.metrics.histogram("ivm.tick_us")

    # -- lifecycle -----------------------------------------------------------

    def _require(self) -> EpochState:
        es = self._current
        if es is None:
            raise ValueError("call init(db) first")
        return es

    @property
    def initialized(self) -> bool:
        """Whether an epoch has been published (init/restore has run)."""
        return self._current is not None

    @property
    def epoch(self) -> int:
        """Id of the currently published epoch."""
        return self._require().epoch

    @property
    def step(self) -> int:
        """Update batches applied since (or encoded in) the last init/restore."""
        es = self._current
        return es.step if es is not None else 0

    @property
    def state(self) -> Optional[Dict[int, torch.Tensor]]:
        """The current epoch's view tensors keyed by vid (None before
        init/restore)."""
        es = self._current
        return dict(es.views) if es is not None else None

    @property
    def db(self) -> Database:
        """Current database snapshot (base relations after applied updates;
        columns are views of the resident buffers)."""
        return self._require().database(self.batch.schema)

    def _axis(self) -> shd.AxisInfo:
        """The mesh axis as this rank sees it (group, size, index)."""
        if self._ax is None:
            self._ax = shd.axis_info(self.mesh, self.mesh_axis)
        return self._ax

    def _resolve_shard_rel(self, sizes: Mapping[str, int]) -> str:
        """Fix the partitioned relation (config override or the largest)
        the first time state materializes; frozen afterwards so runner
        caches and epochs agree."""
        if self.shard_rel is None:
            self.shard_rel = max(sorted(sizes), key=lambda r: sizes[r])
        elif self.shard_rel not in sizes:
            raise ValueError(f"shard_rel {self.shard_rel!r} is not a "
                             f"relation (have: {sorted(sizes)})")
        return self.shard_rel

    def _make_resident(self, rel: Relation):
        """Relation → resident form under the batch's placement: this
        rank's shard of the partitioned relation, every other whole."""
        if self.mesh is not None and rel.name == self.shard_rel:
            return ShardedResidentRelation.from_relation(rel, self._axis())
        return ResidentRelation.from_relation(rel)

    @property
    def is_writer(self) -> bool:
        """Whether this process writes checkpoints: always without a mesh,
        global rank 0 under one (every rank holds the same state)."""
        return self.mesh is None or dist.get_rank() == 0

    def checkpoint_barrier(self) -> None:
        """Under a mesh, wait until every rank has reached this point (the
        writer after its write): an ``all_reduce`` of one element on the
        default group, read on the host — a documented sync of the
        checkpoint path, never of a tick."""
        if self.mesh is not None:
            t = torch.zeros(1, device=self.device)
            dist.all_reduce(t)
            t.cpu()

    def init(self, db: Database, params=None) -> Dict[str, torch.Tensor]:
        """Full recompute: move every base relation into capacity-padded
        buffers and materialize every view, then publish the first epoch.
        Re-init on a live batch publishes a fresh epoch (the epoch clock
        keeps counting so pinned readers stay unambiguous).  Scans read
        each relation's live rows only; under a mesh the partitioned
        relation's views are all-reduced right after their step."""
        with span("ivm.init"):
            self.device = db.device
            if self.mesh is not None:
                self._resolve_shard_rel(db.sizes())
            rels = {name: self._make_resident(r)
                    for name, r in db.relations.items()}
            if self._verify:
                for rr in rels.values():
                    verify_resident(rr)
            views = self._full_scan(rels, _params_on(params, self.device))
            prev = self._current
            self._current = EpochState(epoch=prev.epoch + 1 if prev else 0,
                                       step=0, views=views, relations=rels)
        return self.results()

    def _full_scan(self, rels: Mapping[str, object], params):
        """Every view over the resident relations, this rank's shard of the
        partitioned one included (freshly laid out: its scanned prefix is
        exactly its live rows)."""
        run = self.plan.bind_arrays(
            {name: int(next(iter(rr.columns().values())).shape[0])
             for name, rr in rels.items()}, device=self.device)
        psum = ({self.shard_rel: self._axis().group}
                if self.mesh is not None else None)
        return dict(run({name: rr.columns() for name, rr in rels.items()},
                        params, psum_groups=psum))

    def epoch_state(self, epoch: Optional[int] = None) -> EpochState:
        """Resolve an epoch to its state: the published epoch by default, or
        a previously pinned one."""
        es = self._require()
        if epoch is None or epoch == es.epoch:
            return es
        with self._pin_lock:
            ent = self._pins.get(epoch)
            if ent is not None:
                self._pins.move_to_end(epoch)     # LRU touch
                return ent[0]
            if epoch in self._evicted or epoch <= self._evicted_floor:
                raise EpochEvictedError(
                    f"epoch {epoch} was evicted under the pin budget "
                    f"(max_pinned_epochs={self.max_pinned_epochs}); its "
                    "device state has been released — take a fresh "
                    "snapshot/pin to read current state")
        raise KeyError(
            f"epoch {epoch} is neither current ({es.epoch}) nor pinned — "
            "pin() an epoch before reading it across updates")

    def results(self, epoch: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Query outputs read from one epoch's state (no relation scans), on
        the state's device.  Always snapshot-consistent: every output comes
        from the same epoch."""
        return self.plan.extract_outputs(dict(self.epoch_state(epoch).views))

    # -- epoch pinning --------------------------------------------------------

    def pin(self) -> int:
        """Retain the current epoch for consistent reads across updates;
        returns its id.  Balance every pin with :meth:`unpin` — the epoch's
        device tensors stay alive while pinned.  With a
        ``max_pinned_epochs`` budget set, pinning past it force-releases
        the least-recently-used pinned epoch (its readers get
        :class:`EpochEvictedError`)."""
        es = self._require()
        with self._pin_lock:
            ent = self._pins.setdefault(es.epoch, [es, 0])
            ent[1] += 1
            self._pins.move_to_end(es.epoch)
            budget = self.max_pinned_epochs
            while budget is not None and len(self._pins) > budget:
                victim, _ = self._pins.popitem(last=False)   # LRU
                self._evicted[victim] = None
                self.n_evicted_pins += 1
                while len(self._evicted) > 1024:             # bound bookkeeping
                    old, _ = self._evicted.popitem(last=False)
                    self._evicted_floor = max(self._evicted_floor, old)
        return es.epoch

    def unpin(self, epoch: int) -> None:
        with self._pin_lock:
            ent = self._pins.get(epoch)
            if ent is None:
                if epoch in self._evicted or epoch <= self._evicted_floor:
                    return          # pin was force-released by the budget
                raise KeyError(f"epoch {epoch} is not pinned")
            ent[1] -= 1
            if ent[1] <= 0:
                del self._pins[epoch]

    @contextlib.contextmanager
    def pinned(self):
        """``with mb.pinned() as epoch:`` — pin for the block's duration."""
        epoch = self.pin()
        try:
            yield epoch
        finally:
            self.unpin(epoch)

    @property
    def n_pinned_epochs(self) -> int:
        with self._pin_lock:
            return len(self._pins)

    def pinned_epochs(self) -> Tuple[int, ...]:
        """Currently pinned epoch ids (ascending) — the server derives
        epoch lag (head minus oldest pin) from this."""
        with self._pin_lock:
            return tuple(sorted(self._pins))

    # -- delta path ----------------------------------------------------------

    def delta_program(self, rel: str) -> DeltaProgram:
        """The (cached) maintenance plan for updates to ``rel``."""
        if rel not in self._delta_programs:
            dp = build_delta_program(self.batch.schema, self.plan.views, rel,
                                     fuse=self.plan.config.fuse_scans)
            if self._verify:
                self.last_verifications[f"Δ{rel}"] = \
                    verify_delta_program(self.plan, dp)
            self._delta_programs[rel] = dp
        return self._delta_programs[rel]

    def tick_program(self, rel: str) -> TickProgram:
        """The (cached, verified) tick form of ``rel``'s delta program, the
        artifact the tick runner executes."""
        if rel not in self._tick_programs:
            dp = self.delta_program(rel)
            tp = (build_tick_program(dp) if self.mesh is None
                  else build_tick_program(dp, shard_rel=self.shard_rel,
                                          axis=self.mesh_axis))
            if self._verify:
                self.last_verifications[f"tick Δ{rel}"] = \
                    verify_tick_program(tp, dp)
            self._tick_programs[rel] = tp
        return self._tick_programs[rel]

    def apply(self, update: DeltaBatchUpdate, params=None) -> Dict[str, torch.Tensor]:
        """Fold an update batch into view state and the resident relations,
        publishing the next epoch; returns its results on the state's
        device.  Relations are processed in sorted order; the published
        state is ``init`` on the post-update database (up to float32
        summation order).

        Transactional: *every* relation's delta is validated before any
        state folds, so a rejected batch raises without publishing and the
        current epoch is untouched.  Any number of readers may overlap with
        one ``apply``; concurrent writers need external serialization."""
        cur = self._require()
        params = _params_on(params, self.device)
        t_tick = time.perf_counter()

        with span("ivm.apply", epoch=cur.epoch):
            # phase 1 — validate the whole batch against the current epoch
            # (host numpy on the update only; state untouched)
            with span("ivm.validate"):
                prepared = []
                for rel in update.relations():
                    if rel not in cur.relations:
                        raise ValueError(
                            f"update targets unknown relation {rel!r}")
                    rr = cur.relations[rel]
                    d = update.updates[rel]
                    ins = (check_update_columns(self.batch.schema, rel,
                                                d.inserts)
                           if d.n_inserts else None)
                    del_idx = (check_delete_idx(rel, d.delete_idx, rr.n_valid)
                               if d.n_deletes else None)
                    prepared.append((rel, ins, del_idx))

            # phase 2 — functional fold: new tensors only, the current epoch
            # readable throughout; the update's columns cross to the device
            # once, relation columns never cross back
            views = dict(cur.views)
            rels = dict(cur.relations)
            n_scans = 0
            for rel, ins, del_idx in prepared:
                with span("ivm.tick", rel=rel):
                    if self.mesh is not None and rel == self.shard_rel:
                        n_scans += self._apply_rel_mesh(views, rels, rel, ins,
                                                        del_idx, params)
                    else:
                        n_scans += self._apply_rel(views, rels, rel, ins,
                                                   del_idx, params)

            # phase 3 — publish: one reference swap; capacity contracts
            # re-checked on the advanced relations first (host metadata)
            if self._verify:
                for rel, _, _ in prepared:
                    verify_resident(rels[rel])
            with span("ivm.publish"):
                self._current = EpochState(epoch=cur.epoch + 1,
                                           step=cur.step + 1,
                                           views=views, relations=rels)
                self.n_delta_scan_steps += n_scans
        # host dispatch wall of the whole tick (validate + fold + publish);
        # no synchronize — the no-sync instrumentation rule
        self._tick_hist.observe((time.perf_counter() - t_tick) * 1e6)
        return self.results()

    def _apply_rel(self, views: Dict[int, torch.Tensor],
                   rels: Dict[str, ResidentRelation], rel: str, ins, del_idx,
                   params) -> int:
        """Fold one relation's validated delta into ``views`` and ``rels``
        (new tensors only); returns the delta scan steps it ran."""
        rr = rels[rel]
        n_ins = 0 if ins is None else len(next(iter(ins.values())))
        n_del = 0 if del_idx is None else len(del_idx)
        ins_pad = next_pow2(n_ins) if n_ins else 0
        del_pad = next_pow2(n_del) if n_del else 0
        ins_dev = {a: _to_device(np.pad(c, (0, ins_pad - n_ins)), self.device)
                   for a, c in (ins or {}).items()}
        # delete pads point at the capacity, as the reference's do: the
        # compaction reads only the first n_del, the gather clamps them
        del_dev = (_to_device(np.pad(del_idx.astype(np.int64),
                                     (0, del_pad - n_del),
                                     constant_values=rr.capacity),
                              self.device) if n_del else None)
        dp = self.delta_program(rel)
        if not dp.steps:
            rels[rel] = rr.advance(ins_dev, del_dev, n_ins, n_del)
            return 0
        cap = max(rr.capacity, next_pow2(max(rr.n_valid - n_del + n_ins, 1)))
        runner = self._tick_runner(dp, cap, ins_pad, del_pad, rels, params)
        new_views, rels[rel] = runner(
            {vid: views[vid] for vid in dp.state_vids}, rr, rels,
            ins_dev, del_dev, n_ins, n_del, params)
        views.update(new_views)
        return dp.n_scans

    def _tick_runner(self, dp: DeltaProgram, cap: int, ins_pad: int,
                     del_pad: int, rels: Mapping[str, ResidentRelation],
                     params):
        """The tick of one relation as one cached function: assemble the
        delta tuples ([insert block | deleted-row gather block], pads of
        weight 0), run the delta scans, add into view state, and advance
        the relation's resident buffers.

        Cache key: (relation, pad buckets, own and rescanned capacities,
        param names), the reference's; true row counts and delta sizes are
        arguments."""
        base_caps = {r: rels[r].capacity for r in dp.base_rels}
        key = (dp.rel, cap, ins_pad, del_pad,
               tuple(sorted(base_caps.items())), tuple(sorted(params)))
        if key in self._runners:
            return self._runners[key]
        self.n_fold_traces += 1
        n_delta = ins_pad + del_pad
        tp = self.tick_program(dp.rel)
        step_cfgs = self.plan.resolve_delta_configs(
            dp.steps, [n_delta if st.scans_delta else base_caps[st.rel]
                       for st in dp.steps], device=self.device)

        def run(state, rr, rels, ins, del_idx, n_ins, n_del, p):
            if del_pad:
                # the pads (at the capacity) read the last live row instead,
                # which their weight of 0 removes: an index past the buffer
                # would be a device-side assert on the card
                gather = del_idx.clamp(max=rr.n_valid - 1)
            delta_cols = {}
            for a, buf in rr.buffers.items():
                segs = []
                if ins_pad:
                    segs.append(ins[a])
                if del_pad:
                    segs.append(buf.index_select(0, gather))
                delta_cols[a] = torch.cat(segs) if len(segs) > 1 else segs[0]
            device = next(iter(delta_cols.values())).device
            w = []
            if ins_pad:
                w.append((torch.arange(ins_pad, device=device) < n_ins)
                         .to(torch.float32))
            if del_pad:
                w.append(-(torch.arange(del_pad, device=device) < n_del)
                         .to(torch.float32))
            weights = torch.cat(w) if len(w) > 1 else w[0]
            new_views = self._scan_steps(tp, step_cfgs, state, delta_cols,
                                         n_delta, weights, rels, p)
            bufs = _resident_advance(rr.buffers, rr.n_valid, ins, del_idx,
                                     n_ins, n_del, cap)
            return new_views, ResidentRelation(
                dp.rel, bufs, rr.n_valid - n_del + n_ins)

        self._runners[key] = run
        return run

    def _scan_steps(self, tp: TickProgram, step_cfgs, state, delta_cols,
                    n_delta: int, weights, rels, p):
        """A tick's steps and its state fold, as ``tp`` declares them:
        weighted steps scan the delta tuples, the rest rescan their base
        relation (a sharded one: this rank's prefix against its device
        count), and a partitioned step's view deltas are all-reduced
        before anything downstream reads them (psum-before-fold)."""
        backend = self.plan.backend
        # arrays doubles as state reads (unaffected children) and delta
        # writes: a step's finalize overwrites its vid, so a later gather
        # of an affected child reads its *delta*
        arrays = dict(state)
        for ts, cfg in zip(tp.steps, step_cfgs):
            if ts.scans_delta:
                backend.run_step(ts.prog, delta_cols, arrays, p,
                                 n_valid=n_delta, config=cfg,
                                 weights=weights if ts.weighted else None)
            else:
                base = rels[ts.rel]
                backend.run_step(ts.prog, base.columns(), arrays, p,
                                 n_valid=base.scan_valid, config=cfg)
            if ts.psum_vids:
                all_reduce_views(arrays, ts.psum_vids, self._axis().group)
        return {vid: state[vid] + arrays[vid] for vid in tp.fold_vids}

    # -- sharded delta path ---------------------------------------------------

    def _apply_rel_mesh(self, views: Dict[int, torch.Tensor],
                        rels: Dict[str, object], rel: str, ins, del_idx,
                        params) -> int:
        """One tick of the partitioned relation: stage the update (this
        rank's block of the round-robin insert layout; the sorted global
        delete positions, replicated), grow every shard together when a
        host upper bound would overflow its capacity (the one documented
        sync), then run the cached sharded tick runner.  Returns the delta
        scan steps it ran."""
        ax = self._axis()
        ndev = ax.size
        rr = rels[rel]
        n_ins = 0 if ins is None else len(next(iter(ins.values())))
        n_del = 0 if del_idx is None else len(del_idx)
        blk = next_pow2(-(-n_ins // ndev)) if n_ins else 0
        ins_pad = blk * ndev
        del_pad = next_pow2(n_del) if n_del else 0
        ins_dev = {a: shd.put_strided(c, blk, ax, self.device)
                   for a, c in (ins or {}).items()}
        del_dev = (shd.put_replicated(
            np.pad(np.sort(del_idx).astype(np.int64), (0, del_pad - n_del),
                   constant_values=shd.GID_SENTINEL), self.device)
            if n_del else None)
        # every shard's insert block lands behind its survivors, inside its
        # capacity: check the host bounds, and read the exact counts (a
        # sync) only when a bound would overflow
        if next_pow2(int(rr.n_valid_ub.max()) + blk) > rr.capacity:
            rr = rr.synced()
            rr = rr.grown(int(rr.n_valid_ub.max()) + blk)
        shares = np.asarray([shd.local_insert_count(n_ins, s, ndev, blk)
                             for s in range(ndev)], np.int64)
        dp = self.delta_program(rel)
        runner = self._tick_runner_mesh(dp, rr.capacity, ins_pad, del_pad,
                                        rels, params)
        new_views, rels[rel] = runner(
            {vid: views[vid] for vid in dp.state_vids}, rr, rels, ins_dev,
            del_dev, n_ins, n_del, shares, params)
        views.update(new_views)
        return dp.n_scans

    def _tick_runner_mesh(self, dp: DeltaProgram, cap: int, ins_pad: int,
                          del_pad: int, rels, params):
        """The sharded counterpart of :meth:`_tick_runner`, for the
        partitioned relation: assemble this rank's delta tuples (its insert
        block, its rows the delete batch hits), run the delta scans and
        all-reduce their views before the fold, and advance the shard
        (compaction and append inside it).  No host sync: the shard's live
        count and its deleted rows stay on the device.

        Cache key: the local one's with the mesh's marker — relation, pad
        buckets, capacities (the same on every rank), param names."""
        ax = self._axis()
        ndev, shard = ax.size, ax.index
        base_caps = {r: rels[r].capacity for r in dp.base_rels}
        key = ("mesh", dp.rel, cap, ins_pad, del_pad,
               tuple(sorted(base_caps.items())), tuple(sorted(params)))
        if key in self._runners:
            return self._runners[key]
        self.n_fold_traces += 1
        blk = ins_pad // ndev
        n_delta = blk + del_pad
        tp = self.tick_program(dp.rel)
        step_cfgs = self.plan.resolve_delta_configs(
            dp.steps, [n_delta if st.scans_delta else base_caps[st.rel]
                       for st in dp.steps], device=self.device)

        def run(state, rr, rels, ins, dels, n_ins, n_del, shares, p):
            n_scan = rr.n_scan
            k_ins = int(shares[shard])
            device = rr.gids.device
            if del_pad:
                live = torch.arange(n_scan, device=device) < rr.n_valid_dev
                hit, slots, n_del_loc = shd.local_delete(
                    rr.gids[:n_scan], live, dels, del_pad)
            else:
                hit = slots = None
            if dp.steps:
                delta_cols = {}
                for a, buf in rr.buffers.items():
                    segs = []
                    if blk:
                        segs.append(ins[a])
                    if del_pad:
                        segs.append(buf.index_select(0, slots))
                    delta_cols[a] = (torch.cat(segs) if len(segs) > 1
                                     else segs[0])
                w = []
                if blk:
                    w.append((torch.arange(blk, device=device) < k_ins)
                             .to(torch.float32))
                if del_pad:
                    w.append(-(torch.arange(del_pad, device=device)
                               < n_del_loc).to(torch.float32))
                weights = torch.cat(w) if len(w) > 1 else w[0]
                new_views = self._scan_steps(tp, step_cfgs, state, delta_cols,
                                             n_delta, weights, rels, p)
            else:
                new_views = {}
            bufs, gids, nv = shd.local_advance(
                rr.buffers, rr.gids, rr.n_valid_dev, n_scan, hit, dels, ins,
                rr.n_valid - n_del, shard, ndev, blk, k_ins)
            return new_views, dataclasses.replace(
                rr, buffers=bufs, gids=gids,
                n_valid=rr.n_valid - n_del + n_ins,
                n_valid_ub=rr.n_valid_ub + shares, n_valid_dev=nv)

        self._runners[key] = run
        return run

    def shard_topology(self) -> Optional[Dict[str, object]]:
        """Shard facts for ``explain()`` and the server's stats: rank count,
        the partitioned relation and its per-shard geometry, and the
        all-reduces one tick of each relation issues.  ``None`` when
        unsharded."""
        if self.mesh is None:
            return None
        ndev = self._axis().size
        top: Dict[str, object] = {
            "n_devices": ndev, "mesh_axis": self.mesh_axis,
            "shard_rel": self.shard_rel}
        es = self._current
        if es is not None and self.shard_rel in es.relations:
            rr = es.relations[self.shard_rel]
            top["rows"] = rr.n_valid
            top["rows_per_shard"] = -(-rr.n_valid // ndev)
            top["capacity_per_shard"] = rr.capacity
        top["psums_per_tick"] = {
            rel: sum(len(st.prog.views) for st in dp.steps
                     if st.rel == self.shard_rel)
            for rel, dp in sorted(self._delta_programs.items())}
        return top

    # -- snapshots (checkpoint/store.py hooks) -------------------------------

    def state_skeleton(self):
        """A nested dict with the snapshot's structure (leaf values unused)
        — lets ``restore`` run before ``init``."""
        return {"epoch": 0, "step": 0,
                "views": {f"v{vid:04d}": 0 for vid in sorted(self.plan.views)},
                "relations": {name: {a: 0 for a in rs.attrs}
                              for name, rs in self.batch.schema.relations.items()}}

    def snapshot_state(self, epoch: Optional[int] = None):
        """Host tree of one epoch's full maintained state: epoch/update
        counters, every view tensor, and the base relations trimmed to their
        valid rows, in the oracle's row order.  Resolving the epoch up front
        makes the snapshot atomic — a concurrent ``apply`` cannot tear it —
        and a pinned ``epoch`` checkpoints that exact version.  Copies to
        the host, and so waits for the card: a snapshot is an export, not a
        tick.  Placement-free: a sharded relation is gathered (a collective:
        under a mesh every rank takes the snapshot)."""
        es = self.epoch_state(epoch)
        return {"epoch": np.asarray(es.epoch, np.int64),
                "step": np.asarray(es.step, np.int64),
                "views": {f"v{vid:04d}": v.cpu().numpy()
                          for vid, v in sorted(es.views.items())},
                "relations": {name: {a: c.cpu().numpy()
                                     for a, c in rr.to_relation()
                                     .columns.items()}
                              for name, rr in es.relations.items()}}

    def load_state(self, tree) -> None:
        """Rebuild an epoch from a host snapshot (this package's or the
        reference's: the layout is the same) on the batch's device.
        Snapshots are placement-free, so one written by a single-device
        batch restores into a sharded one and back: the relations become
        resident under *this* batch's mesh."""
        if self.device is None:
            raise ValueError("the maintained batch has no device: open it "
                             "through a session (Database.views)")

        def on(a):
            return torch.from_numpy(np.array(a)).to(self.device)

        if self.mesh is not None:
            self._resolve_shard_rel(
                {name: int(np.asarray(next(iter(cols.values()))).shape[0])
                 for name, cols in tree["relations"].items()})
        views = {int(k[1:]): on(v) for k, v in tree["views"].items()}
        rels = {name: self._make_resident(
                    Relation(name, {a: on(c) for a, c in cols.items()}))
                for name, cols in tree["relations"].items()}
        if self._verify:
            for rr in rels.values():
                verify_resident(rr)
        self._current = EpochState(epoch=int(np.asarray(tree["epoch"])),
                                   step=int(np.asarray(tree["step"])),
                                   views=views, relations=rels)

    def save(self, ckpt_dir: str, keep: int = 3,
             epoch: Optional[int] = None) -> str:
        from repro_torch.checkpoint import store
        return store.save_view_state(ckpt_dir, self, keep=keep, epoch=epoch)

    def restore(self, ckpt_dir: str, step: Optional[int] = None) -> int:
        from repro_torch.checkpoint import store
        return store.restore_view_state(ckpt_dir, self, step=step)

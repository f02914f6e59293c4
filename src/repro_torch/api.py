"""Session API of the port: one ``Database`` facade over the engine;
counterpart of ``repro/api.py`` (no mesh, ``explain``, ``with_config``,
``tree``/``relation`` or ``schedule``/``batched_params``).

    import repro_torch
    db = repro_torch.connect(dataset)              # relations on the card
    out = db.views(queries).run()                  # {name: dense tensor}
    outs = db.views(queries).run_batched(params)   # N param settings at once

    m = db.views(queries, maintain=True)           # incremental views
    m.run()                                        # full scan -> epoch 0
    m.apply(update)                                # work ∝ |update|
    m.snapshot(ckpt_dir)                           # crash-safe epoch checkpoint
    srv = m.serve(max_pinned_epochs=8)             # epoch-pinned serving

    r = db.route(query("q", ["locn"], [COUNT]))    # ad-hoc: exact, subsumed
    r.tier, r.value                                # or compiled and cached

Entry points run on the card unless the caller asks for the CPU
(``connect(..., device="cpu")``): without a CUDA device and without that
request, ``connect`` raises instead of running somewhere else.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.aggregates import Params, Query
from repro_torch.core.engine import BatchStats, CompiledBatch, Engine
from repro_torch.core.lowering import BACKENDS
from repro_torch.core.plan import validate_block_size
from repro_torch.core.schema import DatabaseSchema
from repro_torch.data import relations as rel_mod
from repro_torch.data.datasets import Dataset
from repro_torch.device import resolve_device
from repro_torch.obs.workload import WorkloadRecorder, signature_of

__all__ = ["ExecutionConfig", "Database", "ViewHandle", "connect"]


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """One frozen execution policy for a whole session.

    ``backend`` selects the lowering path ("cuda": the hand-written
    kernels); ``fuse_kernels`` collapses each step's reductions into ONE
    fused launch per row block (off: one launch per reduction, the
    comparison baseline); ``block_size`` is the rows per launch;
    ``multi_root`` enables the paper's find-roots layer (off: every query
    of a batch is rooted at one relation, the paper's ablation).

    Serving: ``max_pinned_epochs`` bounds how many epochs concurrent readers
    may keep on the device; beyond it the least-recently-used pin is
    evicted (reads of an evicted epoch raise
    :class:`~repro_torch.core.ivm.EpochEvictedError`).

    Telemetry: ``warn_epoch_lag`` sets the pinned-reader lag (served head
    minus oldest pin) past which the server logs a rate-limited warning
    (None disables); ``workload_capacity`` bounds the session's in-memory
    workload recorder (``Database.workload``) — every run/read records its
    query signature, hit path, and latency there; 0 disables recording.

    Verification: ``verify_plans`` runs the static plan verifier
    (``repro_torch.analysis.verify``) over every compiled plan, raising
    :class:`~repro_torch.analysis.verify.PlanInvariantError` at compile
    time on any violated invariant.  ``None`` (default) auto-enables under
    pytest or when the ``REPRO_VERIFY`` env var is truthy;
    ``Database.views(debug=True)`` forces it on per batch.

    Routing: ``route_cache_capacity`` bounds the ad-hoc query router's LRU
    cache of serving-time compiled plans (``Database.query`` /
    ``Database.route``); 0 disables caching, so every routed miss is
    answered by a one-shot ``fallback_scan``.  Plans the router compiles
    are always admission-gated by the static verifier, independent of
    ``verify_plans``."""

    backend: str = "cuda"
    block_size: int = 1 << 20
    fuse_kernels: bool = True
    multi_root: bool = True
    max_pinned_epochs: Optional[int] = None
    warn_epoch_lag: Optional[int] = None
    workload_capacity: int = 4096
    verify_plans: Optional[bool] = None
    route_cache_capacity: int = 32

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r} "
                             f"(expected one of {BACKENDS})")
        validate_block_size(self.block_size)
        if self.max_pinned_epochs is not None and self.max_pinned_epochs < 1:
            raise ValueError("max_pinned_epochs must be >= 1 (or None)")
        if self.warn_epoch_lag is not None and self.warn_epoch_lag < 1:
            raise ValueError("warn_epoch_lag must be >= 1 (or None)")
        if self.verify_plans not in (None, True, False):
            raise ValueError("verify_plans must be True, False, or None "
                             f"(auto); got {self.verify_plans!r}")
        if (not isinstance(self.workload_capacity, int)
                or isinstance(self.workload_capacity, bool)
                or self.workload_capacity < 0):
            raise ValueError("workload_capacity must be an int >= 0 "
                             "(0 disables recording)")
        if (not isinstance(self.route_cache_capacity, int)
                or isinstance(self.route_cache_capacity, bool)
                or self.route_cache_capacity < 0):
            raise ValueError("route_cache_capacity must be an int >= 0 "
                             "(0 disables plan caching)")

    def replace(self, **overrides) -> "ExecutionConfig":
        """A copy with the given fields changed."""
        return dataclasses.replace(self, **overrides)

    def compile_kwargs(self) -> Dict[str, object]:
        """The compile-stage subset, as `Engine._compile` keywords."""
        return dict(block_size=self.block_size, backend=self.backend,
                    fuse_kernels=self.fuse_kernels,
                    multi_root=self.multi_root,
                    verify_plans=self.verify_plans)


class ViewHandle:
    """A registered batch of named views (create via :meth:`Database.views`).

    Batch views: ``run(params=)`` scans the session's relations on every
    call; ``run_batched(params)`` evaluates N param settings in one pass.
    Maintained views (``maintain=True``): ``run()`` materializes epoch 0 by
    a full scan (later calls read the current epoch), ``apply(update)``
    folds a delta batch and publishes the next epoch, ``serve()`` wraps the
    state in an epoch-pinning :class:`~repro_torch.serve.views.ViewServer`,
    and ``snapshot()``/``restore()`` checkpoint one epoch."""

    def __init__(self, database: "Database", compiled: CompiledBatch,
                 maintained=None):
        self._database = database
        self.compiled = compiled        #: the underlying CompiledBatch
        self._maintained = maintained
        self._server = None
        self._signatures = None         # lazy {name: QuerySignature}

    # -- workload recording --------------------------------------------------

    def signatures(self) -> Dict[str, object]:
        """Structural query signatures per view name (the workload
        recorder's and the router's key; see ``repro_torch.obs.workload``)."""
        if self._signatures is None:
            self._signatures = {
                q: signature_of(qo.query)
                for q, qo in self.compiled.result.outputs.items()}
        return self._signatures

    def _record(self, kind: str, hit: str, t0: float,
                epoch: Optional[int] = None) -> None:
        rec = self._database.workload
        if not rec.enabled:
            return
        us = (_time.perf_counter() - t0) * 1e6
        for name, sig in self.signatures().items():
            rec.record(kind, name, sig, hit, us, epoch=epoch)

    @property
    def config(self) -> ExecutionConfig:
        return self._database.config

    @property
    def names(self) -> Tuple[str, ...]:
        """The registered view (query) names, in output order."""
        return tuple(self.compiled.result.outputs)

    @property
    def stats(self) -> BatchStats:
        """Compile-time layer statistics (paper Table 2 analogue)."""
        return self.compiled.stats

    @property
    def is_maintained(self) -> bool:
        return self._maintained is not None

    @property
    def maintained(self):
        """The underlying :class:`~repro_torch.core.ivm.MaintainedBatch`."""
        if self._maintained is None:
            raise ValueError(
                "views were compiled without maintenance; register them with "
                "db.views(queries, maintain=True) to get apply()/serve()")
        return self._maintained

    def run(self, params: Optional[Params] = None) -> Dict[str, torch.Tensor]:
        """Evaluate the views and return ``{name: dense tensor}`` on the
        session's device.  Launches are asynchronous: reading a result
        synchronises.

        Batch views scan the session's relations.  Maintained views: the
        first call runs the full scan and publishes epoch 0; later calls
        read the current epoch (no rescans — :meth:`apply` advances it)."""
        t0 = _time.perf_counter()
        mb = self._maintained
        if mb is None:
            out = self.compiled(self._database.data, params)
            self._record("run", "batch_scan", t0)
            return out
        if not mb.initialized:
            out = mb.init(self._database.data, params=params)
            self._record("run", "full_scan", t0, epoch=mb.epoch)
            return out
        if params:
            raise ValueError(
                "maintained views bind params at the initial full scan; "
                "re-init via handle.maintained.init(db, params=...) to "
                "change them (a later run() only reads the epoch)")
        out = mb.results()
        self._record("run", "epoch_read", t0, epoch=mb.epoch)
        return out

    def run_batched(self, params: Params,
                    n_nodes: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Evaluate ``N`` settings of the batch's ``Param(batched=True)``
        params in one pass (``CompiledBatch.run_batched``): each batched
        param carries a leading axis of size ``N``, and batched outputs come
        back as ``(N, *group_dims, n_aggs)``.  Numpy params move to the
        session's device once per call."""
        if self._maintained is not None:
            raise ValueError("maintained views do not support the "
                             "param-batch axis; register a batch view")
        t0 = _time.perf_counter()
        out = self.compiled.run_batched(self._database.data, params,
                                        n_nodes=n_nodes)
        self._record("run_batched", "batch_scan", t0)
        return out

    # -- incremental maintenance ---------------------------------------------

    def apply(self, update, params: Optional[Params] = None):
        """Fold a :class:`~repro_torch.data.relations.DeltaBatchUpdate` into
        the maintained state and publish the next epoch; returns the
        refreshed results on the session's device.  Initializes (full
        scan) first if :meth:`run` has not."""
        mb = self.maintained
        if not mb.initialized:
            mb.init(self._database.data)
        return mb.apply(update, params=params)

    def results(self, epoch: Optional[int] = None):
        """Maintained-view outputs read from one epoch's frozen state."""
        return self.maintained.results(epoch=epoch)

    def serve(self, max_pinned_epochs: Optional[int] = None,
              warn_epoch_lag: Optional[int] = None):
        """An epoch-pinning :class:`~repro_torch.serve.views.ViewServer`
        over the maintained state (started — epoch 0 is published if
        needed).  The pin budget defaults to ``config.max_pinned_epochs``,
        the lag-warning threshold to ``config.warn_epoch_lag``; reads record
        into the session's workload recorder (``Database.workload``)."""
        from repro_torch.serve.views import ViewServer

        mb = self.maintained
        if max_pinned_epochs is None:
            max_pinned_epochs = self.config.max_pinned_epochs
        if max_pinned_epochs is not None and max_pinned_epochs < 1:
            raise ValueError("max_pinned_epochs must be >= 1 (or None)")
        if warn_epoch_lag is None:
            warn_epoch_lag = self.config.warn_epoch_lag
        if self._server is None:
            self._server = ViewServer(mb, max_pinned_epochs=max_pinned_epochs,
                                      warn_epoch_lag=warn_epoch_lag,
                                      workload=self._database.workload,
                                      router=self._database.router)
        elif max_pinned_epochs is not None:
            mb.max_pinned_epochs = max_pinned_epochs
        if not mb.initialized:
            self._server.start(self._database.data)
        return self._server

    def snapshot(self, ckpt_dir: str, keep: int = 3,
                 epoch: Optional[int] = None) -> str:
        """Crash-safe checkpoint of one epoch of maintained state."""
        return self.maintained.save(ckpt_dir, keep=keep, epoch=epoch)

    def restore(self, ckpt_dir: str, step: Optional[int] = None) -> int:
        """Restore maintained state from a checkpoint (works before any
        ``run()`` — the state skeleton comes from the compiled plan)."""
        return self.maintained.restore(ckpt_dir, step=step)


class Database:
    """The session facade: schema + join tree + resident relations + one
    frozen :class:`ExecutionConfig`.  Create via :func:`connect`; register
    query batches as named views with :meth:`views`, route ad-hoc queries
    with :meth:`route` / :meth:`query`."""

    def __init__(self, schema: DatabaseSchema, data: rel_mod.Database,
                 edges: Optional[Sequence[Tuple[str, str]]] = None,
                 config: Optional[ExecutionConfig] = None):
        self.schema = schema
        self.data = data                      #: resident relations
        self.config = config or ExecutionConfig()
        self._engine = Engine(schema, edges=edges, sizes=data.sizes())
        #: session-wide workload recorder: every view run, served read and
        #: routed query lands here (``workload.export_json(path)``)
        self.workload = WorkloadRecorder(self.config.workload_capacity)
        #: registered view handles, in registration order — the query
        #: router's answerable sources
        self._registered = []
        self._router = None

    def sizes(self) -> Dict[str, int]:
        return self.data.sizes()

    def views(self, queries: Sequence[Query], maintain: bool = False, *,
              roots: Optional[Dict[str, str]] = None,
              warm_rels: Sequence[str] = (),
              debug: bool = False, register: bool = True) -> ViewHandle:
        """Compile a query batch into one :class:`ViewHandle`.

        ``maintain=False``: a batch view — ``run()``/``run_batched()`` scan
        the session's relations on every call.  ``maintain=True``: an
        incrementally maintained view — ``run()`` materializes epoch 0 and
        ``apply(update)`` folds delta batches with work ∝ |update|;
        ``warm_rels`` builds those relations' delta programs now.
        ``roots`` overrides the find-roots layer per query (e.g. rooting
        every covar view at the fact table so that fact-only updates scan
        only the delta tuples).  ``debug=True`` forces the static plan
        verifier on for this batch whatever the session's
        ``verify_plans``.

        Registered handles (``register=True``, the default) become the
        query router's answerable sources: :meth:`query` matches routed
        aggregates against them by signature and, for maintained handles,
        by subsumption.  ``register=False`` keeps a handle private (the
        router uses it for its own cached plans)."""
        cfg = self.config
        if debug and cfg.verify_plans is not True:
            cfg = cfg.replace(verify_plans=True)
        kw = cfg.compile_kwargs()
        if maintain:
            mb = self._engine._compile_maintained(
                queries, root_override=roots, warm_rels=warm_rels,
                device=self.data.device, **kw)
            handle = ViewHandle(self, mb.batch, maintained=mb)
        else:
            handle = ViewHandle(self, self._engine._compile(
                queries, root_override=roots, **kw))
        if register:
            self._registered.append(handle)
        return handle

    def view(self, q: Query, maintain: bool = False, **kw) -> ViewHandle:
        """Single-query convenience wrapper around :meth:`views`."""
        return self.views([q], maintain=maintain, **kw)

    # -- ad-hoc query routing ------------------------------------------------

    @property
    def router(self):
        """The session's signature router (created on first use; its LRU
        plan-cache bound comes from ``config.route_cache_capacity``)."""
        if self._router is None:
            from repro_torch.serve.router import QueryRouter

            self._router = QueryRouter(
                self, capacity=self.config.route_cache_capacity)
        return self._router

    def route(self, q: Query, params: Optional[Params] = None):
        """Answer an *arbitrary* group-by aggregate — no prior registration
        — returning a :class:`~repro_torch.serve.router.RouteResult` with
        the value (a tensor on the session's device) plus provenance (tier,
        answering view, pinned epoch, latency).  Exact and subsumed matches
        answer from registered views (maintained sources: one pinned epoch,
        no base scan); misses compile a fresh verified plan and cache it
        for the next ask."""
        return self.router.route(q, params=params)

    def query(self, q: Query, params: Optional[Params] = None):
        """Value-only front door: ``db.query(q)`` → dense answer tensor
        shaped ``(*[domain(a) for a in q.group_by], n_aggs)``."""
        return self.route(q, params=params).value

    def routing_stats(self) -> Optional[Dict[str, object]]:
        """Router telemetry (tier mix, hit rate, cache occupancy), or None
        if nothing was ever routed in this session."""
        return None if self._router is None else self._router.stats()


def connect(source, config: Optional[ExecutionConfig] = None, *,
            device="cuda",
            tables: Optional[Mapping[str, Mapping[str, object]]] = None,
            data: Optional[rel_mod.Database] = None,
            edges: Optional[Sequence[Tuple[str, str]]] = None) -> Database:
    """Open a session: ``repro_torch.connect(dataset_or_schema, config=...)``.

    ``source`` may be a :class:`~repro_torch.data.datasets.Dataset` (schema,
    join edges and tables come from it; the tables move to ``device``), a
    relations :class:`~repro_torch.data.relations.Database` (already on its
    device), or a bare
    :class:`~repro_torch.core.schema.DatabaseSchema` plus either ``data=``
    or ``tables=`` (numpy column dicts, moved to ``device``)."""
    if isinstance(source, Dataset):
        return Database(source.schema,
                        rel_mod.from_numpy(source.schema, source.tables,
                                           resolve_device(device)),
                        edges=edges if edges is not None else source.edges,
                        config=config)
    if isinstance(source, rel_mod.Database):
        return Database(source.schema, source, edges=edges, config=config)
    if isinstance(source, DatabaseSchema):
        if data is None:
            if tables is None:
                raise ValueError("connect(schema, ...) needs data= (a "
                                 "relations Database) or tables= (numpy "
                                 "column dicts)")
            data = rel_mod.from_numpy(source, tables, resolve_device(device))
        return Database(source, data, edges=edges, config=config)
    raise TypeError(f"cannot connect to {type(source).__name__}: expected a "
                    "Dataset, a relations Database, or a DatabaseSchema")

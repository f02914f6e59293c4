"""Session API of the port: one ``Database`` facade over the engine;
counterpart of ``repro/api.py``.

    import repro_torch
    db = repro_torch.connect(dataset)              # relations on the card
    v = db.views(queries)
    out = v.run()                                  # {name: dense tensor}
    outs = v.run_batched(params)                   # N param settings at once
    print(v.explain().summary())                   # unified stats report
    base = db.with_config(backend="torch")         # same tables, plain torch

    m = db.views(queries, maintain=True)           # incremental views
    m.run()                                        # full scan -> epoch 0
    m.apply(update)                                # work ∝ |update|
    m.snapshot(ckpt_dir)                           # crash-safe epoch checkpoint
    srv = m.serve(max_pinned_epochs=8)             # epoch-pinned serving

    r = db.route(query("q", ["locn"], [COUNT]))    # ad-hoc: exact, subsumed
    r.tier, r.value                                # or compiled and cached

    mesh = launch.mesh.make_host_mesh(n_data=4)    # after init_process_group
    sdb = db.with_config(mesh=mesh)                # domain-parallel: each
    sdb.views(queries).run()                       # rank scans its shard

Under a mesh the session is SPMD: every rank of the process group makes
the same calls with the same updates, in the same order, and gets the same
(replicated) results.

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
from repro_torch.core.plan import validate_blocking
from repro_torch.core.schema import DatabaseSchema
from repro_torch.data import relations as rel_mod
from repro_torch.data.datasets import Dataset
from repro_torch.device import resolve_device
from repro_torch.obs.workload import WorkloadRecorder, signature_of

__all__ = ["ExecutionConfig", "Database", "ViewHandle", "ViewReport",
           "connect"]


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """One frozen execution policy for a whole session.

    ``backend`` selects the lowering path ("cuda": the hand-written
    kernels; "torch": the same blocked scan reduced by plain torch ops,
    ``index_add_``, the library baseline — chosen only here, never in
    place of a kernel); ``fuse_scans`` toggles shared-scan fusion (off:
    one scan per view group, the paper's Fig. 5 ablation);
    ``fuse_kernels`` collapses each step's reductions into ONE fused launch
    per row block (off: one launch per reduction, the comparison baseline);
    ``multi_root`` enables the paper's find-roots layer (off: every query
    of a batch is rooted at one relation, the paper's ablation).

    Blocking: ``block_size`` is the rows per launch, or ``"auto"``: each
    scan step's block size is then resolved at bind time by the autotuner
    (``core/autotune.py``), which times candidates against the step's
    signature and keeps the winners in a JSON cache (``autotune_cache``
    path > ``REPRO_TORCH_AUTOTUNE_CACHE`` env >
    ``~/.cache/repro_torch/autotune.json``), so warm sessions never
    re-tune; ``ViewHandle.explain()`` shows the resolution.

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

    Domain parallelism: ``mesh`` (a
    :class:`torch.distributed.device_mesh.DeviceMesh`, e.g. from
    ``launch/mesh.py``) partitions ``shard_rel`` (default: the largest
    relation) row-wise over the ``mesh_axis`` axis: batch views run
    ``CompiledBatch.run_sharded`` and maintained views keep the relation
    as a :class:`~repro_torch.data.relations.ShardedResidentRelation`; the
    views of every step over it are all-reduced on the axis's process
    group.  The caller starts the process group; every rank makes the same
    session calls.

    Routing: ``route_cache_capacity`` bounds the ad-hoc query router's LRU
    cache of serving-time compiled plans (``Database.query`` /
    ``Database.route``); 0 disables caching, so every routed miss is
    answered by a one-shot ``fallback_scan``.  Plans the router compiles
    are always admission-gated by the static verifier, independent of
    ``verify_plans``."""

    backend: str = "cuda"
    block_size: object = 1 << 20            # int | "auto"
    fuse_scans: bool = True
    fuse_kernels: bool = True
    autotune_cache: Optional[str] = None
    multi_root: bool = True
    mesh: Optional[object] = None           # DeviceMesh
    mesh_axis: str = "data"
    shard_rel: Optional[str] = None
    max_pinned_epochs: Optional[int] = None
    warn_epoch_lag: Optional[int] = None
    workload_capacity: int = 4096
    verify_plans: Optional[bool] = None
    route_cache_capacity: int = 32

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r} "
                             f"(expected one of {BACKENDS})")
        validate_blocking(self.block_size)
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
        if self.mesh is not None:
            from repro_torch.core.distributed import check_axis
            check_axis(self.mesh, self.mesh_axis)

    def replace(self, **overrides) -> "ExecutionConfig":
        """A copy with the given fields changed."""
        return dataclasses.replace(self, **overrides)

    def compile_kwargs(self) -> Dict[str, object]:
        """The compile-stage subset, as `Engine._compile` keywords."""
        return dict(block_size=self.block_size, backend=self.backend,
                    fuse_scans=self.fuse_scans,
                    fuse_kernels=self.fuse_kernels,
                    multi_root=self.multi_root,
                    autotune_cache=self.autotune_cache,
                    verify_plans=self.verify_plans)


@dataclasses.dataclass
class ViewReport:
    """Unified ``explain()`` report across execution modes: the compile-time
    layer statistics (paper Table 2) always, plus the IVM epoch counters for
    maintained views and the server counters once ``serve()`` is live."""

    mode: str                    # "batch" | "maintained" | "served"
    backend: str
    batch: BatchStats
    # batch-mode passes; None for maintained views (their unit of work is
    # the delta tick: see step / n_delta_scan_steps / n_fold_traces)
    n_dispatches: Optional[int]
    # maintained-view counters (None in batch mode)
    epoch: Optional[int] = None
    step: Optional[int] = None
    n_delta_scan_steps: Optional[int] = None
    n_fold_traces: Optional[int] = None
    n_pinned_epochs: Optional[int] = None
    n_evicted_pins: Optional[int] = None
    max_pinned_epochs: Optional[int] = None
    # full server stats dict (None until serve()) — counters plus the
    # read/tick latency distributions and epoch lag
    serving: Optional[Dict[str, object]] = None
    # per-step blocking resolution from the last bind with "auto" blocking
    # (None when blocking is static or nothing has bound yet); the delta
    # variant is the IVM tick resolution — both render, labeled, when set
    autotune: Optional[list] = None
    autotune_delta: Optional[list] = None
    # static-verification coverage: joined summaries of the plan / delta /
    # tick reports, or None when verification is off
    verification: Optional[str] = None
    # session query-router stats: tier hit mix, cache occupancy, eviction
    # count — None until Database.query has routed something
    routing: Optional[Dict[str, object]] = None
    # under a mesh: whether the views run sharded, and the shard topology
    # (rank count, mesh axis, partitioned relation, per-shard row and
    # capacity geometry, the all-reduces a tick (maintained) or a run
    # (batch) issues); None without a mesh
    sharded: bool = False
    shard: Optional[Dict[str, object]] = None

    @staticmethod
    def _render_autotune(report: list) -> str:
        return ", ".join(
            f"{a['rel']}: bs={a['block_size']}"
            + (" (cached)" if a["from_cache"] else "")
            + (" (fallback)" if a.get("fallback") else "")
            for a in report)

    @staticmethod
    def _render_latency(label: str, snap: Optional[Dict[str, float]]) -> str:
        if not snap or not snap.get("count"):
            return ""
        return (f" {label}_p50={snap['p50']:.0f}us"
                f" {label}_p99={snap['p99']:.0f}us")

    def summary(self) -> str:
        """Every populated field renders — the line set is keyed on what the
        report carries, not on the mode label, so batch / maintained / served
        handles print consistently."""
        lines = [f"[{self.mode}] backend={self.backend}"
                 f"{' sharded' if self.sharded else ''}"
                 + (f" dispatches={self.n_dispatches}"
                    if self.n_dispatches is not None else ""),
                 "  " + self.batch.summary()]
        if self.shard is not None:
            t = self.shard
            geom = (f" rows/shard={t['rows_per_shard']}"
                    f" cap/shard={t['capacity_per_shard']}"
                    if "rows_per_shard" in t else "")
            if "psums_per_tick" in t:
                psums = " psums/tick={%s}" % ", ".join(
                    f"{r}: {n}" for r, n in t["psums_per_tick"].items())
            else:
                psums = f" psums/run={t['psums_per_run']}"
            lines.append(f"  shard: devices={t['n_devices']} "
                         f"axis={t['mesh_axis']} rel={t['shard_rel']}"
                         + geom + psums)
        if self.step is not None:
            lines.append(
                "  ivm: epoch="
                + ("-" if self.epoch is None else str(self.epoch))
                + f" step={self.step} "
                f"delta_scans={self.n_delta_scan_steps} "
                f"fold_traces={self.n_fold_traces} "
                f"pinned={self.n_pinned_epochs}"
                + (f"/{self.max_pinned_epochs}"
                   if self.max_pinned_epochs else "")
                + f" evicted={self.n_evicted_pins}")
        if self.serving is not None:
            s = self.serving
            lines.append(f"  serve: reads={s['n_reads']} "
                         f"updates={s['n_updates']} "
                         f"rejected={s['n_rejected_updates']} "
                         f"lag={s.get('epoch_lag', 0)}"
                         + self._render_latency("read", s.get("read_us"))
                         + self._render_latency("tick", s.get("tick_us")))
        if self.routing is not None and self.routing.get("n_queries"):
            r = self.routing
            tiers = r["tiers"]
            lines.append(
                f"  routing: n={r['n_queries']} "
                + " ".join(f"{t}={tiers[t]}" for t in
                           ("exact", "subsumed", "compiled", "fallback_scan")
                           if tiers.get(t))
                + f" hit_rate={r['hit_rate']:.2f}"
                  f" cache={r['cache_size']}/{r['capacity']}"
                  f" evicted={r['n_evictions']}")
        if self.verification:
            lines.append("  verify: " + self.verification)
        if self.autotune:
            lines.append("  autotune[batch]: "
                         + self._render_autotune(self.autotune))
        if self.autotune_delta:
            lines.append("  autotune[delta]: "
                         + self._render_autotune(self.autotune_delta))
        return "\n".join(lines)


class ViewHandle:
    """A registered batch of named views (create via :meth:`Database.views`).

    Batch views: ``run(params=)`` scans the session's relations on every
    call; ``run_batched(params)`` evaluates N param settings in one pass.
    Maintained views (``maintain=True``): ``run()`` materializes epoch 0 by
    a full scan (later calls read the current epoch), ``apply(update)``
    folds a delta batch and publishes the next epoch, ``serve()`` wraps the
    state in an epoch-pinning :class:`~repro_torch.serve.views.ViewServer`,
    and ``snapshot()``/``restore()`` checkpoint one epoch.

    ``explain()`` returns one :class:`ViewReport` for all of it."""

    def __init__(self, database: "Database", compiled: CompiledBatch,
                 maintained=None):
        self._database = database
        self.compiled = compiled        #: the underlying CompiledBatch
        self._maintained = maintained
        self._server = None
        self._signatures = None         # lazy {name: QuerySignature}
        # sharded runners by (axis, shard relation, node axis, sizes)
        self._sharded: Dict[Tuple, object] = {}

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
    def schedule(self):
        """The fused scan schedule the views execute."""
        return self.compiled.schedule

    @property
    def batched_params(self):
        """Names of the views' ``Param(batched=True)`` declarations."""
        return self.compiled.batched_params

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

    # -- batch execution -----------------------------------------------------

    def _shard_rel(self) -> str:
        sizes = self._database.sizes()
        rel = self.config.shard_rel or max(sorted(sizes),
                                           key=lambda k: sizes[k])
        if rel not in sizes:
            raise ValueError(f"shard_rel {rel!r} is not a relation "
                             f"(have: {sorted(sizes)})")
        return rel

    def _run_sharded(self, params: Optional[Params],
                     n_nodes: Optional[int] = None):
        """Mesh execution with the runner cached per (axis, shard relation,
        padded node axis, relation sizes) — data every rank shares, so the
        ranks build and run the same runners and issue the same
        all-reduces in the same order.  The node axis pads to the next
        power of two, as the local ``run_batched`` does, so a growing tree
        frontier reuses at most log2 runners."""
        from repro_torch.core.distributed import sharded_runner
        from repro_torch.core.engine import _params_on

        cfg = self.config
        db = self._database.data
        plan = self.compiled.plan
        params = _params_on(params, db.device)
        if plan.batched_params and n_nodes is None:
            n_nodes = int(params[sorted(plan.batched_params)[0]].shape[0])
        n_run = n_nodes
        if n_nodes is not None:
            n_run = 1 << (n_nodes - 1).bit_length()
        if n_run != n_nodes:
            for name in plan.batched_params:
                v = params[name]
                params[name] = torch.cat([v, v.new_zeros(
                    (n_run - n_nodes,) + tuple(v.shape[1:]))])
        shard_rel = self._shard_rel()
        key = (cfg.mesh_axis, shard_rel, n_run,
               tuple(sorted(db.sizes().items())))
        if key not in self._sharded:
            self._sharded[key] = sharded_runner(plan, db, cfg.mesh,
                                                cfg.mesh_axis, shard_rel,
                                                n_nodes=n_run)
        run, cols = self._sharded[key]
        self.compiled.n_dispatches += 1
        out = run(cols, params)
        if n_run != n_nodes:
            outputs = self.compiled.result.outputs
            out = {q: (v[:n_nodes] if outputs[q].vid in plan.batched_vids
                       else v) for q, v in out.items()}
        return out

    def run(self, params: Optional[Params] = None) -> Dict[str, torch.Tensor]:
        """Evaluate the views and return ``{name: dense tensor}`` on the
        session's device.  Launches are asynchronous: reading a result
        synchronises.

        Batch views scan the session's relations.  Maintained views: the
        first call runs the full scan and publishes epoch 0; later calls
        read the current epoch (no rescans — :meth:`apply` advances it)."""
        t0 = _time.perf_counter()
        mb = self._maintained
        if mb is None and self.config.mesh is not None:
            out = self._run_sharded(params)
            self._record("run", "sharded_scan", t0)
            return out
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
        if self.config.mesh is not None:
            if not self.compiled.plan.batched_params:
                raise ValueError("batch was compiled without batched "
                                 "params; declare Param(..., batched=True) "
                                 "terms first")
            out = self._run_sharded(params, n_nodes=n_nodes)
            self._record("run_batched", "sharded_scan", t0)
            return out
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

    # -- unified report ------------------------------------------------------

    def explain(self) -> ViewReport:
        """One report across modes: compile-time layer stats (always), the
        blocking resolution, IVM epoch counters (maintained views), serving
        counters (after ``serve()``), verification coverage and the
        session's routing stats.  Reads host counters only."""
        plan = self.compiled.plan
        rep = ViewReport(
            mode="batch", backend=self.config.backend,
            batch=self.compiled.stats,
            n_dispatches=self.compiled.n_dispatches,
            autotune=plan.last_autotune,
            sharded=self.config.mesh is not None)
        mb = self._maintained
        if mb is not None:
            rep.mode = "served" if self._server is not None else "maintained"
            rep.n_dispatches = None
            rep.epoch = mb.epoch if mb.initialized else None
            rep.step = mb.step
            rep.n_delta_scan_steps = mb.n_delta_scan_steps
            rep.n_fold_traces = mb.n_fold_traces
            rep.n_pinned_epochs = mb.n_pinned_epochs
            rep.n_evicted_pins = mb.n_evicted_pins
            rep.max_pinned_epochs = mb.max_pinned_epochs
            # both resolutions, labeled: the delta lane does not shadow
            # the init full scan's
            rep.autotune_delta = plan.last_autotune_delta
            rep.shard = mb.shard_topology()
            if self._server is not None:
                rep.serving = self._server.stats()
        elif self.config.mesh is not None:
            rep.shard = self._shard_topology_batch()
        pieces = []
        if plan.last_verification is not None:
            pieces.append(plan.last_verification.summary())
        if mb is not None:
            pieces.extend(r.summary() for _, r in
                          sorted(mb.last_verifications.items()))
        rep.verification = "; ".join(pieces) if pieces else None
        rep.routing = self._database.routing_stats()
        return rep

    def _shard_topology_batch(self) -> Dict[str, object]:
        """Shard facts of a batch view under a mesh: the relation the next
        ``run()`` partitions, its per-rank geometry, and the all-reduces one
        sharded pass issues (one per view of every step over the
        partitioned relation)."""
        from repro_torch.core.distributed import axis_info, rows_per_shard

        cfg = self.config
        shard_rel = self._shard_rel()
        ndev = axis_info(cfg.mesh, cfg.mesh_axis).size
        n = self._database.sizes().get(shard_rel, 0)
        return {"n_devices": ndev, "mesh_axis": cfg.mesh_axis,
                "shard_rel": shard_rel, "rows": n,
                "rows_per_shard": -(-n // ndev) if n else 0,
                "capacity_per_shard": rows_per_shard(n, ndev),
                "psums_per_run": sum(
                    len(step.vids) for step in self.compiled.schedule.steps
                    if step.rel == shard_rel)}


class Database:
    """The session facade: schema + join tree + resident relations + one
    frozen :class:`ExecutionConfig`.  Create via :func:`connect`; register
    query batches as named views with :meth:`views`, route ad-hoc queries
    with :meth:`route` / :meth:`query`."""

    def __init__(self, schema: DatabaseSchema, data: rel_mod.Database,
                 edges: Optional[Sequence[Tuple[str, str]]] = None,
                 config: Optional[ExecutionConfig] = None,
                 _engine: Optional[Engine] = None):
        self.schema = schema
        self.data = data                      #: resident relations
        self.config = config or ExecutionConfig()
        self.edges = list(edges) if edges is not None else None
        self._engine = _engine or Engine(schema, edges=edges,
                                         sizes=data.sizes())
        #: session-wide workload recorder: every view run, served read and
        #: routed query lands here (``workload.export_json(path)``)
        self.workload = WorkloadRecorder(self.config.workload_capacity)
        #: registered view handles, in registration order — the query
        #: router's answerable sources
        self._registered = []
        self._router = None

    # -- data access ---------------------------------------------------------

    @property
    def tree(self):
        """The join tree every view batch is pushed down over."""
        return self._engine.tree

    def sizes(self) -> Dict[str, int]:
        return self.data.sizes()

    def relation(self, name: str):
        return self.data.relation(name)

    # -- configuration -------------------------------------------------------

    def with_config(self, **overrides) -> "Database":
        """A sibling session over the same schema, resident tables and join
        tree with some config fields changed (e.g.
        ``db.with_config(backend="torch")``) — the cheap way to compare
        backends: nothing is copied to the device."""
        return Database(self.schema, self.data, edges=self.edges,
                        config=self.config.replace(**overrides),
                        _engine=self._engine)

    # -- view registration ---------------------------------------------------

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
                device=self.data.device, mesh=cfg.mesh,
                mesh_axis=cfg.mesh_axis, shard_rel=cfg.shard_rel, **kw)
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

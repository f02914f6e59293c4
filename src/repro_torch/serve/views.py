"""Snapshot-consistent serving over maintained aggregate views;
counterpart of ``repro/serve/views.py``.

:class:`ViewServer` wraps a :class:`~repro_torch.core.ivm.MaintainedBatch`
and gives every request a *pinned epoch* — an immutable version of the
whole view state — so concurrent readers always see mutually consistent
aggregates while update batches fold in behind them:

    live = db.views(queries, maintain=True)   # repro_torch.connect(...)
    srv = live.serve(max_pinned_epochs=8)     # started: epoch 0 published
    with srv.snapshot() as snap:          # reader: frozen epoch
        a = snap.results()["q_count"]
        ...                               # writer may publish e+1 here
        b = snap.results()["q_count"]     # still epoch e: a == b, always
    srv.apply(update)                     # writer: validates, folds, swaps

Reads never block writes and writes never block reads — an epoch's
tensors are never written after it is published, so a "read lock" is just
a reference.  Writers are serialized by the server's write lock (the
maintained batch is single-writer by contract).  Readers and the writer
share the device's one stream, so the caching allocator never hands a
pinned epoch's memory to another stream's work.  ``checkpoint()``
snapshots a pinned epoch through the crash-safe store, so a checkpoint
taken mid-update-stream is a clean version, not a torn mix.

The server is mesh-agnostic: when the maintained batch is sharded
(``ExecutionConfig.mesh``), every rank's epochs hold the same view tensors
— every tick all-reduces partial deltas *before* the state fold — so the
pin / swap / read code is the same, reads launch and sync nothing on every
rank, and only ``apply`` (its all-reduces) and ``checkpoint`` (the
snapshot's gather; every rank calls it, rank 0 writes) touch the mesh.
``stats()["shard"]`` reports the topology.

Telemetry: every read and update observes a latency histogram
(``serve.read_us`` / ``ivm.tick_us``), reads record their query signature
into the session workload recorder, and a rate-limited warning fires when
pinned readers fall more than ``warn_epoch_lag`` epochs behind head.  All
of it reads host clocks around dispatch sites, never a
``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import torch

from repro_torch.data.relations import DeltaBatchUpdate
from repro_torch.obs.log import get_logger
from repro_torch.obs.metrics import Registry
from repro_torch.obs.trace import span
from repro_torch.obs.workload import WorkloadRecorder, signature_of

#: seconds between repeated epoch-lag warnings for the same server
_LAG_WARN_INTERVAL_S = 5.0


class EpochView:
    """A reader's handle on one pinned epoch (create via
    ``ViewServer.snapshot()``).  All reads through one handle come from the
    same immutable state, no matter how many updates publish meanwhile."""

    def __init__(self, maintained, epoch: int):
        self._mb = maintained
        self.epoch = epoch
        self._results: Optional[Dict[str, torch.Tensor]] = None

    @property
    def epoch_lag(self) -> int:
        """How many epochs head has advanced past this handle — 0 means
        the reader sees the newest published state."""
        return self._mb.epoch - self.epoch

    def results(self) -> Dict[str, torch.Tensor]:
        # the epoch is immutable, so one extraction serves every read
        # through this handle
        if self._results is None:
            with span("serve.read", epoch=self.epoch):
                self._results = self._mb.results(epoch=self.epoch)
        return self._results

    def __getitem__(self, query_name: str) -> torch.Tensor:
        return self.results()[query_name]


class ViewServer:
    """Concurrent read/update front end for a ``MaintainedBatch``.

    Semantics: ``apply`` is transactional (whole batch validated before any
    fold; failure publishes nothing) and serialized across threads; reads
    are wait-free against writers and pin their epoch for as long as the
    snapshot handle lives."""

    def __init__(self, maintained, max_pinned_epochs: Optional[int] = None,
                 warn_epoch_lag: Optional[int] = None,
                 workload: Optional[WorkloadRecorder] = None,
                 router=None):
        """``max_pinned_epochs`` bounds how many epochs readers may keep
        device-resident at once (long-lived pins retain whole epochs of
        device memory): past the budget the least-recently-used pin is
        evicted, and reads through an evicted snapshot raise
        :class:`~repro_torch.core.ivm.EpochEvictedError` with a clear
        message.
        None leaves pins unbounded (trusted traffic only).

        ``warn_epoch_lag`` sets the lag threshold (head minus the oldest
        pinned epoch) past which the server logs a rate-limited warning —
        laggard pins are exactly what exhausts the pin budget.  None
        disables the warning.  ``workload`` is the session's shared
        :class:`~repro_torch.obs.workload.WorkloadRecorder`; reads record their
        query signature into it (one per served view).

        ``router`` (optional) is the session's signature router
        (:class:`~repro_torch.serve.router.QueryRouter`); when set,
        :meth:`query`
        answers *arbitrary* group-by aggregates through it — the session
        facade wires this automatically (``ViewHandle.serve()``)."""
        if max_pinned_epochs is not None and max_pinned_epochs < 1:
            raise ValueError("max_pinned_epochs must be >= 1 (or None)")
        if warn_epoch_lag is not None and warn_epoch_lag < 1:
            raise ValueError("warn_epoch_lag must be >= 1 (or None)")
        self.maintained = maintained
        if max_pinned_epochs is not None:
            self.maintained.max_pinned_epochs = max_pinned_epochs
        self.warn_epoch_lag = warn_epoch_lag
        self.workload = workload
        self.router = router
        self._write_lock = threading.Lock()
        self.n_reads = 0
        self.n_updates = 0
        self.n_rejected_updates = 0
        self.n_lag_warnings = 0
        self._log = get_logger("repro_torch.serve")
        #: per-server telemetry: read-latency distribution + pin high-water
        self.metrics = Registry()
        self._read_hist = self.metrics.histogram("serve.read_us")
        self._lag_gauge = self.metrics.gauge("serve.epoch_lag")
        self._pin_hwm = self.metrics.gauge("serve.pinned_epochs_hwm")
        # query signatures are static per compiled batch — render once, and
        # only when workload recording is on: with workload_capacity=0 the
        # read path must allocate nothing for telemetry
        self._signatures = ({
            q: signature_of(qo.query)
            for q, qo in maintained.batch.result.outputs.items()}
            if workload is not None and workload.enabled else {})

    # -- lifecycle -----------------------------------------------------------

    def start(self, db, params=None) -> int:
        """Full scan; publishes the first epoch and returns its id."""
        with self._write_lock:
            self.maintained.init(db, params=params)
            return self.maintained.epoch

    @property
    def epoch(self) -> int:
        return self.maintained.epoch

    # -- telemetry -----------------------------------------------------------

    @property
    def epoch_lag(self) -> int:
        """Head minus the oldest pinned epoch (0 with no pins): how far the
        laggiest live reader is behind the served state."""
        pinned = self.maintained.pinned_epochs()
        return (self.maintained.epoch - pinned[0]) if pinned else 0

    def _observe_lag(self) -> None:
        lag = self.epoch_lag
        self._lag_gauge.set(lag)
        self._pin_hwm.max(self.maintained.n_pinned_epochs)
        if self.warn_epoch_lag is not None and lag > self.warn_epoch_lag:
            if self._log.warning_every(
                    _LAG_WARN_INTERVAL_S, "epoch_lag",
                    "pinned readers lag served head", lag=lag,
                    threshold=self.warn_epoch_lag,
                    epoch=self.maintained.epoch,
                    n_pinned=self.maintained.n_pinned_epochs):
                self.n_lag_warnings += 1

    def _record_read(self, names, epoch: int, latency_us: float) -> None:
        if self.workload is None or not self.workload.enabled:
            return
        for name in names:
            sig = self._signatures.get(name)
            if sig is not None:
                self.workload.record("read", name, sig, "pinned_read",
                                     latency_us, epoch=epoch)

    # -- read path -----------------------------------------------------------

    def snapshot(self):
        """``with srv.snapshot() as snap:`` — pin the current epoch for the
        block; ``snap.results()`` is frozen at that version."""
        server = self

        class _Pin:
            def __enter__(pin):
                pin._epoch = server.maintained.pin()
                server.n_reads += 1
                server._observe_lag()
                return EpochView(server.maintained, pin._epoch)

            def __exit__(pin, *exc):
                server.maintained.unpin(pin._epoch)
                return False

        return _Pin()

    def read(self, query_name: Optional[str] = None):
        """One-shot consistent read at the current epoch (pin, read, unpin).
        Returns the full results dict, or one query's array."""
        t0 = time.perf_counter()
        with self.snapshot() as snap:
            out = snap.results()
            epoch = snap.epoch
        # host dispatch wall only (no device sync)
        us = (time.perf_counter() - t0) * 1e6
        self._read_hist.observe(us)
        self._record_read((query_name,) if query_name is not None else out,
                          epoch, us)
        return out if query_name is None else out[query_name]

    def query(self, q, params=None):
        """Serving-side front door for *ad-hoc* aggregates (DESIGN.md §13):
        routes ``q`` through the session's signature router — exact /
        subsumed matches answer from one pinned epoch; misses compile a
        fresh verified plan — and returns the dense answer tensor.  Use
        :meth:`read` for the views this server was compiled for."""
        if self.router is None:
            raise ValueError(
                "this ViewServer has no query router attached; create it "
                "through the session facade (db.views(..., maintain=True)"
                ".serve()) or pass router= explicitly")
        return self.router.route(q, params=params).value

    # -- write path ----------------------------------------------------------

    def apply(self, update: DeltaBatchUpdate, params=None) -> int:
        """Fold an update batch and publish the next epoch; returns its id.
        Serialized across threads; a rejected batch raises and leaves the
        served epoch untouched."""
        with self._write_lock:
            try:
                self.maintained.apply(update, params=params)
            except Exception:
                self.n_rejected_updates += 1
                raise
            self.n_updates += 1
            self._observe_lag()
            return self.maintained.epoch

    def checkpoint(self, ckpt_dir: str, keep: int = 3) -> str:
        """Crash-safe snapshot of a pinned epoch — consistent even while a
        concurrent ``apply`` folds the next one."""
        with self.maintained.pinned() as epoch:
            with span("serve.checkpoint", epoch=epoch):
                return self.maintained.save(ckpt_dir, keep=keep, epoch=epoch)

    def stats(self) -> Dict[str, object]:
        """Counters plus latency distributions: ``read_us`` (this server's
        one-shot reads) and ``tick_us`` (the maintained batch's ``apply``
        dispatch wall) carry count/mean/p50/p95/p99 dicts."""
        mb_metrics = self.maintained.metrics.snapshot()
        return {"epoch": self.maintained.epoch,
                "step": self.maintained.step,
                "n_reads": self.n_reads,
                "n_updates": self.n_updates,
                "n_rejected_updates": self.n_rejected_updates,
                "n_pinned_epochs": self.maintained.n_pinned_epochs,
                "n_evicted_pins": self.maintained.n_evicted_pins,
                "max_pinned_epochs": self.maintained.max_pinned_epochs,
                "n_delta_scan_steps": self.maintained.n_delta_scan_steps,
                "epoch_lag": self.epoch_lag,
                "warn_epoch_lag": self.warn_epoch_lag,
                "n_lag_warnings": self.n_lag_warnings,
                "read_us": self._read_hist.snapshot(),
                "tick_us": mb_metrics.get("ivm.tick_us"),
                "pinned_epochs_hwm": self._pin_hwm.value,
                "shard": self.maintained.shard_topology()}

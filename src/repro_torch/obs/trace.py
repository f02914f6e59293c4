"""Copy of ``repro/obs/trace.py`` for the PyTorch port: identical apart
from imports, so that the port records telemetry without importing the
JAX package.

Nestable timed spans with a chrome://tracing exporter.

The engine asserts hard *runtime* contracts — zero retraces, zero host
transfers, epoch-consistent serving — but had no way to *see* where a
compile, a maintenance tick, or a served read spends its time.  This module
is the always-compiled-in tracing layer (DESIGN.md §11): code wraps its
phases in ``with span("ivm.apply"):`` and, when tracing is enabled, every
span becomes one complete ("ph": "X") event in a chrome://tracing JSON
(load via chrome://tracing or https://ui.perfetto.dev).

Two properties are load-bearing:

* **Off-by-default cheap.**  ``span()`` with tracing disabled returns a
  shared no-op context manager after one module-global check — no object
  allocation, no clock read, no lock.  Instrumented hot paths (the
  steady-state IVM tick, the serving read) stay within noise when tracing
  is off, which is why the instrumentation can live in the engine
  permanently instead of behind a build flag.

* **No device syncs.**  A span timer reads ``time.perf_counter`` at enter
  and exit — it never calls ``block_until_ready`` or otherwise forces the
  device to drain.  Around asynchronously-dispatched jitted calls a span
  therefore measures *host dispatch* time (trace time on a cache miss);
  the caller's own sync points (e.g. a benchmark blocking on results) are
  the only places device latency becomes visible.  This is what keeps the
  transfer-guard / zero-retrace steady-state contracts intact with
  telemetry enabled — the headline test of the subsystem.

Spans nest naturally: chrome's complete events reconstruct the hierarchy
from time containment per thread, so no explicit parent bookkeeping is
needed.  The event buffer is bounded (``max_events``); once full, new spans
are counted in ``n_dropped`` instead of growing without limit under
sustained load.

    from repro_torch.obs import trace
    trace.enable()
    ... run a workload ...
    trace.export_chrome("trace.json")
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = ["span", "enable", "disable", "enabled", "Tracer", "get_tracer",
           "export_chrome", "clear"]

#: hard cap on buffered events — sustained-load runs must not leak memory
DEFAULT_MAX_EVENTS = 200_000


class _NullSpan:
    """The disabled-tracing fast path: a shared, stateless no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    """One live span; appends its complete event to the tracer on exit."""

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tracer._record(self.name, self._t0, t1 - self._t0, self.args)
        return False


class Tracer:
    """Bounded, thread-safe buffer of completed span events."""

    def __init__(self, max_events: int = DEFAULT_MAX_EVENTS):
        self.max_events = max_events
        self._events: List[dict] = []
        self._lock = threading.Lock()
        #: spans dropped because the buffer was full
        self.n_dropped = 0
        # one epoch per tracer so chrome timestamps start near zero
        self._epoch = time.perf_counter()

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args or None)

    def _record(self, name: str, t0: float, dur: float,
                args: Optional[dict]) -> None:
        ev = {"name": name, "ph": "X", "cat": name.split(".", 1)[0],
              "ts": (t0 - self._epoch) * 1e6, "dur": dur * 1e6,
              "pid": os.getpid(), "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        with self._lock:
            if len(self._events) >= self.max_events:
                self.n_dropped += 1
                return
            self._events.append(ev)

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.n_dropped = 0

    def chrome_payload(self) -> Dict[str, object]:
        """The chrome://tracing JSON object for the buffered events."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms",
                "otherData": {"n_dropped": self.n_dropped}}

    def export_chrome(self, path: Optional[str] = None):
        """Serialize to chrome://tracing JSON; write ``path`` if given,
        return the payload either way."""
        payload = self.chrome_payload()
        if path is not None:
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
        return payload


# -- module-level default tracer (what the engine's span() calls hit) --------

_enabled = False
_tracer = Tracer()


def get_tracer() -> Tracer:
    return _tracer


def enable(flag: bool = True) -> None:
    """Turn span recording on (or off with ``enable(False)``)."""
    global _enabled
    _enabled = bool(flag)


def disable() -> None:
    enable(False)


def enabled() -> bool:
    return _enabled


def span(name: str, **args):
    """``with span("ivm.apply", rel="R2"):`` — time a phase.  Returns a
    shared no-op when tracing is disabled (the off-by-default fast path)."""
    if not _enabled:
        return _NULL
    return _tracer.span(name, **args)


def clear() -> None:
    _tracer.clear()


def export_chrome(path: Optional[str] = None):
    return _tracer.export_chrome(path)


if os.environ.get("REPRO_TRACE"):        # opt-in via environment
    enable(True)

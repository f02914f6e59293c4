"""Nestable timed spans with a chrome://tracing exporter, on the profiler's
clock too; the port's counterpart of ``repro/obs/trace.py``, which it
follows apart from imports and the profiler annotations below.

The engine asserts hard *runtime* contracts — zero retraces, zero host
transfers, epoch-consistent serving — but had no way to *see* where a
compile, a maintenance tick, or a served read spends its time.  This module
is the always-compiled-in tracing layer (DESIGN.md §11): code wraps its
phases in ``with span("ivm.apply"):`` and, when tracing is enabled, every
span becomes one complete ("ph": "X") event in a chrome://tracing JSON
(load via chrome://tracing or https://ui.perfetto.dev).

Whenever a ``torch.profiler`` is recording, a span also opens a profiler
user annotation of its name (``record_function``), whether or not tracing
is enabled: the program's phases then sit in the device trace's own
timeline, beside the kernels they launch.  The buffer below keeps its own
``time.perf_counter`` clock; nothing converts between the two.  This
module imports no torch (``obs/`` stays device-free): the package
installs the profiler's two hooks through :func:`annotate_with` when it is
imported (``repro_torch/__init__.py``).

Three properties are load-bearing:

* **Off-by-default cheap.**  ``span()`` with tracing disabled and no
  profiler recording returns a shared no-op context manager after one
  module-global check and one check of the profiler's state — no object
  allocation, no clock read, no lock.  Instrumented hot paths (the
  steady-state IVM tick, the serving read, each kernel launch) stay within
  noise when tracing is off, which is why the instrumentation can live in
  the engine permanently instead of behind a build flag.  Arguments that
  cost something to compute go through :func:`lazy_span`, which computes
  them only when tracing records.

* **No device syncs.**  A span timer reads ``time.perf_counter`` at enter
  and exit — it never calls ``torch.cuda.synchronize()`` or otherwise
  forces the device to drain.  Around asynchronous launches a span
  therefore measures the host's time: dispatch, and any time the host is
  blocked where the caller's code blocks — a launch that waits because
  the device's launch queue is full, a copy to the host that waits for
  the results.  Those are the only places device latency becomes visible.
  This is what keeps the steady-state no-sync contracts intact with
  telemetry enabled — the headline test of the subsystem.

* **Bounded.**  The event buffer holds at most ``max_events``; once full,
  new spans are counted in ``n_dropped`` instead of growing without limit
  under sustained load.

Spans nest naturally: chrome's complete events reconstruct the hierarchy
from time containment per thread, so no explicit parent bookkeeping is
needed.

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

__all__ = ["span", "lazy_span", "enable", "disable", "enabled", "Tracer",
           "get_tracer", "export_chrome", "clear", "annotate_with"]

#: hard cap on buffered events — sustained-load runs must not leak memory
DEFAULT_MAX_EVENTS = 200_000

def _not_recording() -> bool:
    return False


#: whether a profiler is recording (torch's: a C call, about 0.1 µs), and
#: the annotation a span opens then; see :func:`annotate_with`
_profiling = _not_recording
_annotation = None

#: the process id the events carry, read once (a system call a span costs
#: tens of µs in a sandboxed process) and again in a forked child
_pid = os.getpid()


def _repid() -> None:
    global _pid
    _pid = os.getpid()


os.register_at_fork(after_in_child=_repid)


class _NullSpan:
    """The disabled-tracing fast path: a shared, stateless no-op."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        """Arguments known only inside the span; dropped here."""


_NULL = _NullSpan()


class _Note(_NullSpan):
    """A profiler user annotation alone: tracing is off, a profiler on."""

    __slots__ = ("_rf",)

    def __init__(self, name: str):
        self._rf = _annotation(name)

    def __enter__(self):
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        return False


class _Span:
    """One live span; appends its complete event to the tracer on exit,
    and opens a profiler annotation of its name if a profiler records."""

    __slots__ = ("_tracer", "name", "args", "_t0", "_rf")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._rf = _annotation(name) if _profiling() else None

    def __enter__(self):
        if self._rf is not None:
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self._tracer._record(self.name, self._t0, t1 - self._t0, self.args)
        return False

    def set(self, **args) -> None:
        """Add arguments known only inside the span (a count it made)."""
        self.args = dict(self.args or {}, **args)


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
              "pid": _pid, "tid": threading.get_ident()}
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
    """``with span("ivm.apply", rel="R2"):`` — time a phase.  With tracing
    disabled: a profiler annotation of ``name`` if a profiler records, else
    a shared no-op (the off-by-default fast path)."""
    if _enabled:
        return _tracer.span(name, **args)
    if _profiling():
        return _Note(name)
    return _NULL


def annotate_with(is_recording, annotation) -> None:
    """Open ``annotation(name)`` (a context manager) around every span
    while ``is_recording()``; the package passes torch's profiler state and
    ``record_function``."""
    global _profiling, _annotation
    _profiling, _annotation = is_recording, annotation


def lazy_span(name: str, args_of, *inputs):
    """``span(name, **args_of(*inputs))``, with ``args_of`` called only when
    tracing is enabled: a span whose arguments cost something to compute
    (a launch's bytes) costs nothing more than :func:`span` when off."""
    if _enabled:
        return _tracer.span(name, **args_of(*inputs))
    return span(name)


def clear() -> None:
    _tracer.clear()


def export_chrome(path: Optional[str] = None):
    return _tracer.export_chrome(path)


if os.environ.get("REPRO_TRACE"):        # opt-in via environment
    enable(True)

"""Engine-wide observability of the port: tracing spans, metrics,
workload recording; counterpart of ``repro/obs``.

* ``obs.trace``    — nestable timed spans + chrome://tracing export
  (off by default; ``obs.enable_tracing()`` or ``REPRO_TRACE=1``), each
  also a ``torch.profiler`` annotation while a profiler records;
* ``obs.metrics``  — process-local counters / gauges / fixed-bucket
  histograms (p50/p95/p99 without stored samples);
* ``obs.workload`` — bounded recorder of every run/read call's query
  signature, hit path, and latency;
* ``obs.log``      — structured, rate-limited logging.

Design rule shared by all four: **never sync the device**.  Telemetry
reads host clocks around dispatch sites only (never a
``torch.cuda.synchronize()``), so a steady tick or a served read stays
free of host syncs with everything enabled.  Each module is a copy of the
reference's, identical apart from imports and ``trace``'s profiler
annotations.
"""

from repro_torch.obs.log import StructuredLogger, get_logger
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, Registry,
                                     LATENCY_BUCKETS_US)
from repro_torch.obs.trace import (Tracer, enabled as tracing_enabled,
                                   export_chrome, get_tracer, span)
from repro_torch.obs.trace import enable as enable_tracing
from repro_torch.obs.trace import disable as disable_tracing
from repro_torch.obs.trace import clear as clear_trace
from repro_torch.obs.workload import (QuerySignature, WorkloadRecord,
                                      WorkloadRecorder, agg_renders, routable,
                                      signature_of)

__all__ = [
    "span", "enable_tracing", "disable_tracing", "tracing_enabled",
    "get_tracer", "export_chrome", "clear_trace", "Tracer",
    "Counter", "Gauge", "Histogram", "Registry", "LATENCY_BUCKETS_US",
    "QuerySignature", "WorkloadRecord", "WorkloadRecorder", "signature_of",
    "agg_renders", "routable",
    "StructuredLogger", "get_logger",
]

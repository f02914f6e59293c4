"""One run of one cell: set-up, the measured window, the metrics, and the
comparison with the plain reference that decides ``correct``.

``run`` is everything but the look for a chip, so a test can drive a whole
run on the CPU at a small size.
"""

from __future__ import annotations

import gc
import math
import os
import sys
import time
import traceback
import types
from typing import Dict, List, Optional

from cardbench.harness.spec import Cell

#: seconds of jobs or ticks traced with the host's operations too, after
#: the window, to name what the host does while the device idles
HOST_STRETCH_S = 2.0


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, overrides: Optional[dict] = None) -> dict:
    """The result line's object, and ``notes`` (printed to standard error)."""
    import torch

    from cardbench.harness import port
    from cardbench.metrics import _profile

    config = dict(cell.config, **(overrides or {}))
    marks = {"imports": time.perf_counter()}
    tables = cell.data_maker().make(config, seed, device)
    _sync(device)
    marks["data"] = time.perf_counter()
    port.tracing(trace)
    db, ds = port.connect(tables, config)
    _sync(device)
    marks["connect"] = time.perf_counter()
    load_s = marks["connect"] - marks["data"]
    jobs = cell.job()
    job = jobs.Job(db, ds, tables, cell.traffic, seed)
    _sync(device)
    marks["job"] = time.perf_counter()
    for _ in range(cell.traffic.get("warm", 1)):
        job.step()
    _sync(device)
    marks["warm"] = time.perf_counter()
    setup_spans = port.spans()
    port.tracing(trace)
    gc.collect()
    gc.freeze()                     # the set-up's objects stay out of the window's collections

    samples: List[float] = []
    failed, error = 0, None
    launches0 = port.launches()
    tracer = _profile.Trace() if trace else None
    if tracer is not None:
        tracer.__enter__()               # the profiler's start is set-up
    host = HostWatch()
    t_win = time.perf_counter()
    setup_s = t_win - t_start
    try:
        while True:
            t0 = time.perf_counter()
            job.step()
            t1 = time.perf_counter()
            samples.append(t1 - t0)
            if t1 - t_win >= seconds:
                break
    except Exception:                     # a unit the program failed: not correct
        failed, error = 1, traceback.format_exc()
    window_s = time.perf_counter() - t_win
    host_window = host.stop()
    if tracer is not None:
        tracer.__exit__(None, None, None)
    launches = {k: v - launches0[k] for k, v in port.launches().items()}
    window_spans = port.spans()
    port.tracing(False)
    gc.unfreeze()

    breakdown = None
    if trace and not failed:
        host_trace = _profile.Trace(cpu=True)
        with host_trace:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < HOST_STRETCH_S:
                with torch.profiler.record_function(f"cardbench.{jobs.UNIT}"):
                    job.step()
        by_name = _profile.by_name_s(tracer.device_events())
        breakdown = {"device_ops": [[k, v] for k, v in _profile.top_ops(by_name)],
                     "idle_gaps": [[k, v] for k, v in _profile.idle_gaps(host_trace.events)]}

    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    info = job.info() if not failed else {}
    record = job.record()
    del job, db, ds
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    ctx = types.SimpleNamespace(
        kind=cell.kind, unit=jobs.UNIT, n_units=len(samples), window_s=window_s,
        samples=samples, setup_s=setup_s, load_s=load_s, setup_spans=setup_spans,
        window_spans=window_spans, launches=launches, tables=tables, info=info,
        notes={}, trace=None)
    if tracer is not None:
        dev = tracer.device_events()
        ctx.trace = types.SimpleNamespace(busy_s=_profile.busy_s(dev),
                                          wall_s=tracer.wall_s,
                                          by_name=_profile.by_name_s(dev),
                                          read_s=tracer.read_s)
    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for name in names:
        value = None if failed else cell.reader(name).read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": cell.units[name]}

    t0 = time.perf_counter()
    numbers = cell.reference().judge(tables, record) if not failed else {}
    check_s = time.perf_counter() - t0
    compared = {k: {"value": _number(numbers.get(k)), "limit": lim}
                for k, lim in cell.limits.items()}
    correct = not failed and all(c["value"] <= c["limit"] for c in compared.values())

    result = {"correct": correct, "attempted": len(samples) + failed,
              "failed": failed, "metrics": metrics,
              "device": device_info(device, peak)}
    if ctx.trace is not None:
        result["device"].update(busy_s=ctx.trace.busy_s, window_s=ctx.trace.wall_s)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    last, steps = t_start, {}
    for k, t in marks.items():
        steps[k], last = t - last, t
    notes = dict(ctx.notes, check_s=check_s, units=len(samples), window_s=window_s,
                 setup_s=setup_s, setup_steps_s=steps,
                 setup_spans_s=_span_totals(setup_spans), load_s=load_s,
                 launches=launches, numbers=numbers, host_window=host_window,
                 unit_s_by_tenth=_tenths(samples))
    if ctx.trace is not None:
        notes["trace_read_s"] = ctx.trace.read_s
    if error:
        notes["error"] = error
    return {"result": result, "notes": notes}


class HostWatch:
    """What the host did to the caller's thread over the window: seconds
    in the garbage collector, collections by generation, the context
    switches it was forced into and its processor seconds."""

    def __init__(self):
        import resource

        self._resource = resource
        self.gc_s, self.collections, self._t = 0.0, [0, 0, 0], 0.0
        gc.callbacks.append(self._gc)
        self._ru0 = resource.getrusage(resource.RUSAGE_THREAD)

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._t
            self.collections[info["generation"]] += 1

    def stop(self) -> dict:
        gc.callbacks.remove(self._gc)
        ru = self._resource.getrusage(self._resource.RUSAGE_THREAD)
        return {"gc_s": self.gc_s, "collections": self.collections,
                "forced_switches": ru.ru_nivcsw - self._ru0.ru_nivcsw,
                "cpu_s": (ru.ru_utime + ru.ru_stime) - (self._ru0.ru_utime + self._ru0.ru_stime)}


def _tenths(samples: List[float]) -> List[float]:
    """The mean unit of each tenth of the window, in order."""
    k = max(len(samples) // 10, 1)
    return [sum(samples[i:i + k]) / len(samples[i:i + k])
            for i in range(0, len(samples), k)][:10]


def _span_totals(spans) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for sp in spans:
        out[sp["name"]] = out.get(sp["name"], 0.0) + sp["dur"] * 1e-6
    return out


def _number(x) -> float:
    """A number the result line can carry: a missing or infinite reading
    is the largest float, above any limit."""
    return float(x) if x is not None and math.isfinite(x) else sys.float_info.max


def device_info(device: str, peak: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    from cardbench.metrics._roofline import power_limit

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(),
            "count": 1, "memory_peak_bytes": peak,
            "card": power_limit()}


def jax_loaded() -> List[str]:
    """Top-level names of JAX or its package that the process holds,
    compared whole (``repro_torch`` starts with ``repro``)."""
    banned = {"jax", "jaxlib", "flax", "repro"}
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & banned)


def env_for(root: str) -> Dict[str, str]:
    """The program's build and kernel caches, at fixed paths inside the
    checkout; one host thread for the BLAS and OpenMP pools (one caller,
    no spinning pool beside it); libraries kept from loading JAX."""
    build = os.path.join(root, "build")
    return {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
            "MKL_NUM_THREADS": "1",
            "REPRO_TORCH_BUILD_DIR": os.path.join(build, "kernels"),
            "REPRO_TORCH_AUTOTUNE_CACHE": os.path.join(build, "autotune.json"),
            "TORCH_EXTENSIONS_DIR": os.path.join(build, "torch_extensions"),
            "TRITON_CACHE_DIR": os.path.join(build, "triton"),
            "USE_FLAX": "0", "USE_JAX": "0"}

"""The device trace of a window and the groups its kernels fall in.

``device_breakdown``, ``kernel_group`` and ``ivm_group`` are frozen copies
of the one-shot check's (``chip_smoke.py``), so that later changes to the
program or to that script do not move the yardstick.  ``Trace`` runs
``torch.profiler`` over a window of many jobs or ticks and reads the raw
events, which is fast where building the profiler's event tree is not.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple


def device_breakdown(fn, top: int = 8, classify=None):
    """Run ``fn`` once under ``torch.profiler``: device time by kernel name
    (the ``top`` largest), the device's busy time (sum of kernel times: one
    stream, so they do not overlap) and the host wall of the profiled run;
    with ``classify`` (kernel name -> group), device time by group too."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = e.name[:100]
            by_name[key] = by_name.get(key, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    busy = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    out = dict(profiled_wall_ms=wall * 1e3, device_busy_ms=busy,
               idle_share=1 - busy / (wall * 1e3) if wall > 0 else None,
               n_kernel_names=len(by_name), trace_read_s=time.perf_counter() - t0,
               top=[[k, v] for k, v in ranked])
    if classify is not None:
        groups = {}
        for k, v in by_name.items():
            g = classify(k)
            groups[g] = groups.get(g, 0.0) + v
        out["groups_ms"] = dict(sorted(groups.items(), key=lambda kv: -kv[1]))
    return out


SEG_REDUCE = "seg_reduce (fused_scan_block, seg_aggregate, tree_hist*)"
COMPACTION = "compaction (cumsum, where, index_fill_, index_copy_)"


def kernel_group(name: str) -> str:
    """The port's kernel a device kernel belongs to, by its namespace (the
    partial and combine passes together), or "other"."""
    for prefix, group in (("seg_reduce::", SEG_REDUCE),
                          ("xtx::", "covar_xtx")):
        if name.startswith(prefix) or f" {prefix}" in name:
            return group
    return "other"


def ivm_group(name: str) -> str:
    """A tick's device kernel by its work: the delta scans' reduction
    (``seg_reduce``), a sharded tick's routing of deletes and renumbering
    by global row id (``searchsorted``), the resident relation's compaction
    and append (the keep mask's running sum, the destinations, the row
    moves), or the rest:
    the delta tuples' assembly, the payloads' products and gathers, the
    state fold."""
    g = kernel_group(name)
    if g != "other":
        return g
    if "searchsorted" in name:
        return "gid routing (searchsorted)"
    if any(k in name for k in ("Scan", "scan", "index_copy", "index_fill", "where")):
        return COMPACTION
    return "other"


class Event:
    __slots__ = ("name", "start", "end", "device", "annotation")

    def __init__(self, name, start, end, device, annotation):
        self.name, self.start, self.end = name, start, end
        self.device, self.annotation = device, annotation


class Trace:
    """``torch.profiler`` over a window: ``with Trace(cpu=False) as t:``.
    Afterwards ``t.events`` holds every event (times in seconds on the
    profiler's clock) and ``t.wall_s`` the host wall of the window."""

    def __init__(self, cpu: bool = False):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
        self._prof = profile(activities=acts)
        self.events: List[Event] = []
        self.wall_s = 0.0
        self.read_s = 0.0

    def __enter__(self):
        _sync()
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.wall_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        t0 = time.perf_counter()
        self.events = read_events(self._prof)
        self.read_s = time.perf_counter() - t0
        return False

    def device_events(self) -> List[Event]:
        return [e for e in self.events if e.device]


def _sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def read_events(prof) -> List[Event]:
    """Every event of a finished profile from the raw kineto results.  A
    host annotation mirrored on the device's timeline is left out: it
    covers the device's gaps."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        note = bool(e.is_user_annotation())
        device = e.device_type() != DeviceType.CPU
        if device and note:
            continue
        start = e.start_ns() * 1e-9
        out.append(Event(e.name(), start, start + e.duration_ns() * 1e-9,
                         device, note))
    return out


def busy_s(events: List[Event]) -> float:
    """Seconds in which some operation ran on the device: the union of the
    device events' intervals."""
    total, end = 0.0, None
    for e in sorted(events, key=lambda e: e.start):
        if end is None or e.start > end:
            total += e.end - e.start
            end = e.end
        elif e.end > end:
            total += e.end - end
            end = e.end
    return total


def by_name_s(events: List[Event]) -> Dict[str, float]:
    """Device seconds by kernel name (summed durations)."""
    out: Dict[str, float] = {}
    for e in events:
        out[e.name] = out.get(e.name, 0.0) + (e.end - e.start)
    return out


def grouped_ms(by_name: Dict[str, float], classify) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for k, v in by_name.items():
        g = classify(k)
        out[g] = out.get(g, 0.0) + v * 1e3
    return out


def idle_gaps(events: List[Event], top: int = 10) -> List[Tuple[str, float]]:
    """The device's idle time between operations, by what the host was
    doing at each gap's midpoint: the innermost annotation and the
    innermost operation then open on the host ("python" where none is).  Sums by that name, the
    ``top`` largest."""
    dev = sorted((e for e in events if e.device), key=lambda e: e.start)
    host = sorted((e for e in events if not e.device), key=lambda e: e.start)
    gaps: Dict[str, float] = {}
    active: List[Event] = []
    i, end = 0, None
    for e in dev:
        if end is not None and e.start > end:
            mid = (end + e.start) / 2
            while i < len(host) and host[i].start <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h.end > mid]
            name = _describe(active)
            gaps[name] = gaps.get(name, 0.0) + e.start - end
        end = e.end if end is None else max(end, e.end)
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:top]


def _describe(open_: List[Event]) -> str:
    """The innermost annotation and the innermost operation open."""
    if not open_:
        return "python"
    notes = [e for e in open_ if e.annotation]
    ops = [e for e in open_ if not e.annotation]
    note = min(notes, key=lambda e: e.end - e.start).name if notes else None
    op = min(ops, key=lambda e: e.end - e.start).name if ops else "python"
    return op if note is None else f"{note} / {op}"


def top_ops(by_name: Dict[str, float], top: int = 10) -> List[Tuple[str, float]]:
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

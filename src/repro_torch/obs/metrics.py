"""Copy of ``repro/obs/metrics.py`` for the PyTorch port: identical apart
from imports, so that the port records telemetry without importing the
JAX package.

Process-local counters, gauges, and fixed-bucket latency histograms.

The serving layer needs latency *distributions* (p50/p95/p99 read and tick
latency), not just totals — but a long-lived server cannot store one sample
per request.  :class:`Histogram` keeps a fixed 1-2-5 log-spaced bucket
ladder (microseconds, ~1us .. 60s by default) and answers percentile
queries by linear interpolation inside the covering bucket, so memory is
O(#buckets) forever and an observation is one binary search + one integer
increment under a lock.  Quantile error is bounded by bucket width (<= 2.5x
at the resolution below — fine for the "did p99 blow up" question these
feed; DESIGN.md §11).

Like the tracing layer, metrics never touch the device: an observation is
a host-side float.  Callers time dispatch walls with ``perf_counter`` and
observe the result — no ``block_until_ready``, so the zero-sync serving
contract survives with metrics enabled.

:class:`Registry` is a tiny name->metric map so a component (a
``MaintainedBatch``, a ``ViewServer``) can own its metrics and surface
them as one ``snapshot()`` dict through ``stats()`` / ``explain()``.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry",
           "LATENCY_BUCKETS_US"]


def _ladder_125(lo: float, hi: float) -> Tuple[float, ...]:
    """1-2-5 log ladder covering [lo, hi]."""
    out: List[float] = []
    decade = lo
    while decade <= hi:
        for m in (1.0, 2.0, 5.0):
            v = decade * m
            if lo <= v <= hi:
                out.append(v)
        decade *= 10.0
    return tuple(out)


#: default latency ladder in microseconds: 1us .. 60s
LATENCY_BUCKETS_US = _ladder_125(1.0, 2e7) + (6e7,)


class Counter:
    """Monotone event counter."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        return self._v

    def snapshot(self):
        return self._v


class Gauge:
    """Last-write-wins instantaneous value (e.g. pin-table occupancy)."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = v

    def max(self, v: float) -> None:
        """Ratchet upward (high-water mark)."""
        with self._lock:
            if v > self._v:
                self._v = v

    @property
    def value(self) -> float:
        return self._v

    def snapshot(self):
        return self._v


class Histogram:
    """Fixed-bucket histogram with interpolated percentiles — p50/p95/p99
    without storing samples.

    ``bounds`` are the bucket *upper* edges (ascending); one overflow
    bucket catches everything above the last edge.  ``min``/``max`` are
    tracked exactly and clamp the interpolation, so degenerate cases (one
    sample, everything in one bucket) stay sensible."""

    def __init__(self, name: str,
                 bounds: Sequence[float] = LATENCY_BUCKETS_US):
        self.name = name
        self.bounds: Tuple[float, ...] = tuple(bounds)
        if list(self.bounds) != sorted(self.bounds) or not self.bounds:
            raise ValueError("histogram bounds must be ascending, non-empty")
        self._counts = [0] * (len(self.bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, p: float) -> float:
        """Interpolated p-th percentile (p in [0, 100]); 0.0 when empty."""
        with self._lock:
            total = self._count
            if not total:
                return 0.0
            rank = (p / 100.0) * total
            seen = 0.0
            for i, c in enumerate(self._counts):
                if not c:
                    continue
                if seen + c >= rank:
                    lo = self.bounds[i - 1] if i > 0 else 0.0
                    hi = (self.bounds[i] if i < len(self.bounds)
                          else (self._max or self.bounds[-1]))
                    lo = max(lo, self._min or lo)
                    hi = min(hi, self._max or hi)
                    if hi < lo:
                        hi = lo
                    frac = (rank - seen) / c
                    return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
                seen += c
            return self._max or 0.0

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            count, total = self._count, self._sum
        return {"count": count, "sum": total,
                "mean": (total / count) if count else 0.0,
                "min": self._min or 0.0, "max": self._max or 0.0,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99)}


class Registry:
    """A component's named metrics; ``snapshot()`` feeds stats()/explain()."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  bounds: Sequence[float] = LATENCY_BUCKETS_US) -> Histogram:
        return self._get(name, Histogram, bounds)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.snapshot() for name, m in sorted(items)}

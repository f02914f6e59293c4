"""The readers of the program's spans, on a synthetic window: each value,
and None where the cell's unit differs or the spans are missing (a
program that does not record them)."""

import types

import pytest

from cardbench.harness import spec
from cardbench.metrics._profile import SEG_REDUCE, kernel_group
from cardbench.metrics._roofline import PEAK_BYTES_S

KERNEL = "void seg_reduce::range_kernel<0>(seg_reduce::Params)"


def sp(name, dur_us, **args):
    out = {"name": name, "ph": "X", "ts": 0.0, "dur": dur_us}
    if args:
        out["args"] = args
    return out


def ctx(unit, spans, n_units=2, device_ms=None):
    trace = None
    if device_ms is not None:
        trace = types.SimpleNamespace(by_name={KERNEL: device_ms * 1e-3, "other": 1.0},
                                      busy_s=1.0, wall_s=1.0, read_s=0.0)
    return types.SimpleNamespace(unit=unit, n_units=n_units, window_spans=spans,
                                 trace=trace, notes={})


def read(metric, c):
    return spec.cell("retailer.covar").reader(metric).read(c)


FIT = [sp("tree.stage", 1000), sp("tree.stats", 4000, bytes=8), sp("tree.split", 3000),
       sp("tree.stage", 1000), sp("tree.stats", 2000, bytes=8), sp("tree.split", 5000),
       sp("scan.step", 7000, rel="F"), sp("scan.step", 1000, rel="F")]
TICK = [sp("ivm.apply", 9000), sp("ivm.validate", 1000), sp("ivm.stage", 2000),
        sp("ivm.scan", 5000), sp("scan.step", 4000, rel="F"), sp("ivm.compact", 500),
        sp("ridge.results", 6000), sp("ridge.solve", 3000)]

#: (metric, unit, spans, value a unit), the window holding two units
CASES = [
    ("host_ms.fit", "job", FIT, (1 + 3 + 1 + 5) / 2),
    ("wait_ms.fit", "job", FIT, (4 + 2) / 2),
    ("dispatch_ms.fit", "job", FIT, (7 + 1) / 2),
    ("dispatch_ms.job", "job", FIT, (7 + 1) / 2),
    ("host_ms.tick", "tick", TICK, (1 + 2 + 3) / 2),
    ("wait_ms.tick", "tick", TICK, 6 / 2),
    ("dispatch_ms.tick", "tick", TICK, 4 / 2),
]


@pytest.mark.parametrize("metric,unit,spans,value", CASES, ids=[c[0] for c in CASES])
def test_span_reader_value(metric, unit, spans, value):
    assert read(metric, ctx(unit, spans)) == pytest.approx(value)


@pytest.mark.parametrize("metric,unit,spans,value", CASES, ids=[c[0] for c in CASES])
def test_span_reader_none_for_another_unit(metric, unit, spans, value):
    assert read(metric, ctx("tick" if unit == "job" else "job", spans)) is None


@pytest.mark.parametrize("metric,unit,spans,value", CASES, ids=[c[0] for c in CASES])
def test_span_reader_none_without_its_spans(metric, unit, spans, value):
    """The parent's program: no new span (``ivm.validate`` alone is not
    enough for ``host_ms.tick``)."""
    old = [s for s in spans if s["name"] in ("ivm.apply", "ivm.validate")]
    assert read(metric, ctx(unit, old)) is None


LAUNCHES = [sp("kernel.fused_scan_block", 50, rows=1000, bytes=3_350_000_000, ops=10),
            sp("kernel.tree_hist_batched", 50, rows=1000, bytes=10, ops=67_000_000_000),
            sp("kernel.fused_scan_block", 10)]     # a launch without its work: skipped


@pytest.mark.parametrize("metric,unit", [("kernel_roofline.job", "job"),
                                         ("kernel_roofline.fit", "job"),
                                         ("kernel_roofline.tick", "tick")])
def test_kernel_roofline(metric, unit):
    """Least time (1 ms by bytes + 1 ms by operations) over 8 ms of
    ``seg_reduce`` device time: 25%; None for another unit, without launch
    spans or without a trace."""
    assert kernel_group(KERNEL) == SEG_REDUCE and PEAK_BYTES_S == 3.35e12
    c = ctx(unit, LAUNCHES, device_ms=8.0)
    assert read(metric, c) == pytest.approx(25.0)
    assert list(c.notes.values())[0]["by_bytes"] == 1
    assert read(metric, ctx("tick" if unit == "job" else "job", LAUNCHES, device_ms=8.0)) is None
    assert read(metric, ctx(unit, LAUNCHES[2:], device_ms=8.0)) is None
    assert read(metric, ctx(unit, LAUNCHES)) is None
    assert read(metric, ctx(unit, LAUNCHES, device_ms=0.0)) is None

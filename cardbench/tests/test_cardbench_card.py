"""A whole run of each cell on the card at a small size, correct, with
every per-layer metric of the cell read from its trace.  Needs a CUDA
device: run on the card with

    python -m pytest -q -m cuda cardbench/tests
"""

import time

import pytest

from cardbench.harness import cell as C
from cardbench.harness import spec

CELLS = ["retailer.covar", "retailer.ivm", "favorita.tree", "favorita.covar"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_run_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = spec.cell(workload)
    out = C.run(c, 2**31 + 21, 1.0, True, "cuda", time.perf_counter(),
                overrides={"fact_rows": 2_000_000})
    res = out["result"]
    assert res["correct"] is True, out["notes"]
    assert sorted(res["metrics"]) == sorted(c.per_layer)
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["breakdown"]["device_ops"] and len(res["breakdown"]["idle_gaps"]) <= 10


@pytest.mark.cuda
def test_the_window_trace_reads_as_the_frozen_breakdown():
    """Busy time from the raw events of ``Trace`` against the frozen
    ``device_breakdown`` over the same job."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cardbench.harness import port
    from cardbench.metrics import _profile

    c = spec.cell("retailer.covar")
    cfg = dict(c.config, fact_rows=4_000_000)
    tables = c.data_maker().make(cfg, 7, "cuda")
    db, ds = port.connect(tables, cfg)
    job = c.job().Job(db, ds, tables, c.traffic, 7)
    job.step()
    frozen = _profile.device_breakdown(job.step, classify=_profile.kernel_group)
    with _profile.Trace() as t:
        job.step()
    busy_ms = _profile.busy_s(t.device_events()) * 1e3
    assert abs(busy_ms - frozen["device_busy_ms"]) <= 0.05 * frozen["device_busy_ms"]
    seg = _profile.grouped_ms(_profile.by_name_s(t.device_events()), _profile.kernel_group)
    assert abs(seg[_profile.SEG_REDUCE] - frozen["groups_ms"][_profile.SEG_REDUCE]) \
        <= 0.05 * frozen["groups_ms"][_profile.SEG_REDUCE]

"""A whole run on the CPU at a small size (everything but the look for a
chip): the last line's shape, and ``correct`` from the reference.  And the
command itself without a card: an error, no result."""

import json
import subprocess
import sys
import time

import pytest

from cardbench.harness import cell as C
from cardbench.harness import spec

SMALL = {"fact_rows": 4000}
CELLS = ["retailer.covar", "retailer.ivm", "favorita.tree", "favorita.covar"]


def run(workload, **kw):
    c = spec.cell(workload)
    return C.run(c, kw.pop("seed", 2**31 + 3), kw.pop("seconds", 0.3), False, "cpu",
                 time.perf_counter(), overrides=SMALL)


@pytest.mark.parametrize("workload", CELLS)
def test_last_line_shape_and_correct(workload):
    out = run(workload)
    res = out["result"]
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True, out["notes"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    c = spec.cell(workload)
    assert sorted(line["metrics"]) == sorted(c.end_to_end)
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(line["compared"]) == set(c.limits)


def test_command_without_a_card_prints_no_result():
    p = subprocess.run([sys.executable, f"{spec.ROOT}/cardbench/run.py", "--workload",
                        "retailer.covar", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "needs 1 CUDA device" in p.stderr

"""The harness finds a cell's files by the names in BENCHMARK.json and
fails clearly on a missing one."""

import json
import os

import pytest

from cardbench.harness import spec

CELLS = ["retailer.covar", "retailer.ivm", "favorita.tree", "favorita.covar"]


@pytest.mark.parametrize("workload", CELLS)
def test_finds_a_cells_files_by_name(workload):
    c = spec.cell(workload)
    assert c.chips == 1 and c.limits
    assert callable(c.data_maker().make)
    assert hasattr(c.job(), "Job") and c.job().UNIT in ("job", "tick")
    ref = c.reference()
    assert callable(ref.judge) and callable(ref.control)
    for m in c.end_to_end + c.per_layer:
        assert callable(c.reader(m).read), m
    assert "setup_s" in c.end_to_end


def test_every_metric_and_cell_has_its_files():
    bench = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(spec.HERE, "metrics", m["name"] + ".py"))
    assert sorted(w["name"] for w in bench["workloads"]) == sorted(CELLS)


def test_unknown_workload_fails_clearly():
    with pytest.raises(spec.SpecError, match="no workload 'retailer.nope'"):
        spec.cell("retailer.nope")


def test_missing_traffic_file_fails_clearly(tmp_path):
    bench = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
    bench["workloads"][0]["traffic"] = "no_such_mix"
    p = tmp_path / "BENCHMARK.json"
    p.write_text(json.dumps(bench))
    with pytest.raises(spec.SpecError, match="missing file cardbench/traffic/no_such_mix.json"):
        spec.cell(bench["workloads"][0]["name"], str(p))


def test_missing_metric_reader_fails_clearly():
    c = spec.cell("retailer.covar")
    with pytest.raises(spec.SpecError, match="missing file cardbench/metrics/no_such_metric.py"):
        c.reader("no_such_metric")

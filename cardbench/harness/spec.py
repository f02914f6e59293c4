"""Finds a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
everything else follows from those names:

- ``configs/<config>.json``: the configuration (its ``file`` in
  ``BENCHMARK.json``), whose ``dataset`` names ``data/<dataset>.py``;
- ``traffic/<traffic>.json``: the mix, whose ``kind`` names the program's
  runner ``jobs/<kind>.py`` and the plain reference ``reference/<kind>.py``;
- ``limits/<workload>.json``: the limit of each number compared;
- ``metrics/<metric>.py``: a reader of each metric the cell reports.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


class SpecError(RuntimeError):
    """A cell's name or one of its files is missing or malformed."""


def load_module(path: str):
    """A module loaded from its file (metric files have dots in their
    names, so they are not importable by name)."""
    if not os.path.exists(path):
        raise SpecError(f"missing file {os.path.relpath(path, ROOT)}")
    name = "cardbench_" + re.sub(r"\W", "_", os.path.relpath(path, HERE)[:-3])
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: str) -> dict:
    if not os.path.exists(path):
        raise SpecError(f"missing file {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    workload: str
    chips: int
    config: dict
    traffic: dict
    kind: str
    limits: Dict[str, float]
    end_to_end: List[str]
    per_layer: List[str]
    units: Dict[str, str]

    def data_maker(self):
        return load_module(os.path.join(HERE, "data", f"{self.config['dataset']}.py"))

    def job(self):
        return load_module(os.path.join(HERE, "jobs", f"{self.kind}.py"))

    def reference(self):
        return load_module(os.path.join(HERE, "reference", f"{self.kind}.py"))

    def reader(self, metric: str):
        return load_module(os.path.join(HERE, "metrics", f"{metric}.py"))


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(workload: str, bench_path: str = None) -> Cell:
    bench = _json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SpecError(f"no workload {workload!r} in BENCHMARK.json "
                        f"(have: {', '.join(sorted(cells))})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"workload {workload!r} names no configuration "
                        f"of BENCHMARK.json: {w['config']!r}")
    config = _json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic = _json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    if "kind" not in traffic:
        raise SpecError(f"traffic {w['traffic']!r} names no kind of job")
    limits = _json(os.path.join(HERE, "limits", f"{workload}.json"))
    return Cell(workload, int(w["chips"]), config, traffic, traffic["kind"],
                {k: float(v) for k, v in limits.items()},
                [m["name"] for m in bench["end_to_end"] if _reports(m, workload)],
                [m["name"] for m in bench["per_layer"] if _reports(m, workload)],
                {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]})

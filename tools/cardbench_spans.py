"""A cell's unit split by the program's spans, on the card: what the
program's tracing costs when it is on, and where a job, fit or tick
spends its host time.

    python3 tools/cardbench_spans.py --workload favorita.tree --seed 7 \
        [--units 4] [--rounds 2] [--out chiprun_out/spans]

Sets the cell up as ``cardbench/run.py`` does (data from ``--seed``, the
session, the job, its warm units), then:

1. **Cost**: ``--rounds`` pairs of windows of ``--units`` units each under
   ``torch.profiler`` with the device's activity (as a ``--trace 1`` run's
   window), one with the ``obs`` spans off and one with them on, in turns;
   the median unit wall of each, and each span's milliseconds a unit in
   the windows with the spans on (a ``--trace 1`` window's conditions).
2. **Split**: one window of ``--units`` units with the spans on and the
   profiler's host activity too: each span's milliseconds a unit, the
   unit's wall, the host's time blocked on a full launch queue
   ("Command Buffer Full"), and the device time of every ``range_kernel`` by the
   ``scan.step`` span that launched it (the kernel's launch found by its
   correlation id, the launch inside a step's host annotation, the step's
   arguments from the ``obs`` buffer, in order).

Writes ``<out>/<workload>.json`` and prints a summary.
"""

import argparse
import bisect
import gc
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def _units(job, n):
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        job.step()
        walls.append(time.perf_counter() - t0)
    return walls


def _per_unit(spans, units: int) -> dict:
    out = {}
    for s in spans:
        out[s["name"]] = out.get(s["name"], 0.0) + s["dur"] * 1e-3 / units
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def cost(job, port, profile_mod, units: int, rounds: int) -> dict:
    walls, spans = {"off": [], "on": []}, []
    for r in range(rounds):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            port.tracing(on)
            with profile_mod.Trace():
                walls["on" if on else "off"] += _units(job, units)
            if on:
                spans += port.spans()
            port.tracing(False)
    med = {k: statistics.median(v) for k, v in walls.items()}
    return {"walls_s": walls, "median_s": med,
            "cost_share": med["on"] / med["off"] - 1,
            "span_ms_per_unit": _per_unit(spans, units * rounds)}


def split(job, port, units: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    port.tracing(True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        walls = _units(job, units)
        torch.cuda.synchronize()
    spans = port.spans()
    port.tracing(False)

    steps = [s.get("args", {}) for s in sorted(spans, key=lambda s: s["ts"])
             if s["name"] == "scan.step"]

    host_steps, launches, kernels, blocked = [], {}, [], 0.0
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() != DeviceType.CPU
        if not on_device and e.name() == "Command Buffer Full":
            blocked += e.duration_ns() * 1e-6
        if not on_device and e.is_user_annotation() and e.name() == "scan.step":
            host_steps.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif not on_device and e.correlation_id():
            launches[e.correlation_id()] = e.start_ns()
        elif on_device and not e.is_user_annotation() and "range_kernel" in e.name():
            kernels.append((e.correlation_id(), e.duration_ns() * 1e-6, e.name()))
    host_steps.sort()
    starts = [a for a, _ in host_steps]
    by_step, unmatched = {}, 0.0
    for corr, ms, name in kernels:
        t = launches.get(corr)
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if i < 0 or t > host_steps[i][1] or len(host_steps) != len(steps):
            unmatched += ms
            continue
        a = steps[i]
        key = json.dumps([name[:60], a.get("rel"), a.get("vids"), a.get("n_segments"),
                          a.get("width"), a.get("n_rows")])
        by_step[key] = by_step.get(key, 0.0) + ms / units
    return {"units": units, "unit_wall_ms": [w * 1e3 for w in walls],
            "span_ms_per_unit": _per_unit(spans, units),
            "n_scan_steps": [len(steps), len(host_steps)],
            "queue_full_ms_per_unit": blocked / units,
            "range_kernel_ms_per_unit_by_step": dict(
                sorted(by_step.items(), key=lambda kv: -kv[1])),
            "range_kernel_ms_unmatched": unmatched / units}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--units", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "spans"))
    args = ap.parse_args(argv)

    from cardbench.harness import cell as C
    from cardbench.harness import spec

    os.environ.update(C.env_for(ROOT))
    import torch

    from cardbench.harness import port
    from cardbench.metrics import _profile

    if not torch.cuda.is_available():
        print("cardbench_spans: needs a CUDA device", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    tables = cell.data_maker().make(cell.config, args.seed, "cuda")
    db, ds = port.connect(tables, cell.config)
    job = cell.job().Job(db, ds, tables, cell.traffic, args.seed)
    for _ in range(cell.traffic.get("warm", 1)):
        job.step()
    torch.cuda.synchronize()
    gc.collect()
    gc.freeze()                 # as the harness does before its window
    out = {"workload": args.workload, "seed": args.seed,
           "card": C.device_info("cuda", 0)["card"],
           "cost": cost(job, port, _profile, args.units, args.rounds),
           "split": split(job, port, args.units)}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.workload}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"workload": args.workload, "card": out["card"],
                      "cost": out["cost"]["median_s"], "cost_share": out["cost"]["cost_share"],
                      "window_span_ms_per_unit": out["cost"]["span_ms_per_unit"],
                      "unit_wall_ms": out["split"]["unit_wall_ms"],
                      "split_span_ms_per_unit": out["split"]["span_ms_per_unit"],
                      "n_scan_steps": out["split"]["n_scan_steps"],
                      "queue_full_ms": out["split"]["queue_full_ms_per_unit"],
                      "range_top": list(out["split"]["range_kernel_ms_per_unit_by_step"].items())[:8],
                      "range_unmatched": out["split"]["range_kernel_ms_unmatched"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings that a cell's limits are set from, on many seeds in one
process (the benchmark's own runs never run this):

    python3 cardbench/control.py --workload <name> --seeds 1,2,3 [--program-seconds 3] [--units 230]

For each seed it makes the cell's tables, then

- with ``--program-seconds``, runs the program through a short window at
  the cell's own load and compares it, as a run does (the lower readings);
- runs the control, the plain reference computed in bfloat16 put in the
  program's place, and compares it the same way (the upper readings).

Each seed prints one JSON line; the last line holds, for each number, the
largest program reading and the smallest control reading.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program-seconds", type=float, default=0.0)
    ap.add_argument("--units", type=int, default=230,
                    help="jobs or ticks of the mix the control stands in for")
    args = ap.parse_args(argv)

    from cardbench.harness import cell as C
    from cardbench.harness import spec

    os.environ.update(C.env_for(ROOT))     # before numpy and torch load
    cell = spec.cell(args.workload)
    import torch

    ref = cell.reference()
    lower, upper = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        line = {"seed": seed}
        if args.program_seconds:
            out = C.run(cell, seed, args.program_seconds, False, "cuda",
                        time.perf_counter())
            line["program"] = {k: c["value"] for k, c in out["result"]["compared"].items()}
            line["program_units"] = out["notes"]["units"]
            for k, v in line["program"].items():
                lower[k] = max(lower.get(k, 0.0), v)
        tables = cell.data_maker().make(cell.config, seed, "cuda")
        t0 = time.perf_counter()
        numbers = ref.judge(tables, ref.control(tables, cell.traffic, seed, args.units))
        line["control"] = {k: C._number(numbers.get(k)) for k in cell.limits}
        line["control_s"] = time.perf_counter() - t0
        for k, v in line["control"].items():
            upper[k] = min(upper.get(k, float("inf")), v)
        print(json.dumps(line), flush=True)
        del tables
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper,
                      "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

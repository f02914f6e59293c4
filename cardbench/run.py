"""Runs one cell of the benchmark once and prints its result as the last
line of standard output:

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (from ``torch.profiler`` and the program's spans and
counters).  Every run compares what its timed path produced with the plain
reference; the numbers compared and their limits are the last lines of
standard error and the ``compared`` key of the result.  Without a CUDA
device, or with fewer than the cell asks for, it exits with an error and
prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from cardbench.harness import cell as C
    from cardbench.harness import spec

    os.environ.update(C.env_for(ROOT))     # before numpy and torch load
    try:
        cell = spec.cell(args.workload)
    except spec.SpecError as e:
        print(f"cardbench: {e}", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"cardbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = C.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = C.jax_loaded()
    if found:
        print(f"cardbench: the process holds {', '.join(found)}: the benchmark "
              "measures the port alone", file=sys.stderr)
        return 4
    for k, v in out["notes"].items():
        print(f"cardbench: {k}: {json.dumps(v, default=str)}", file=sys.stderr)
    for k, c in out["result"]["compared"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

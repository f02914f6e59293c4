"""Smoke run of the port's examples; counterpart of
``tools/examples_smoke.py``.

    PYTHONPATH=src python tools/torch_examples_smoke.py                   # the card
    PYTHONPATH=src EXAMPLES_SCALE=0.02 python tools/torch_examples_smoke.py --device cpu

Runs every ``examples/torch_*.py`` engine example in-process, at
``EXAMPLES_SCALE`` (0.02 unless set), then the LM examples
(``torch_train_lm.py --quick`` with its checkpoints in a fresh directory
under ``build/``, and ``torch_serve_lm.py``), and fails if any raises, or if
``jax`` or any ``repro.`` module is loaded once they have run: the port
imports neither.  The port has no deprecated entry points, so there is no
warning to trap as the reference's smoke does.
"""

import argparse
import os
import runpy
import shutil
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENGINE_EXAMPLES = [
    "torch_quickstart.py",
    "torch_ridge_over_joins.py",
    "torch_decision_tree.py",
    "torch_chow_liu_cubes.py",
    "torch_streaming_ridge.py",
]

#: the LM examples and their arguments besides ``--device``
LM_CKPT = os.path.join(REPO, "build", "torch_examples_smoke_ckpt")
LM_EXAMPLES = [
    ("torch_train_lm.py", ["--quick", "--ckpt-dir", LM_CKPT]),
    ("torch_serve_lm.py", []),
]


def foreign_modules():
    """Loaded modules of JAX or of the reference package."""
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.") or m == "repro"
                  or m.startswith("repro."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=os.environ.get("EXAMPLES_DEVICE", "cuda"))
    device = ap.parse_args(argv).device
    os.environ.setdefault("EXAMPLES_SCALE", "0.02")
    sys.path.insert(0, os.path.join(REPO, "src"))
    failed = []
    shutil.rmtree(LM_CKPT, ignore_errors=True)      # train from step 0
    runs = [(n, []) for n in ENGINE_EXAMPLES] + LM_EXAMPLES
    for name, extra in runs:
        path = os.path.join(REPO, "examples", name)
        t0 = time.time()
        print(f"=== {name} (EXAMPLES_SCALE={os.environ['EXAMPLES_SCALE']}, "
              f"device={device})", flush=True)
        try:
            runpy.run_path(path, run_name="torch_example")["main"](
                ["--device", device] + extra)
            print(f"=== {name} OK [{time.time() - t0:.1f}s]", flush=True)
        except Exception:
            traceback.print_exc()
            print(f"=== {name} FAILED", flush=True)
            failed.append(name)
    foreign = foreign_modules()
    if foreign:
        print(f"examples smoke: the examples loaded {', '.join(foreign[:8])}")
        return 1
    if failed:
        print(f"examples smoke: {len(failed)} failed: {', '.join(failed)}")
        return 1
    print(f"examples smoke: all {len(runs)} passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())

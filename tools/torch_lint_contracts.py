#!/usr/bin/env python
"""Entry point of the port's engine-contract linter.

    python tools/torch_lint_contracts.py

Thin wrapper over :mod:`repro_torch.analysis.lint` that anchors paths at
the repo root, so it works from any cwd with no PYTHONPATH set: lints
``src/repro_torch`` against ``tools/torch_lint_allowlist.json`` and exits
non-zero on any violation that survives it.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis.lint import main  # noqa: E402

if __name__ == "__main__":
    argv = sys.argv[1:] or [str(ROOT / "src" / "repro_torch")]
    sys.exit(main(argv + ["--root", str(ROOT),
                          "--allowlist",
                          str(ROOT / "tools" / "torch_lint_allowlist.json")]))

"""The reading of ``dispatch_ms.job`` in a cell whose job is a model's fit;
it moves ``fit_s``."""

import os

from cardbench.harness.spec import load_module

read = load_module(os.path.join(os.path.dirname(__file__), "dispatch_ms.job.py")).read

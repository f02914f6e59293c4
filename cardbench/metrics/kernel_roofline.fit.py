"""The reading of ``kernel_roofline.job`` in a cell whose job is a model's
fit; it moves ``fit_s``."""

import os

from cardbench.harness.spec import load_module

read = load_module(os.path.join(os.path.dirname(__file__), "kernel_roofline.job.py")).read

"""Seconds a fit: ``job_s``'s reading in a cell whose job is a model's
fit, which keeps a bound of its own."""

import os

from cardbench.harness.spec import load_module

read = load_module(os.path.join(os.path.dirname(__file__), "job_s.py")).read

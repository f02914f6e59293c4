"""The port's engine examples (``examples/torch_*.py``) on the CPU at
``EXAMPLES_SCALE=0.02``: each one's own oracle checks on the numbers its
``main()`` returns; ``torch_quickstart`` and ``torch_ridge_over_joins``
against the reference examples' printed numbers (rtol 1e-4, the tolerance
between the reference's backends in tests/test_backends.py:36, with half a
unit of the printed last digit; wall times left out); and, in a
subprocess, the smoke run of all five loading neither ``jax`` nor
``repro.*``."""

import contextlib
import io
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
SCALE = "0.02"


def _run(path, argv=None):
    """``main()`` of an example script, and what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod = runpy.run_path(str(path), run_name="example")
        res = mod["main"](argv) if argv is not None else mod["main"]()
    return res, buf.getvalue()


@pytest.fixture
def scale(monkeypatch):
    monkeypatch.setenv("EXAMPLES_SCALE", SCALE)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")


def _port(name):
    return _run(ROOT / "examples" / f"torch_{name}.py", ["--device", "cpu"])


def test_quickstart_oracles(scale):
    res, _ = _port("quickstart")
    assert res["epoch"] == 1
    np.testing.assert_allclose(res["total_units_after_insert"],
                               res["total_units"] + res["inserted_units"],
                               rtol=1e-4)
    assert res["promo_units"] <= res["total_units"]


def test_ridge_over_joins_oracles(scale):
    res, _ = _port("ridge_over_joins")
    assert res["N"] > 0 and res["p"] == 70
    assert abs(res["rmse_bgd"] / res["rmse_closed_form"] - 1) <= 1e-5
    assert res["rmse_closed_form"] < 0.8 * res["rmse_predict_mean"]


def test_decision_tree_oracles(scale):
    res, _ = _port("decision_tree")
    assert res["splits"] >= 1 and res["nodes"] == 2 * res["splits"] + 1
    assert res["rmse"] < res["rmse_predict_mean"]
    assert res["accuracy"] > res["majority"]


def test_chow_liu_cubes_oracles(scale):
    res, _ = _port("chow_liu_cubes")
    assert res["cube_equals_rollup"]
    assert len(res["edges"]) == 6                      # a tree over 7 attrs
    assert all(mi >= 0 for _, _, mi in res["edges"])


def test_streaming_ridge_oracles(scale):
    res, _ = _port("streaming_ridge")
    assert res["steps"] == [1, 2, 3, 4, 5]
    assert res["maintained_vs_fresh_rel"] <= 1e-4
    assert res["snapshot_frozen"] and res["published_epoch"] == res["pinned_epoch"] + 1
    assert res["current_drift"] > 0
    assert res["N"] == res["N_fit"]                    # inserts = deletes


#: the result lines each example prints, by their first word
_LINES = {"quickstart": ("database:", "total_units", "by_family:", "covar(units,",
                         "promo", "after"),
          "ridge_over_joins": ("BGD:", "rmse:")}


def _numbers(out: str, heads):
    """The numbers of each result line, wall times (``[1.2s]``, ``in
    0.3s``) left out: ``{head: [(value, half a unit of its last digit)]}``."""
    got = {}
    for line in out.splitlines():
        head = line.split(" ")[0]
        if head not in heads:
            continue
        line = re.sub(r"\[[0-9.]+s\]|in [0-9.]+s", "", line)
        toks = re.findall(r"-?\d[\d,]*(?:\.\d+)?(?:e[-+]?\d+)?", line)
        got[head] = [(float(t.replace(",", "")),
                      0.5 * 10.0 ** -len(t.split(".")[1]) if "." in t else 0.5)
                     for t in toks]
    assert set(got) == set(heads), (set(heads) - set(got), out)
    return got


@pytest.mark.parametrize("name", sorted(_LINES))
def test_example_matches_reference(name, scale):
    _, want_out = _run(ROOT / "examples" / f"{name}.py")
    _, got_out = _port(name)
    want, got = _numbers(want_out, _LINES[name]), _numbers(got_out, _LINES[name])
    for head in _LINES[name]:
        assert len(got[head]) == len(want[head]), (head, got[head], want[head])
        for (g, _), (w, half) in zip(got[head], want[head]):
            assert abs(g - w) <= 1e-4 * abs(w) + half, (head, g, w)


def test_examples_smoke_loads_no_jax():
    """tools/torch_examples_smoke.py in a fresh process: all five engine
    examples and the two LM examples run, and neither ``jax`` nor any
    ``repro.`` module is loaded after."""
    env = {**os.environ, "EXAMPLES_SCALE": SCALE,
           "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, str(ROOT / "tools" / "torch_examples_smoke.py"),
                        "--device", "cpu"], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "examples smoke: all 7 passed" in r.stdout

"""The port's engine-contract linter (``repro_torch.analysis.lint``), as
tests/test_analysis.py holds the reference's: the port is clean with its
committed allowlist, each rule fires on a seeded violation with an exact
count and the allowlist silences it, no false positives, allowlist
validation, and the CLI's exit codes.  The reference's own lint of
``src/`` stays clean on the port as well."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import lint as JL
from repro_torch.analysis import lint as L

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
ALLOWLIST = ROOT / "tools" / "torch_lint_allowlist.json"


def test_port_clean_with_committed_allowlist():
    violations = L.lint_paths([PORT], L.load_allowlist(ALLOWLIST), root=ROOT)
    assert violations == [], "\n".join(v.render() for v in violations)


def test_reference_lint_still_clean_on_the_port():
    allow = JL.load_allowlist(ROOT / "tools" / "lint_allowlist.json")
    violations = JL.lint_paths([PORT], allow, root=ROOT)
    assert violations == [], "\n".join(v.render() for v in violations)


def test_every_allowlist_entry_names_a_live_sync_point():
    """A stale entry would silence a future violation: each allowlisted
    file still has a violation of its rule."""
    allow = L.load_allowlist(ALLOWLIST)
    found = {(v.rule, v.path) for v in L.lint_paths([PORT], {}, root=ROOT)}
    for rule, entries in allow.items():
        for path in entries:
            assert (rule, path) in found, f"{rule}: {path} has no violation"


_SEEDS = {
    "sync-call": (
        "import numpy as np\nimport torch\n"
        "from torch.cuda import synchronize as sync\n"
        "def f(x, ev, xs):\n"
        "    x.item()\n"
        "    x.cpu()\n"
        "    ev.synchronize()\n"
        "    torch.cuda.synchronize()\n"
        "    sync()\n"
        "    x.to('cpu')\n"
        "    x.to(device='cpu')\n"
        "    x.to(torch.device('cpu'))\n"
        "    torch.cat(xs).cpu().numpy()\n"        # one violation, the .cpu()
        "    torch.sum(x).tolist()\n"
        "    int(torch.count_nonzero(x))\n"
        "    float(torch.sum(x))\n"
        "    bool(torch.any(x))\n"
        "    np.asarray(torch.mean(x))\n"
        "    np.array(torch.stack(xs))\n",
        15),
    "obs-no-device": (
        "import torch\nimport torch.cuda as tc\n"
        "from torch.nn import functional as F\n", 3),
    "engine-outside-core": (
        "from repro_torch.core import Engine\n"
        "from repro_torch.core import engine as E\n"
        "eng = Engine(None)\n"
        "E.Engine(None)\n"
        "eng.compile([])\n"
        "eng._compile([])\n"
        "other._compile_maintained([])\n"
        "other.compile_incremental([])\n",
        6),
    "random-key": (
        "import torch\n"
        "torch.manual_seed(0)\n"
        "torch.cuda.manual_seed_all(0)\n"
        "g = torch.Generator()\n"
        "g.manual_seed(1234)\n"
        "torch.Generator(device='cuda').manual_seed(7)\n",
        4),
}


@pytest.mark.parametrize("rule", sorted(_SEEDS))
def test_lint_rule_fires_on_seeded_violation(rule, tmp_path):
    src, n = _SEEDS[rule]
    rel = ("repro_torch/obs/seeded.py" if rule == "obs-no-device"
           else "repro_torch/seeded.py")
    hits = [v for v in L.lint_source(src, rel) if v.rule == rule]
    assert len(hits) == n, hits
    for v in hits:
        assert rule in v.render() and "remedy:" in v.render()
        assert "torch_lint_allowlist.json" in v.render() or rule == "obs-no-device"
    # the allowlist remedy actually silences the violation
    f = tmp_path / rel
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(src)
    flagged = L.lint_paths([tmp_path], {}, root=tmp_path)
    assert any(v.rule == rule for v in flagged)
    allowed = L.lint_paths([tmp_path], {rule: {rel: "test waiver"}},
                           root=tmp_path)
    assert not any(v.rule == rule for v in allowed)


def test_sync_already_flagged_is_not_counted_twice():
    src = "import torch\ndef f(xs):\n    return torch.cat(xs).cpu().numpy()\n"
    (v,) = L.lint_source(src, "repro_torch/x.py")
    assert v.rule == "sync-call" and ".cpu()" in v.message


def test_lint_no_false_positives():
    clean = (
        "import re\nimport numpy as np\nimport torch\n"
        "pat = re.compile('x')\n"              # .compile on non-engine recv
        "def f(lowered, cfg, xs, gen, x, n, other):\n"
        "    lowered.compile()\n"              # a lowering's compile is fine
        "    other._compile([])\n"             # not an Engine receiver
        "    np.asarray(xs).tolist()\n"        # host data, no torch call
        "    np.asarray(xs)\n"
        "    xs.numpy()\n"                     # no fresh torch result
        "    x.to('cuda')\n"
        "    x.to(torch.device('cuda', 0))\n"
        "    x.to(torch.float32)\n"
        "    x.to(n.device, non_blocking=True)\n"
        "    int(x.shape[0])\n"
        "    float(n)\n"
        "    gen.manual_seed(cfg.seed)\n"      # non-literal seeds
        "    torch.manual_seed(cfg.seed)\n"
        "    return x.tolist()\n")
    assert L.lint_source(clean, "repro_torch/clean.py") == []
    # torch outside obs/ and Engine inside core/ are fine
    assert L.lint_source("import torch\n", "src/repro_torch/ml/x.py") == []
    core = ("from repro_torch.core.engine import Engine\n"
            "eng = Engine(None)\neng._compile([])\n"
            "eng._compile_maintained([])\n")
    assert L.lint_source(core, "src/repro_torch/core/x.py") == []


def test_lint_allowlist_validation(tmp_path):
    bad_rule = tmp_path / "a.json"
    bad_rule.write_text('{"not-a-rule": {}}')
    with pytest.raises(ValueError, match="unknown rule"):
        L.load_allowlist(bad_rule)
    no_reason = tmp_path / "b.json"
    no_reason.write_text('{"sync-call": {"src/x.py": ""}}')
    with pytest.raises(ValueError, match="reason"):
        L.load_allowlist(no_reason)
    assert set(L.load_allowlist(ALLOWLIST)) <= set(L.RULES)


def test_lint_cli_exit_codes(tmp_path):
    """``tools/torch_lint_contracts.py`` exits 0 on the repo from any cwd;
    ``python -m repro_torch.analysis.lint`` exits 1 on a seeded violation,
    printing rule, location and remedy."""
    r = subprocess.run([sys.executable, str(ROOT / "tools" / "torch_lint_contracts.py")],
                       capture_output=True, text=True, cwd=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "engine contracts clean" in r.stdout
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\ntorch.cuda.synchronize()\n")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", str(bad),
         "--root", str(tmp_path), "--allowlist", str(tmp_path / "none.json")],
        capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 1
    assert "sync-call" in r.stdout and "bad.py:2" in r.stdout
    assert "remedy:" in r.stdout

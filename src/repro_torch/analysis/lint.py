"""Engine-contract linter for the port; counterpart of
``repro/analysis/lint.py``.

The same ``ast`` design (no import of the linted code), the same rule ids,
``Violation``/``render``, ``load_allowlist``, ``lint_paths`` and ``main``,
with each JAX check replaced by its torch counterpart and a committed
allowlist of its own (``tools/torch_lint_allowlist.json``):

* ``sync-call`` — no host-sync calls on the steady-state paths.  On any
  receiver, as the reference flags ``.item()`` and ``block_until_ready``:
  ``.item()``, ``.cpu()``, ``.synchronize()`` (``torch.cuda``, an
  ``Event``, a ``Stream``; ``torch.cuda.synchronize`` through any import
  alias), ``.to("cpu")``, ``.to(device="cpu")`` and
  ``.to(torch.device("cpu"))`` — the counterparts of ``jax.device_get`` and
  ``block_until_ready``.  Over a fresh ``torch.*`` call result only, as the
  reference flags ``float()``/``np.asarray()`` over a fresh ``jax`` result:
  ``.tolist()``, ``.numpy()``, ``int()``, ``float()``, ``bool()``,
  ``np.asarray()`` and ``np.array()``.  A conversion whose operand already
  went through a flagged sync is not flagged again, so
  ``torch.cat(xs).cpu().numpy()`` is one violation.  The allowlist names
  the modules with documented sync points (ingest and export, snapshot and
  checkpoint, autotune probes, host assembly after a pass, tokens to the
  host).
* ``obs-no-device`` — nothing under ``obs/`` imports ``torch``: telemetry
  observes the engine without touching (and so without syncing) device
  values (the reference forbids ``jax`` there).
* ``engine-outside-core`` — ``Engine`` construction, ``compile`` /
  ``_compile`` on an ``Engine`` receiver, and ``_compile_maintained`` (the
  port's name for ``_compile_incremental``) or any call ending in
  ``compile_incremental`` stay inside ``core/``; everything else goes
  through ``repro_torch.connect`` → ``Database``.
* ``random-key`` — no ``.manual_seed(<literal>)`` on any receiver
  (``torch``, ``torch.cuda``, a ``Generator``) and no
  ``manual_seed_all(<literal>)``: seeds thread in from config or arguments
  (the reference forbids ``jax.random.PRNGKey(<literal>)``).

Run as ``python tools/torch_lint_contracts.py`` or
``python -m repro_torch.analysis.lint``.  Violations print the rule id,
``file:line:col``, the message and the allowlist remedy; the process exits
non-zero if any survive the allowlist.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence

RULES = ("sync-call", "obs-no-device", "engine-outside-core", "random-key")

#: documented per-rule remedies, rendered with each violation
_REMEDY = {
    "sync-call": ("hoist the sync off the steady-state path, or add the "
                  "file under \"sync-call\" in tools/torch_lint_allowlist.json "
                  "with a reason documenting the sync point"),
    "obs-no-device": ("keep obs/ device-free (record host scalars the "
                      "caller already has); there is deliberately no "
                      "allowlist story for device work in telemetry"),
    "engine-outside-core": ("use repro_torch.connect(...).views(...) instead "
                            "of constructing Engine directly, or add the "
                            "file under \"engine-outside-core\" in "
                            "tools/torch_lint_allowlist.json with a reason"),
    "random-key": ("thread the seed in from config/arguments instead of a "
                   "literal manual_seed, or add the file under "
                   "\"random-key\" in tools/torch_lint_allowlist.json with a "
                   "reason"),
}

#: methods that sync on any receiver
_SYNC_METHODS = ("item", "cpu", "synchronize")
#: methods that sync when their receiver is a fresh torch result
_FRESH_METHODS = ("tolist", "numpy")
#: calls that sync when their argument is a fresh torch result
_FRESH_CALLS = ("int", "float", "bool", "numpy.asarray", "numpy.array")
_ENGINE_NAMES = ("repro_torch.core.Engine", "repro_torch.core.engine.Engine")


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str           # repo-relative posix path
    line: int
    col: int
    message: str

    def render(self) -> str:
        return (f"{self.rule}: {self.path}:{self.line}:{self.col}  "
                f"{self.message}\n    remedy: {_REMEDY[self.rule]}")


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` attribute chains as a dotted string (None otherwise)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_torch(canon: str) -> bool:
    return canon == "torch" or canon.startswith("torch.")


class _Linter(ast.NodeVisitor):
    def __init__(self, rel: str):
        self.rel = rel
        self.in_obs = "obs" in Path(rel).parts
        self.in_core = "repro_torch/core/" in rel
        self.violations: List[Violation] = []
        # local alias -> canonical dotted module/object name
        self.aliases: Dict[str, str] = {}
        # variables assigned from Engine(...) calls (any scope; linear and
        # flow-insensitive — good enough for a contract lint)
        self.engine_vars: set = set()

    def flag(self, node: ast.AST, rule: str, message: str) -> None:
        self.violations.append(Violation(rule, self.rel, node.lineno,
                                         node.col_offset, message))

    # -- alias tracking ------------------------------------------------------

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self.aliases[a.asname or a.name.split(".")[0]] = \
                a.name if a.asname else a.name.split(".")[0]
            if self.in_obs and _is_torch(a.name):
                self.flag(node, "obs-no-device",
                          f"import {a.name}: obs/ must stay device-free "
                          "(the no-sync telemetry rule)")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        for a in node.names:
            self.aliases[a.asname or a.name] = f"{mod}.{a.name}"
        if self.in_obs and _is_torch(mod):
            self.flag(node, "obs-no-device",
                      f"from {mod} import ...: obs/ must stay device-free "
                      "(the no-sync telemetry rule)")
        self.generic_visit(node)

    def _canon(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted name of an expression through import aliases:
        ``F.silu`` -> ``torch.nn.functional.silu`` under
        ``import torch.nn.functional as F``."""
        dotted = _dotted(node)
        if dotted is None:
            return None
        head, _, rest = dotted.partition(".")
        head = self.aliases.get(head, head)
        return f"{head}.{rest}" if rest else head

    # -- assignments: track Engine(...) receivers ----------------------------

    def _note_engine_assign(self, targets, value) -> None:
        if not (isinstance(value, ast.Call)
                and self._canon(value.func) in _ENGINE_NAMES):
            return
        for t in targets:
            if isinstance(t, ast.Name):
                self.engine_vars.add(t.id)

    def visit_Assign(self, node: ast.Assign) -> None:
        self._note_engine_assign(node.targets, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._note_engine_assign([node.target], node.value)
        self.generic_visit(node)

    # -- call checks ---------------------------------------------------------

    def _is_cpu(self, node: ast.AST) -> bool:
        """``"cpu"`` or ``torch.device("cpu")``."""
        if isinstance(node, ast.Constant):
            return node.value == "cpu"
        return (isinstance(node, ast.Call)
                and self._canon(node.func) == "torch.device"
                and bool(node.args) and self._is_cpu(node.args[0]))

    def _sync_call(self, node: ast.Call) -> Optional[str]:
        """What makes ``node`` a sync on any receiver (None if nothing)."""
        canon = self._canon(node.func) or ""
        if canon == "torch.cuda.synchronize":
            return "torch.cuda.synchronize()"
        if not isinstance(node.func, ast.Attribute):
            return None
        attr = node.func.attr
        if attr in _SYNC_METHODS:
            return f".{attr}()"
        if attr == "to":
            dev = [kw.value for kw in node.keywords if kw.arg == "device"]
            if any(self._is_cpu(a) for a in node.args[:1] + dev):
                return ".to(cpu)"
        return None

    def _fresh_torch(self, node: ast.AST) -> bool:
        """Whether a subtree calls into torch — a freshly produced device
        value, so host-converting it is a sync.  A subtree that already went
        through a sync call is not searched: that sync is flagged itself."""
        if isinstance(node, ast.Call):
            if self._sync_call(node) is not None:
                return False
            if _is_torch(self._canon(node.func) or ""):
                return True
        return any(self._fresh_torch(c) for c in ast.iter_child_nodes(node))

    def visit_Call(self, node: ast.Call) -> None:
        canon = self._canon(node.func) or ""
        attr = node.func.attr if isinstance(node.func, ast.Attribute) else None

        # sync-call: explicit syncs, and conversions of fresh torch results
        sync = self._sync_call(node)
        if sync is not None:
            self.flag(node, "sync-call",
                      f"{sync} blocks on the device — the steady-state "
                      "no-sync rule")
        elif attr in _FRESH_METHODS and self._fresh_torch(node.func.value):
            self.flag(node, "sync-call",
                      f".{attr}() over a fresh torch result forces a "
                      "device→host sync — the steady-state no-sync rule")
        elif (canon in _FRESH_CALLS and node.args
              and self._fresh_torch(node.args[0])):
            self.flag(node, "sync-call",
                      f"{canon}(…) over a fresh torch result forces a "
                      "device→host sync — the steady-state no-sync rule")

        # engine-outside-core: construction + compile entry points
        if not self.in_core:
            if canon in _ENGINE_NAMES:
                self.flag(node, "engine-outside-core",
                          "Engine(...) constructed outside core/ — the "
                          "session facade (repro_torch.connect → Database) "
                          "is the public compile surface")
            elif attr is not None and (
                    attr == "_compile_maintained"
                    or attr.endswith("compile_incremental")
                    or (attr in ("compile", "_compile")
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id in self.engine_vars)):
                maintained = attr != "compile" and attr != "_compile"
                self.flag(node, "engine-outside-core",
                          f".{attr}(...) on an Engine outside core/ — use "
                          "Database.views(queries"
                          + (", maintain=True" if maintained else "") + ")")

        # random-key: literal seeds
        if (attr in ("manual_seed", "manual_seed_all")
                or canon.endswith((".manual_seed", ".manual_seed_all"))):
            if node.args and isinstance(node.args[0], ast.Constant):
                self.flag(node, "random-key",
                          "manual_seed with a literal seed — thread seeds "
                          "from config so parallel runs don't share "
                          "randomness")

        self.generic_visit(node)


def lint_source(source: str, rel: str) -> List[Violation]:
    """Lint one module's source text (repo-relative path for reporting)."""
    tree = ast.parse(source, filename=rel)
    linter = _Linter(rel)
    linter.visit(tree)
    return linter.violations


def load_allowlist(path) -> Dict[str, Dict[str, str]]:
    """``{rule: {repo-relative-posix-path: reason}}``; validates shape so a
    malformed allowlist fails loudly instead of silently allowing."""
    with open(path) as f:
        data = json.load(f)
    for rule, entries in data.items():
        if rule not in RULES:
            raise ValueError(f"allowlist names unknown rule {rule!r} "
                             f"(rules: {', '.join(RULES)})")
        for p, reason in entries.items():
            if not isinstance(reason, str) or not reason.strip():
                raise ValueError(f"allowlist entry {rule}/{p} needs a "
                                 "non-empty reason string")
    return data


def lint_paths(paths: Sequence, allowlist: Dict[str, Dict[str, str]],
               root) -> List[Violation]:
    """Lint every ``.py`` file under the given paths; returns the
    violations that survive the allowlist, sorted for stable output."""
    root = Path(root)
    files: List[Path] = []
    for p in paths:
        p = Path(p)
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    out: List[Violation] = []
    for f in files:
        try:
            rel = f.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = f.as_posix()
        for v in lint_source(f.read_text(), rel):
            if v.path not in allowlist.get(v.rule, {}):
                out.append(v)
    return sorted(out, key=lambda v: (v.path, v.line, v.col, v.rule))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Lint the port's engine contracts over src/repro_torch")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to lint "
                         "(default: src/repro_torch)")
    ap.add_argument("--allowlist", default="tools/torch_lint_allowlist.json",
                    help="committed allowlist JSON")
    ap.add_argument("--root", default=".",
                    help="repo root for relative paths (default: cwd)")
    args = ap.parse_args(argv)
    allowlist = (load_allowlist(args.allowlist)
                 if Path(args.allowlist).exists() else {})
    violations = lint_paths(args.paths, allowlist, args.root)
    for v in violations:
        print(v.render())
    if violations:
        print(f"\n{len(violations)} contract violation(s)", file=sys.stderr)
        return 1
    print("engine contracts clean "
          f"({', '.join(RULES)}; allowlist entries: "
          f"{sum(len(v) for v in allowlist.values())})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

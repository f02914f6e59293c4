"""Crash-safe checkpoint store for nested dicts of host arrays; counterpart
of ``repro/checkpoint/store.py``, with the same on-disk layout, so a
maintained batch's snapshot restores in either package.

Layout (one directory per step):
    <dir>/step_000123/
        manifest.json      {"step", "leaves": {name: {file, shape, dtype, sha}}}
        <leafpath>.npy     one file per leaf: "views/v0003" -> views__v0003.npy

Leaf names are the key paths joined by "/", walked in sorted key order at
every level — the order JAX flattens dicts in, so both packages name and
list the leaves alike.  ``sha`` is the first 16 hex digits of the sha256 of
the leaf's bytes.  A leaf of bf16 bits in a 2-byte void
(``models/weights.py`` ``state_to_numpy``) is written with the descr and
the dtype name that the reference writes for ``ml_dtypes.bfloat16``
(``'<V2'``, ``"bfloat16"``), so its file and hash are the reference's.
Writes go to a temp dir renamed atomically into place; a checkpoint is only
visible once complete, and the ``keep`` newest steps survive each save.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


def is_bf16_bits(dtype: np.dtype) -> bool:
    """``ml_dtypes.bfloat16``, or the 2-byte void a bf16 leaf's bits are
    kept in (``models/weights.py`` ``state_to_numpy``, or ``np.load`` of a
    bf16 file)."""
    return dtype.name == "bfloat16" or (dtype.kind == "V" and dtype.itemsize == 2
                                        and dtype.names is None)


def _leaf_paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _leaf_paths(tree[k], prefix + (str(k),))]
    return [("/".join(prefix), tree)]


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def save(ckpt_dir: str, step: int, state: Any, keep: int = 3) -> str:
    """Write ``state`` (nested dicts of numpy arrays) as ``step``."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest: Dict[str, Any] = {"step": step, "leaves": {}}
    for name, leaf in _leaf_paths(state):
        a = np.asarray(leaf)
        fn = name.replace("/", "__") + ".npy"
        bf16 = is_bf16_bits(a.dtype)
        if bf16:
            _save_bf16_bits(os.path.join(tmp, fn), a)
        else:
            np.save(os.path.join(tmp, fn), a)
        manifest["leaves"][name] = {"file": fn, "shape": list(a.shape),
                                    "dtype": "bfloat16" if bf16 else str(a.dtype),
                                    "sha": _digest(a)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic visibility
    _gc(ckpt_dir, keep)
    return final


def _save_bf16_bits(path: str, a: np.ndarray) -> None:
    """``np.save`` of the bits as ``ml_dtypes.bfloat16`` would write them:
    numpy names a plain 2-byte void ``'|V2'``, the bf16 dtype ``'<V2'``."""
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": a.shape})
        np.ascontiguousarray(a).tofile(f)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, like: Any,
            step: Optional[int] = None) -> Tuple[Any, int]:
    """Rebuild a nested dict shaped like ``like`` from disk (numpy leaves),
    every leaf checked against its manifest hash."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = {}
    for name, meta in manifest["leaves"].items():
        a = np.load(os.path.join(d, meta["file"]))
        if _digest(a) != meta["sha"]:
            raise IOError(f"checkpoint corruption in {name} at step {step}")
        leaves[name] = a
    missing = {n for n, _ in _leaf_paths(like)} - set(leaves)
    if missing:
        raise KeyError(f"checkpoint missing leaves: {sorted(missing)[:5]}...")

    def fill(node, prefix):
        if isinstance(node, dict):
            return {k: fill(node[k], prefix + (str(k),)) for k in sorted(node)}
        return leaves["/".join(prefix)]

    return fill(like, ()), step


# --------------------------------------------------------------------------
# Maintained-view snapshots (core/ivm.py): a MaintainedBatch's state — epoch
# and update counters, every view tensor, and the base relations (trimmed to
# valid rows) — as one nested dict of host arrays.
# --------------------------------------------------------------------------

def save_view_state(ckpt_dir: str, maintained, keep: int = 3,
                    epoch: Optional[int] = None) -> str:
    """Snapshot a ``MaintainedBatch`` (its update counter names the step).
    Epoch-atomic: ``snapshot_state`` resolves one epoch before anything is
    written; pass a pinned ``epoch`` to checkpoint that exact version.

    The store stays mesh-agnostic: a sharded batch's snapshot is already
    placement-free, every rank takes it (it gathers), only the batch's
    writer (``is_writer``: rank 0) writes it, and every rank returns after
    the batch's ``checkpoint_barrier`` — so a restore that follows reads a
    complete checkpoint on every rank."""
    tree = maintained.snapshot_state(epoch=epoch)
    step = int(tree["step"])
    if maintained.is_writer:
        path = save(ckpt_dir, step, tree, keep=keep)
    else:
        path = os.path.join(ckpt_dir, f"step_{step:08d}")
    maintained.checkpoint_barrier()
    return path


def restore_view_state(ckpt_dir: str, maintained,
                       step: Optional[int] = None) -> int:
    """Load a view-state snapshot into a ``MaintainedBatch`` compiled for the
    same query batch (view ids and relation schemas must match; the
    skeleton supplies the structure, so ``init`` need not have run)."""
    tree, s = restore(ckpt_dir, maintained.state_skeleton(), step=step)
    maintained.load_state(tree)
    return s


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)

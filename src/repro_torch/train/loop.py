"""Fault-tolerant training loop; counterpart of ``repro/train/loop.py``.

  * checkpoint/restart: atomic checkpoints every N steps through
    ``checkpoint/store.py``; on start the loop resumes from the latest
    complete step (tested: an interrupted run's loss trajectory is
    bitwise-identical to an uninterrupted one on the CPU);
  * deterministic data: batches are pure functions of (seed, step), so a
    restart replays the exact stream;
  * straggler mitigation: per-step wall time vs. a rolling median — outliers
    beyond ``straggler_factor``× are logged and counted; the hook is where a
    deployment would swap in a spare (on one host the signal is recorded and
    exposed).

The loop's one host synchronisation a step is the read of the loss; a
checkpoint copies the state to the host.  Both lift
``torch.cuda.set_sync_debug_mode`` while they run, so a caller can run the
steps under ``"error"`` and see any other synchronisation raise.

A sharded state (DTensor leaves, ``make_train_step(..., mesh)``) runs the
same loop on every rank: a checkpoint gathers the state on every rank,
global rank 0 alone writes it, and every rank waits on a barrier after the
write (as the engine's ``save_view_state``), so a resume reads a complete
checkpoint; a resume places each leaf as the running state's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint import store
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.weights import state_from_numpy, state_to_numpy
from repro_torch.train.adamw import tree_leaves


@dataclasses.dataclass
class LoopConfig:
    max_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: Optional[str] = None
    keep: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10


@dataclasses.dataclass
class StepRecord:
    step: int
    loss: float
    wall: float
    straggler: bool


@contextlib.contextmanager
def host_sync():
    """A documented synchronisation point: the CUDA sync-debug mode is
    lifted inside and restored after."""
    if not torch.cuda.is_available():
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _save(ckpt_dir: str, step: int, host, keep: int, state) -> str:
    """``store.save`` of a gathered state: on a mesh global rank 0 writes
    and every rank returns after a barrier."""
    sharded = any(isinstance(t, DTensor) for t in tree_leaves(state))
    if not sharded:
        return store.save(ckpt_dir, step, host, keep=keep)
    if dist.get_rank() == 0:
        path = store.save(ckpt_dir, step, host, keep=keep)
    else:
        path = f"{ckpt_dir}/step_{step:08d}"
    dist.barrier()
    return path


class TrainLoop:
    def __init__(self, train_step: Callable, pipeline: TokenPipeline,
                 cfg: LoopConfig, log: Callable[[str], None] = print):
        self.train_step = train_step
        self.pipeline = pipeline
        self.cfg = cfg
        self.log = log
        self.records: List[StepRecord] = []
        self.straggler_events = 0
        self.state: Any = None          # the state after the last run

    def run(self, state: Any) -> Any:
        cfg = self.cfg
        start = 0
        if cfg.ckpt_dir is not None:
            latest = store.latest_step(cfg.ckpt_dir)
            if latest is not None:
                tree, start = store.restore(cfg.ckpt_dir, state)
                state = state_from_numpy(tree, like=state)
                self.log(f"[loop] resumed from checkpoint step {start}")
        times: List[float] = []
        for step in range(start, cfg.max_steps):
            batch = self.pipeline.batch_at(step)
            t0 = time.perf_counter()
            state, metrics = self.train_step(state, batch)
            with host_sync():
                loss = float(metrics["loss"])           # the step's sync point
            wall = time.perf_counter() - t0
            times.append(wall)
            med = float(np.median(times[-32:]))
            straggle = len(times) > 4 and wall > cfg.straggler_factor * med
            if straggle:
                self.straggler_events += 1
                self.log(f"[loop] straggler at step {step}: {wall:.3f}s vs median "
                         f"{med:.3f}s (event #{self.straggler_events})")
            self.records.append(StepRecord(step, loss, wall, straggle))
            if cfg.log_every and step % cfg.log_every == 0:
                self.log(f"[loop] step {step} loss {loss:.4f} "
                         f"({wall * 1e3:.0f} ms)")
            done = step + 1
            if cfg.ckpt_dir is not None and (done % cfg.ckpt_every == 0
                                             or done == cfg.max_steps):
                with host_sync():
                    host = state_to_numpy(state)
                    path = _save(cfg.ckpt_dir, done, host, cfg.keep, state)
                self.log(f"[loop] checkpoint @ step {done} -> {path}")
        self.state = state
        return state

    def losses(self) -> List[float]:
        return [r.loss for r in self.records]

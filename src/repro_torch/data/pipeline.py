"""Deterministic, restart-safe synthetic token pipeline; counterpart of
``repro/data/pipeline.py``.

Batches are a pure function of ``(seed, step)`` — a crashed or resized run
that resumes at step ``k`` sees exactly the batch it would have seen,
whatever the host count (each host slices its shard of the same global
batch).  The sequences follow an affine progression modulo vocab so models
have real signal to learn (the loss falls in the end-to-end example).

The draws come from numpy (``np.random.default_rng([seed, step])``), so
the CPU and the card see the same batches; they differ from the
reference's ``jax.random`` draws, so parity tests pass the reference's own
batch across.  A batch is copied to ``device`` from pinned host memory
without a stream synchronisation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class PipelineConfig:
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0


class TokenPipeline:
    def __init__(self, cfg: PipelineConfig, model_cfg: Optional[ModelConfig] = None,
                 device="cuda"):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """Global batch for a given step (pure function of (seed, step)) on
        the pipeline's device: int32 ``tokens`` (B, S) with ``t_i = (t_0 +
        i·stride) mod vocab``, stride 1 or 2, and for the VLM ``vision`` /
        for audio ``frames`` as 0.02·N(0, 1) in float32."""
        c = self.cfg
        rng = np.random.default_rng([c.seed, step])
        start = rng.integers(0, c.vocab, (c.global_batch, 1))
        stride = 1 + rng.integers(0, 2, (c.global_batch, 1))
        steps = np.arange(c.seq_len)[None, :]
        # next-token prediction is learnable from local context, so example
        # and test runs show a real loss decrease
        out = {"tokens": np.mod(start + steps * stride, c.vocab).astype(np.int32)}
        mc = self.model_cfg
        if mc is not None and mc.family in ("vlm", "audio"):
            key, n = (("vision", mc.vision_tokens) if mc.family == "vlm"
                      else ("frames", mc.encoder_frames))
            out[key] = rng.standard_normal((c.global_batch, n, mc.d_model),
                                           dtype=np.float32) * np.float32(0.02)
        return {k: _to_device(a, self.device) for k, a in out.items()}

    def host_shard(self, batch: Dict[str, torch.Tensor], process_index: int,
                   process_count: int) -> Dict[str, torch.Tensor]:
        """Slice this host's rows of the global batch (multi-host loading)."""
        def sl(a):
            per = a.shape[0] // process_count
            return a[process_index * per:(process_index + 1) * per]
        return {k: sl(v) for k, v in batch.items()}


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)

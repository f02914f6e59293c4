"""LR schedules: cosine (default) and WSD (warmup-stable-decay, MiniCPM);
counterpart of ``repro/train/schedules.py``.

Each takes the step as a tensor (or a Python number) and returns a float32
tensor on the step's device: a train step computes its learning rate on
the card from ``state["step"]`` with no host round trip.
"""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def cosine(step, *, peak_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    step = _f32(step)
    warm = peak_lr * step / max(warmup, 1)
    prog = ((step - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
    cos = peak_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def wsd(step, *, peak_lr: float, warmup: int, total: int, decay_frac: float = 0.1,
        min_frac: float = 0.01):
    """Warmup -> stable plateau -> short exponential-ish decay (MiniCPM §4)."""
    step = _f32(step)
    decay_start = total * (1 - decay_frac)
    warm = peak_lr * step / max(warmup, 1)
    prog = ((step - decay_start) / max(total - decay_start, 1)).clamp(0.0, 1.0)
    decay = peak_lr * torch.pow(min_frac, prog)
    out = torch.where(step < warmup, warm, torch.full_like(step, peak_lr))
    return torch.where(step > decay_start, decay, out)


SCHEDULES = {"cosine": cosine, "wsd": wsd}

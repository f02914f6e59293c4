"""Copy of ``repro/configs/shapes.py`` (identical apart from imports).

Assigned input shapes (one set shared by all LM-family archs).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of ``seq_len``); the others lower ``train_step``.  ``long_500k``
requires sub-quadratic attention — pure full-attention archs skip it (noted
in DESIGN.md §Arch-applicability and EXPERIMENTS.md).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "train"),  # fwd-only prefill
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# prefill is inference: it lowers forward-only (no optimizer update)
PREFILL = {"prefill_32k"}


def applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "skip: full-attention arch (long_500k needs sub-quadratic)"
    return True, ""


def cells(cfg: ModelConfig) -> List[Tuple[InputShape, bool, str]]:
    return [(s,) + applicable(cfg, s) for s in SHAPES.values()]

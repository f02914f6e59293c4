"""Int8 error-feedback gradient compression; counterpart of
``repro/distributed/compression.py``.

Quantize→dequantize each gradient leaf to int8 with a per-leaf scale before
the optimizer; the quantization error is carried in a residual buffer and
added back next step (error feedback keeps SGD/Adam convergence, 1-bit-Adam
style).  On a fabric the int8 representation is what crosses the links;
here the quantize/dequantize pair is the numerics-faithful simulation,
applied between gradient accumulation and the optimizer.  Trees are nested
dicts, walked in sorted key order as the reference's ``jax.tree`` walks
them.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.train.adamw import tree_leaves, tree_unflatten


def _q(g: torch.Tensor, ef: torch.Tensor):
    g32 = g.to(torch.float32) + ef
    scale = g32.abs().max().clamp_min(1e-12) / 127.0
    q = torch.round(g32 / scale).clamp_(-127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq, g32 - deq


def compress_decompress(grads: Any, ef: Any) -> Tuple[Any, Any]:
    """Returns (dequantized grads, new error-feedback residuals)."""
    out = [_q(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(ef))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))

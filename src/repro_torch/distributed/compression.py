"""Int8 error-feedback gradient compression; counterpart of
``repro/distributed/compression.py``.

Quantize→dequantize each gradient leaf to int8 with a per-leaf scale before
the optimizer; the quantization error is carried in a residual buffer and
added back next step (error feedback keeps SGD/Adam convergence, 1-bit-Adam
style).  On a fabric the int8 representation is what crosses the links;
here the quantize/dequantize pair is the numerics-faithful simulation,
applied between gradient accumulation and the optimizer.  Trees are nested
dicts, walked in sorted key order as the reference's ``jax.tree`` walks
them.  A sharded leaf (a DTensor) is quantized on its local shard with the
leaf's global maximum: the local maxima all-reduced over the mesh
dimensions that shard it, so every rank uses the reference's int8 grid.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.train.adamw import local, shard_dims, tree_leaves, tree_unflatten


def _q(g: torch.Tensor, ef: torch.Tensor, like=None):
    """``(dequantized, residual)`` of one leaf; ``like``: the DTensor whose
    local shard ``g`` is."""
    if isinstance(g, DTensor):
        if tuple(g.placements) != tuple(ef.placements):
            raise ValueError("a gradient and its residual must share placements")
        deq, res = _q(local(g), local(ef), g)
        return tuple(DTensor.from_local(t, g.device_mesh, g.placements,
                                        run_check=False) for t in (deq, res))
    g32 = g.to(torch.float32) + ef
    amax = g32.abs().max()
    for i in shard_dims(like):
        dist.all_reduce(amax, op=dist.ReduceOp.MAX,
                        group=like.device_mesh.get_group(i))
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.round(g32 / scale).clamp_(-127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq, g32 - deq


def compress_decompress(grads: Any, ef: Any) -> Tuple[Any, Any]:
    """Returns (dequantized grads, new error-feedback residuals)."""
    out = [_q(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(ef))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))

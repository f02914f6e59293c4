"""Parameter and train-state trees to and from numpy: the port's own module
(the reference has no counterpart), which carries a parameter, decode-cache
or train-state tree of the JAX package across to the port, and a train
state to and from the checkpoint store.

The reference's trees are nested dicts of arrays with the stacked
``layers`` axis first (two stacked axes for the hybrid's groups and the
VLM's super-blocks); the port's have the same keys and shapes, every
family's (MLA's latent projections and whisper's encoder included).  bfloat16
arrays (numpy's ``ml_dtypes.bfloat16``) keep their bits: they are viewed as
16-bit integers and reinterpreted as ``torch.bfloat16``, so a bf16 model
carries over exactly.  Going out, ``state_to_numpy`` writes a bf16 leaf's
16 bits as numpy ``'V2'`` (the card's machine has no ``ml_dtypes``): the
checkpoint store saves it with the descr numpy writes for
``ml_dtypes.bfloat16`` (``'<V2'``), so its file and hash are the reference's.

On a mesh (``distributed/sharding.py``) ``params_from_numpy`` and
``state_from_numpy`` place each leaf by its spec (every rank reads the
whole array and keeps its shard), and ``state_to_numpy`` gathers each
DTensor leaf to its whole value: every rank calls it, in the same order.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from torch.distributed.tensor import DTensor

from repro_torch.checkpoint.store import is_bf16_bits
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import place, placements_for, shard_tree


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)              # a writable copy: the cache is updated in place
    if is_bf16_bits(a.dtype):
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree, device="cuda", mesh=None, specs=None) -> Any:
    """A nested dict of arrays (anything ``np.asarray`` takes) as the same
    dict of tensors, in the same dtypes, on ``device`` (the card unless the
    caller asks for the CPU); with ``mesh``, placed by ``specs`` (a tree of
    specs of the same keys: ``param_pspecs``, ``state_pspecs``)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        out = {k: params_from_numpy(v, device) for k, v in tree.items()}
    else:
        out = _tensor(tree, device)
    return out if mesh is None else shard_tree(out, specs, mesh)


def state_to_numpy(tree) -> Any:
    """A tree of tensors (a train state: ``params``, ``m``, ``v``, ``step``
    and ``ef``) as the same dict of host numpy arrays: bf16 leaves as their
    bits in ``'V2'``, the rest in their own dtype.  Copies every leaf to the
    host (a documented synchronisation)."""
    if isinstance(tree, dict):
        return {k: state_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        tree = tree.full_tensor()
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def state_from_numpy(tree, like, mesh=None, specs=None) -> Any:
    """The inverse of ``state_to_numpy`` (a checkpoint's numpy tree, the
    port's or the reference's): each leaf a tensor on ``like``'s leaf's
    device, ``'V2'`` and bfloat16 leaves read as ``torch.bfloat16``, placed
    as ``like``'s leaf where that is a DTensor, or by ``specs`` on
    ``mesh``.  A dtype or (global) shape that differs from ``like``'s
    raises.  A reference state with no ``like`` comes across by
    ``params_from_numpy``."""
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, like[k], mesh,
                                    None if specs is None else specs[k])
                for k, v in tree.items()}
    t = _tensor(tree, like.device)
    if t.dtype != like.dtype or t.shape != like.shape:
        raise ValueError(f"a leaf of {t.dtype} {tuple(t.shape)} does not "
                         f"restore into {like.dtype} {tuple(like.shape)}")
    if isinstance(like, DTensor):
        return place(t, like.device_mesh, like.placements)
    return t if mesh is None else place(t, mesh, placements_for(specs, mesh))

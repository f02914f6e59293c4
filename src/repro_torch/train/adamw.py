"""AdamW over dict trees of tensors; counterpart of ``repro/train/adamw.py``.

Moments are kept in float32 regardless of parameter dtype; the update is
computed in float32 and cast back — the standard mixed-precision recipe
(no float32 master copy, as in the reference).  Trees are nested dicts
walked in sorted key order, the order ``jax.tree`` flattens a dict in.

``update`` writes the new parameters and moments into the given tensors
(the reference returns new trees; its launcher donates the old ones), in
pieces of at most ``PIECE`` elements, so its float32 temporaries stay a few
hundred MB whatever the leaf (a stacked leaf of a large model holds
billions of elements).  ``torch.optim.AdamW`` is not used: it keeps bf16
moments for bf16 parameters.

Sharded state (DTensor leaves, ``distributed/sharding.py``): the update is
elementwise over a parameter, its gradient and moments, which share their
placements, so it runs on the local shards (``_pieces`` of a sharded leaf
has no DTensor rule); ``global_norm`` sums each leaf's local squares over
the mesh dimensions that shard it, never over those that replicate it, so
every element counts once.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

#: elements of one piece of the in-place update (a 512 MB float32 temporary)
PIECE = 1 << 27


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_leaves(tree) -> List[Any]:
    """The leaves of a nested dict in sorted key order (a list's in its
    order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """A nested dict shaped like ``like`` holding ``leaves`` in
    ``tree_leaves`` order."""
    it = iter(leaves)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(fill(t) for t in node)
        return next(it)

    return fill(like)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and of trees shaped like it)."""
    leaves = zip(tree_leaves(tree), *(tree_leaves(r) for r in rest))
    return tree_unflatten(tree, [fn(*xs) for xs in leaves])


def init_moments(params) -> Tuple[Any, Any]:
    def z(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return tree_map(z, params), tree_map(z, params)


def local(t):
    """A DTensor's local shard (a replicated scalar's value); anything else
    as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def shard_dims(t) -> Tuple[int, ...]:
    """The mesh dimensions a DTensor is sharded over (none for a plain
    tensor)."""
    if not isinstance(t, DTensor):
        return ()
    return tuple(i for i, p in enumerate(t.placements) if isinstance(p, Shard))


def global_norm(tree) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ x²), each leaf in float32 (no float32 copy
    of a bf16 leaf is made).  Sharded leaves add their local squares, summed
    over the mesh dimensions that shard them: one all-reduce per set of
    such dimensions, in the same order on every rank."""
    groups = {}
    for x in tree_leaves(tree):
        sq = torch.linalg.vector_norm(local(x), dtype=torch.float32).square()
        groups.setdefault(shard_dims(x), []).append(sq)
    mesh = next((x.device_mesh for x in tree_leaves(tree)
                 if isinstance(x, DTensor)), None)
    total = []
    for dims in sorted(groups):
        part = torch.stack(groups[dims]).sum()
        for i in dims:
            dist.all_reduce(part, group=mesh.get_group(i))
        total.append(part)
    return torch.sqrt(torch.stack(total).sum())


def _clip_scale(n: torch.Tensor, max_norm: float) -> torch.Tensor:
    return (max_norm / n.clamp_min(1e-12)).clamp_max(1.0)


def clip_by_global_norm(tree, max_norm):
    n = global_norm(tree)
    scale = _clip_scale(n, max_norm)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), tree), n


def _pieces(t: torch.Tensor):
    return t.reshape(-1).split(PIECE)


@torch.no_grad()
def update(params, grads, m, v, step, lr, cfg: AdamWConfig):
    """Returns (new_params, new_m, new_v, grad_norm): ``params``, ``m`` and
    ``v`` updated in place.  ``step`` (the count of earlier updates) and
    ``lr`` may be device tensors: nothing here reads a value on the host.
    Each gradient is clipped and rounded to its own dtype first, as the
    reference's ``clip_by_global_norm`` returns it."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    step, lr = local(step), local(lr)
    t = (step.to(torch.float32) if isinstance(step, torch.Tensor)
         else torch.tensor(float(step))) + 1.0
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)
    for leaf in zip(tree_leaves(params), tree_leaves(grads),
                    tree_leaves(m), tree_leaves(v)):
        if len({tuple(x.placements) for x in leaf if isinstance(x, DTensor)}) > 1:
            raise ValueError("a parameter, its gradient and moments must share "
                             "their placements")
        p, g, m_, v_ = (local(x) for x in leaf)
        if not (p.is_contiguous() and m_.is_contiguous() and v_.is_contiguous()):
            raise ValueError("update writes parameters and moments in place: "
                             "they must be contiguous")
        for pp, gp, mp, vp in zip(_pieces(p), _pieces(g), _pieces(m_), _pieces(v_)):
            g32 = (gp.to(torch.float32) * scale).to(gp.dtype).to(torch.float32)
            mp.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
            vp.mul_(cfg.b2).add_(g32 * g32, alpha=1 - cfg.b2)
            del g32
            upd = (mp / bc1).div_((vp / bc2).sqrt_().add_(cfg.eps))
            p32 = pp.to(torch.float32)
            upd.add_(p32, alpha=cfg.weight_decay).mul_(lr)
            if pp.dtype == torch.float32:
                pp.sub_(upd)
            else:
                pp.copy_(p32.sub_(upd))
    return params, m, v, gnorm

"""Logical-axis → mesh-axis sharding rules (FSDP + TP + pod-DP) on DTensor
placements; counterpart of ``repro/distributed/sharding.py``.

Parameters declare logical axes (``embed``, ``heads``, ``ffn``, ``vocab``,
``experts``, ...).  The rules shard every tensor-parallel dimension over
``model``, the d_model dimension over ``data`` (ZeRO-3/FSDP) and replicate
across ``pod`` (pure DP between pods), as the reference's do.  A spec
(:class:`P`) has the reference's ``PartitionSpec`` entries; on a
:class:`~torch.distributed.device_mesh.DeviceMesh` it becomes one
``Shard(dim)`` or ``Replicate()`` a mesh dimension (:func:`placements_for`)
and a tensor a ``DTensor`` (:func:`shard_tree`).  The spec functions take a
``DeviceMesh`` or a plain ``{axis: size}`` mapping, so specs for a 512-rank
mesh can be computed without one.

What GSPMD inserts on its own, the port does explicitly:

  * :func:`fsdp` — a weight's FSDP dimensions (the mesh dimensions
    ``embed`` maps to) gathered where it is used, one tensor at a time: the
    per-layer all-gather forward; DTensor's backward of it is the
    reduce-scatter of the gradient.  The whole model is never gathered.
  * :func:`constrain` — the reference's activation constraints, a
    redistribute of a DTensor; a no-op without a mesh.  A plain tensor
    under a mesh is taken as replicated (each rank holds all of it) and cut
    to the spec locally.
  * :func:`mesh_context` also enters DTensor's ``implicit_replication``:
    plain tensors mixed with DTensors in the forward act as replicated
    operands.  Where such a mix would run again in the backward (rope's
    tables), the model makes the plain tensor a replicated DTensor itself
    (``replicated_like``): autograd's device thread on the card may not
    see the flag.  The context is thread-local;
    :func:`carry_mesh` carries it into checkpoint recomputation, which
    autograd runs on another thread on the card.
  * :func:`local_shard_offsets` gives a rank's offsets into a sharded
    dimension, for the code that runs on local shards (attention's heads,
    the SSD's heads and ``din`` columns, the decode cache's length);
    :func:`local_operand` hands such code a tensor whose gradient comes
    back as the partial sum it is, and :func:`write_position` writes one
    position of a decode cache on the rank that holds it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

Rules = Dict[str, Union[None, str, Tuple[str, ...]]]

DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    "embed": "data",        # FSDP dim on params
    "heads": "model",
    "kv": "model",
    "ffn": "model",
    "vocab": "model",
    "experts": "model",
    "ssm_in": "model",
    "layers": None,
    "cache_seq": "model",   # context-parallel decode
    "cache_batch": ("pod", "data"),
    # sequence-parallel activations (Megatron-SP): residual-stream tensors at
    # block boundaries shard their sequence dim over "model"; attention/mlp
    # re-gather internally.
    "seq": "model",
    "capacity": "data",     # MoE dispatch-bucket capacity dim
}

SINGLE_POD_RULES: Rules = dict(DEFAULT_RULES, batch=("data",), cache_batch=("data",))


class P(tuple):
    """A partition spec: per tensor dimension a mesh-axis name, a tuple of
    names (one dimension over several mesh dimensions, major to minor) or
    ``None`` (replicated).  Entries are normalised as the reference's
    ``PartitionSpec`` normalises them (a one-name tuple is the name, an
    empty one ``None``, a list a tuple), and equal to it entry for entry."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e

        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


MeshLike = Union["torch.distributed.device_mesh.DeviceMesh", Mapping[str, int]]


def mesh_sizes(mesh: MeshLike) -> Dict[str, int]:
    """``{axis: size}`` in the mesh's axis order."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def rules_for(mesh: Optional[MeshLike], seq_shard: bool = True) -> Rules:
    if mesh is None:
        return DEFAULT_RULES
    base = DEFAULT_RULES if "pod" in mesh_sizes(mesh) else SINGLE_POD_RULES
    if not seq_shard:
        base = dict(base, seq=None)
    return base


def _axis_size(sizes: Mapping[str, int], mapped) -> int:
    if mapped is None:
        return 1
    if isinstance(mapped, str):
        return sizes[mapped]
    out = 1
    for m in mapped:
        out *= sizes[m]
    return out


def _names(mapped) -> Tuple[str, ...]:
    return (mapped,) if isinstance(mapped, str) else tuple(mapped)


def spec_for(axes: Sequence[Optional[str]], rules: Rules,
             shape: Optional[Sequence[int]] = None,
             mesh: Optional[MeshLike] = None) -> P:
    """Logical axes -> spec.  With ``shape`` and ``mesh``, any mapping
    whose mesh extent does not divide the dimension falls back to
    replicated (e.g. kv=8 heads on a 16-way model axis, odd vocabs)."""
    sizes = mesh_sizes(mesh) if mesh is not None else None
    out = []
    used = set()
    for i, a in enumerate(axes):
        mapped = rules.get(a) if a is not None else None
        if mapped is not None and shape is not None and sizes is not None:
            n = _axis_size(sizes, mapped)
            if n > 1 and (shape[i] % n != 0):
                mapped = None
        # a mesh axis may appear at most once per spec: first dim wins
        # (caches prefer cache_seq over kv on the model axis)
        if mapped is not None:
            names = _names(mapped)
            if any(m in used for m in names):
                mapped = None
            else:
                used.update(names)
        out.append(mapped)
    return P(*out)


def placements_for(spec: Sequence, mesh: MeshLike) -> Tuple:
    """One ``Shard(dim)`` or ``Replicate()`` a mesh dimension.  An entry of
    several axes, such as ``("pod", "data")``, shards its dimension over
    each of them; DTensor splits a dimension over its mesh dimensions in
    mesh order, which is the reference's major-to-minor order only when the
    entry lists its axes in mesh order, so any other order raises."""
    names = list(mesh_sizes(mesh))
    out: List = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in _names(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} lists its axes out of the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def param_pspecs(specs_tree, rules: Rules, mesh: Optional[MeshLike] = None):
    from repro_torch.models.layers import map_specs

    return map_specs(lambda s: spec_for(s.axes, rules, s.shape, mesh), specs_tree)


# -- placing tensors ---------------------------------------------------------


def local_shard_offsets(shape: Sequence[int], placements, mesh) -> Tuple[
        Tuple[int, ...], Tuple[int, ...]]:
    """This rank's local shape and its offsets into each dimension of a
    tensor of global ``shape`` under ``placements`` (every sharded
    dimension divides evenly)."""
    local = list(shape)
    offset = [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            d, n = pl.dim % len(shape), mesh.size(i)
            if local[d] % n:
                raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                                 f"split evenly over {n} ranks")
            local[d] //= n
            offset[d] += coord[i] * local[d]
    return tuple(local), tuple(offset)


def place(t: torch.Tensor, mesh, placements) -> DTensor:
    """A tensor every rank holds whole, as a DTensor of ``placements``:
    each rank keeps its own shard (a copy, so the whole one can be freed)
    and nothing crosses ranks.  A DTensor is redistributed."""
    placements = tuple(placements)
    if isinstance(t, DTensor):
        return t if tuple(t.placements) == placements else \
            t.redistribute(mesh, placements)
    shape, off = local_shard_offsets(t.shape, placements, mesh)
    local = t
    for d, (n, o) in enumerate(zip(shape, off)):
        if n != t.shape[d]:
            local = local.narrow(d, o, n)
    if local.numel() != t.numel():
        local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements, run_check=False)


def shard_tree(tree, specs, mesh):
    """Every leaf of ``tree`` placed by the spec of the same key path in
    ``specs`` (``param_pspecs``/``state_pspecs``/``batch_pspecs``): the
    counterpart of the reference's ``param_shardings`` (a ``NamedSharding``
    tree) and of the ``device_put`` that applies it."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return place(tree, mesh, placements_for(specs, mesh))


def full_tree(tree):
    """Every DTensor leaf gathered to its whole value (checkpoints and
    tests, never a step); plain leaves as they are."""
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


# -- activation sharding constraints (no-op outside a mesh context) ---------

_STATE = threading.local()


@contextlib.contextmanager
def mesh_context(mesh, rules: Optional[Rules] = None):
    """Within: ``constrain`` and ``fsdp`` act on ``mesh`` by ``rules``, and
    plain tensors mixed with DTensors count as replicated.  ``None``: no
    mesh (everything a no-op)."""
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = (mesh, rules or rules_for(mesh)) if mesh is not None else None
    try:
        # implicit_replication() turns the flag off on exit, whatever it
        # was: entered only where it is off, so a nested context (a
        # recomputation inside the step's) leaves the outer one's on
        if mesh is None or DTensor._op_dispatcher._allow_implicit_replication:
            yield
        else:
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                yield
    finally:
        _STATE.ctx = prev


def current_mesh():
    ctx = getattr(_STATE, "ctx", None)
    return ctx[0] if ctx else None


def carry_mesh(fn):
    """``fn`` run under the mesh context current where ``carry_mesh`` is
    called, on any thread: the checkpointed layers and chunks run again in
    the backward, which autograd runs on the device's own thread on the
    card, where this thread-local context is not set."""
    ctx = getattr(_STATE, "ctx", None)
    if ctx is None:
        return fn

    def run(*args, **kwargs):
        with mesh_context(*ctx):
            return fn(*args, **kwargs)

    return run


def constrained_spec(shape: Sequence[int], axes: Sequence[Optional[str]],
                     sizes: Mapping[str, int], rules: Rules) -> P:
    """``constrain``'s spec: axes whose mesh extent does not divide the
    dimension (or exceeds it) are dropped to replicated rather than
    padded, and so are axes of extent 1."""
    eff = []
    used = set()
    for i, a in enumerate(axes):
        mapped = rules.get(a) if a is not None else None
        n = _axis_size(sizes, mapped)
        if mapped is None or n <= 1 or shape[i] % n != 0 or shape[i] < n:
            eff.append(None)
            continue
        names = _names(mapped)
        if any(m in used for m in names):
            eff.append(None)
        else:
            used.update(names)
            eff.append(mapped)
    return P(*eff)


def constrain(x, *axes: Optional[str]):
    """Apply a sharding constraint by logical axis names (no-op without a
    mesh): ``x`` redistributed to ``constrained_spec``'s placements."""
    ctx = getattr(_STATE, "ctx", None)
    if ctx is None:
        return x
    mesh, rules = ctx
    spec = constrained_spec(x.shape, axes, mesh_sizes(mesh), rules)
    return place(x, mesh, placements_for(spec, mesh))


def fsdp(w):
    """A parameter with its FSDP dimensions gathered: under a mesh, the
    mesh dimensions the ``embed`` rule maps to made ``Replicate``; a plain
    tensor, or no mesh, as it is."""
    ctx = getattr(_STATE, "ctx", None)
    if ctx is None or not isinstance(w, DTensor):
        return w
    mesh, rules = ctx
    gather = set(_names(rules.get("embed") or ()))
    names = mesh.mesh_dim_names
    pls = tuple(Replicate() if names[i] in gather and isinstance(p, Shard)
                else p for i, p in enumerate(w.placements))
    return w if pls == tuple(w.placements) else w.redistribute(mesh, pls)


def replicated_like(t: torch.Tensor, x):
    """``t``, a tensor every rank computes alike, as a replicated DTensor
    on ``x``'s mesh where ``x`` is a DTensor; else ``t`` as it is."""
    if not isinstance(x, DTensor):
        return t
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def mesh_dims_sharding(x: DTensor, dim: int) -> List[int]:
    """The mesh dimensions over which ``x`` shards tensor dimension
    ``dim``, in mesh order."""
    dim %= x.dim()
    return [i for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim % x.dim() == dim]


def local_operand(t, out_placements):
    """``t``'s local tensor for code that runs on each rank's shard and
    whose result is placed by ``out_placements``: over a mesh dimension
    that splits the result but not ``t`` (a replicated weight used by each
    rank's own batch rows or heads), ``t``'s gradient comes back as a
    partial sum over that dimension's ranks.  A plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    grad = tuple(Partial() if isinstance(o, Shard) and not isinstance(p, Shard)
                 else p for p, o in zip(t.placements, out_placements))
    return t.to_local(grad_placements=grad)


def write_position(cache, value, idx: int, dim: int = 1) -> None:
    """``cache``'s entry ``idx`` along ``dim`` set to ``value`` (of size 1
    there) in place.  Under a mesh ``value`` is placed like the cache in
    its other dimensions and only the rank whose shard holds ``idx``
    writes, into its local tensor (a DTensor's index assignment on the
    sharded dimension is not a write of one shard)."""
    if not isinstance(cache, DTensor):
        cache.narrow(dim, idx, 1).copy_(value)
        return
    mesh = cache.device_mesh
    dim %= cache.dim()
    others = tuple(Replicate() if isinstance(p, Shard) and p.dim % cache.dim() == dim
                   else p for p in cache.placements)
    local = place(value, mesh, others).to_local()
    (shape, off) = local_shard_offsets(cache.shape, cache.placements, mesh)
    if off[dim] <= idx < off[dim] + shape[dim]:
        cache.to_local().narrow(dim, idx - off[dim], 1).copy_(local)

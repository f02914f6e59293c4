"""Domain parallelism for the aggregate engine on ``torch.distributed``;
counterpart of ``repro/core/distributed.py`` (paper Fig. 1 layer 7).

LMFAO partitions the largest relation across threads and merges per-thread
view hashmaps.  Here one process is one rank of a mesh axis (SPMD: every
rank makes the same session calls in the same order): each rank keeps its
row shard of the partitioned relation and the other relations whole, runs
the same fused scan steps on its shard, and the (small, dense) view
tensors of every step over that relation are summed across the axis by
``all_reduce`` right after the step — the reference's ``psum``, in the
collective-friendly direction, since views are orders of magnitude smaller
than fact tables.  Fusion stays sound under sharding because a view is
summed before any later step gathers it.

Every collective the engine issues is an ``all_reduce`` on the axis's
process group: gloo on CUDA tensors offers only ``all_reduce`` and
``broadcast``, so a gather is a scatter into a zeroed buffer plus a sum
(``data/relations.py``).  A collective that fails raises.

The reference's ``lower_sharded`` is a ``jax.jit`` lowering and, like
``CompiledBatch.lower``, has no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

#: delete batches are padded with a global row id no live row can hold
GID_SENTINEL = np.iinfo(np.int32).max


@dataclasses.dataclass(frozen=True)
class AxisInfo:
    """One mesh axis as this rank sees it: its process group, its size and
    this rank's index along it."""

    group: object
    size: int
    index: int


def mesh_axes(mesh):
    """The mesh's axis names (``DeviceMesh.mesh_dim_names``)."""
    return tuple(getattr(mesh, "mesh_dim_names", None) or ())


def check_axis(mesh, axis: str) -> None:
    """Raise unless ``mesh`` has an axis named ``axis`` (the reference's
    ``ExecutionConfig`` check)."""
    if axis not in mesh_axes(mesh):
        raise ValueError(f"mesh has no axis {axis!r} "
                         f"(axes: {mesh_axes(mesh)})")


def axis_info(mesh, axis: str) -> AxisInfo:
    check_axis(mesh, axis)
    return AxisInfo(group=mesh.get_group(axis), size=int(mesh.size(
        mesh_axes(mesh).index(axis))), index=int(mesh.get_local_rank(axis)))


def rows_per_shard(n: int, ndev: int) -> int:
    """Rows of each rank's contiguous block of an ``n``-row relation."""
    return -(-max(n, 1) // ndev)


def shard_columns(db, ax: AxisInfo, shard_rel: str):
    """Per-relation columns of this rank: its row block ``[s·rps, (s+1)·rps)``
    of ``shard_rel`` (``rps = ceil(n / ndev)``; the last block padded with
    zero rows to ``rps``), every other relation whole.  Returns ``(cols,
    offset)``: the block's first global row."""
    cols = {}
    offset = 0
    for name, rel in db.relations.items():
        if name != shard_rel:
            cols[name] = dict(rel.columns)
            continue
        n = rel.n_rows
        rps = rows_per_shard(n, ax.size)
        offset = ax.index * rps
        lo, hi = min(offset, n), min(offset + rps, n)
        part = {}
        for a, c in rel.columns.items():
            c = c[lo:hi]
            if hi - lo < rps:
                c = torch.cat([c, c.new_zeros(rps - (hi - lo))])
            part[a] = c
        cols[name] = part
    return cols, offset


def sharded_runner(plan, db, mesh, axis: str, shard_rel: str, n_nodes=None):
    """Bind ``plan`` for this rank's shard of ``shard_rel`` over ``axis``:
    returns ``(run, cols)`` where ``run(cols, params)`` scans the rank's
    columns in its global window and all-reduces the views of every step
    over ``shard_rel`` on the axis's group (the result is the same on every
    rank).  ``n_nodes`` is the param-batch (node) axis size for plans with
    batched params; batched views all-reduce with the node axis intact."""
    ax = axis_info(mesh, axis)
    cols, offset = shard_columns(db, ax, shard_rel)
    bound = plan.bind(db.sizes(), n_nodes=n_nodes, device=db.device)

    def run(columns, params):
        return bound(columns, params, offsets={shard_rel: offset},
                     psum_groups={shard_rel: ax.group})

    return run, cols


# ------------------------------------------------------------------ sharded IVM
# Building blocks of the sharded delta tick (core/ivm.py).  Update staging
# is explicit: every rank holds the whole host update and copies to its
# device what it keeps.

def put_replicated(arr: np.ndarray, device) -> torch.Tensor:
    """This rank's copy of a whole host array on ``device`` (every rank
    makes the same copy: the array is replicated).  On the card through
    pinned memory, so the caller does not wait."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def put_sharded(arr: np.ndarray, ax: AxisInfo, device) -> torch.Tensor:
    """This rank's contiguous block of a host array whose leading dimension
    is a multiple of the axis size, on ``device``."""
    blk = arr.shape[0] // ax.size
    return put_replicated(arr[ax.index * blk:(ax.index + 1) * blk], device)


def strided_insert_layout(block: int, ndev: int) -> np.ndarray:
    """Host permutation laying a padded insert batch out so that global
    insert rank ``j`` lands on shard ``j % ndev`` at local slot ``j //
    ndev`` — round-robin keeps shards balanced under any update pattern,
    and shard ``s``'s valid inserts are the first ``ceil((n_ins - s) /
    ndev)`` rows of its contiguous block."""
    return np.arange(block * ndev).reshape(block, ndev).T.reshape(-1)


def put_strided(arr: np.ndarray, block: int, ax: AxisInfo,
                device) -> torch.Tensor:
    """This rank's block of the strided insert layout of ``arr`` padded
    with zero rows to ``block · ndev``: ``put_sharded(padded[
    strided_insert_layout(block, ndev)], ax, device)``, read as one strided
    slice instead of a permutation of the whole batch."""
    padded = np.pad(arr, (0, block * ax.size - arr.shape[0]))
    return put_replicated(padded[ax.index::ax.size], device)


def local_insert_count(n_ins: int, shard: int, ndev: int, block: int) -> int:
    """Valid inserts owned by ``shard`` under the strided layout (a host
    int: every rank knows every shard's share)."""
    return int(np.clip((n_ins - shard + ndev - 1) // ndev, 0, block))


def local_delete(gids: torch.Tensor, live: torch.Tensor,
                 del_gids: torch.Tensor, del_pad: int):
    """Route a replicated, sorted, sentinel-padded global delete batch to
    the rows this shard owns, by matching oracle positions (gids).

    Returns ``(hit, slots, n_del_local)``: a boolean mask over the shard's
    rows, the (ascending, ``del_pad``-sized) local slots of the deleted
    rows — past the hits, the last row, which its weight of 0 removes —
    and their count as a 0-d device tensor.  No host sync: slot ``k`` is
    where the hits' running count first reaches ``k + 1``."""
    n = int(gids.shape[0])
    if n == 0:
        zero = torch.zeros((), dtype=torch.int64, device=gids.device)
        return (torch.zeros(0, dtype=torch.bool, device=gids.device),
                torch.zeros(del_pad, dtype=torch.int64, device=gids.device),
                zero)
    pos = torch.searchsorted(del_gids, gids)
    hit = (del_gids[pos.clamp(max=del_pad - 1)] == gids) & live
    ck = torch.cumsum(hit, 0)
    want = torch.arange(1, del_pad + 1, device=gids.device)
    slots = torch.searchsorted(ck, want).clamp(max=n - 1)
    return hit, slots, ck[-1]


def local_advance(buffers: Dict[str, torch.Tensor], gids: torch.Tensor,
                  n_valid: torch.Tensor, n_scan: int, hit, del_gids,
                  ins: Dict[str, torch.Tensor], gid_base: int, shard: int,
                  ndev: int, ins_block: int, n_ins_local: int):
    """Shard-local epoch advance into new buffers, without a host sync:
    compact deleted rows out of the scanned prefix ``[0, n_scan)`` keeping
    the survivors' order (a stable partition by the keep mask's running
    count, as ``_resident_advance`` does), renumber surviving gids to the
    oracle's post-delete positions (``gid' = gid − #deleted gids < gid``),
    then write this shard's insert block behind the survivors with fresh
    trailing gids ``gid_base + shard + ndev · i`` (round-robin, matching
    the strided insert layout).  The block's pad rows land on dead slots,
    so every slot below the capacity keeps values a scan may read: codes
    in their domains, finite floats.  ``n_valid`` (the shard's live rows)
    is a 0-d device tensor; returns the new buffers, gids and count."""
    cap = gids.shape[0]
    device = gids.device
    n_after = n_valid
    dest = None
    if hit is not None:
        live = torch.arange(n_scan, device=device) < n_valid
        keep = live & ~hit[:n_scan]
        ck = torch.cumsum(keep, 0)
        n_after = ck[-1] if n_scan else n_valid
        dest = torch.where(keep, ck - 1,
                           n_after + torch.arange(n_scan, device=device) - ck)
        gids = gids - torch.searchsorted(del_gids, gids)
    out, new_gids = {}, gids.new_empty(cap)
    for a, buf in list(buffers.items()) + [(None, gids)]:
        new = new_gids if a is None else buf.new_empty(cap)
        new[n_scan:].copy_(buf[n_scan:])
        if dest is not None:
            new.index_copy_(0, dest, buf[:n_scan])
        else:
            new[:n_scan].copy_(buf[:n_scan])
        if a is not None:
            out[a] = new
    if ins_block:
        pos = n_after + torch.arange(ins_block, device=device)
        for a, new in out.items():
            new.index_copy_(0, pos, ins[a].to(new.dtype))
        fresh = gid_base + shard + ndev * torch.arange(
            ins_block, device=device, dtype=new_gids.dtype)
        new_gids.index_copy_(0, pos, fresh)
    return out, new_gids, n_after + n_ins_local

"""Columnar relation storage on a torch device; counterpart of
``repro/data/relations.py``.

Relations are dictionaries of same-length 1-D tensors: int32 codes for
key/categorical attributes, float32 for continuous ones, all on one device.

Updates: :meth:`Relation.append` / :meth:`Relation.delete_rows` produce new
relations, and :class:`DeltaBatchUpdate` bundles per-relation insert/delete
batches — the unit consumed by maintained views (``core/ivm.py``) and by
:func:`apply_delta`, which applies an update to a plain :class:`Database`
(the from-scratch oracle the maintained path is tested against).

:class:`ResidentRelation` is what maintained views keep between updates:
capacity-padded (power-of-two) column buffers plus the valid-row count,
which the host always knows, so appends and deletes are device
scatter/compaction ops and a steady-state update never copies relation
columns to the host or waits for the card.  :class:`ShardedResidentRelation`
is one rank's row shard of a relation partitioned over a mesh axis
(``core/distributed.py``): its own valid prefix, which after a delete only
the device knows, and the rows' global ids.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import schema as sch


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def check_update_columns(dbs: sch.DatabaseSchema, rel_name: str,
                         columns: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Validate + cast an insert batch for ``rel_name`` (dtype/domain checks
    mirroring :meth:`Relation.validate`); returns engine-dtype *host numpy*
    columns — callers decide when the batch crosses to the device (a
    maintained view's update pads on the host first, then copies once)."""
    rs = dbs.relation(rel_name)
    if set(columns) != set(rs.attrs):
        raise ValueError(
            f"update for {rel_name!r}: columns {sorted(columns)} != schema {sorted(rs.attrs)}")
    n = int(np.asarray(next(iter(columns.values()))).shape[0])
    out: Dict[str, np.ndarray] = {}
    for a in rs.attrs:
        col = np.asarray(columns[a])
        if col.shape != (n,):
            raise ValueError(
                f"update for {rel_name!r}: column {a!r} shape {col.shape} != ({n},)")
        attr = dbs.attr(a)
        if attr.is_discrete:
            if not np.issubdtype(col.dtype, np.integer):
                raise ValueError(
                    f"{rel_name}.{a}: discrete update column must be integer, got {col.dtype}")
            codes = col.astype(np.int32)
            if codes.size and (codes.min() < 0 or codes.max() >= attr.domain):
                raise ValueError(
                    f"{rel_name}.{a}: update codes outside [0, {attr.domain}) "
                    f"(min {codes.min()}, max {codes.max()})")
            out[a] = codes
        else:
            if not np.issubdtype(col.dtype, np.floating):
                raise ValueError(
                    f"{rel_name}.{a}: continuous update column must be float, got {col.dtype}")
            out[a] = col.astype(np.float32)
    return out


def check_delete_idx(rel_name: str, idx: np.ndarray, n_rows: int) -> np.ndarray:
    """Validate a positional delete batch: unique integer indices in
    ``[0, n_rows)`` (shared by :meth:`Relation.delete_rows`,
    :meth:`DeltaBatchUpdate.validate`, and the maintained apply path).
    Duplicates are found by sorting: recent NumPy's hash-based
    ``np.unique`` is many times slower on a batch of a million indices."""
    idx = np.asarray(idx)
    if idx.size == 0:
        return idx.reshape(0).astype(np.int64)
    if not np.issubdtype(idx.dtype, np.integer):
        raise ValueError(f"delete from {rel_name!r}: indices must be integer, got {idx.dtype}")
    if idx.min() < 0 or idx.max() >= n_rows:
        raise ValueError(
            f"delete from {rel_name!r}: indices outside [0, {n_rows}) "
            f"(min {idx.min()}, max {idx.max()})")
    srt = np.sort(idx, axis=None)
    if (srt[1:] == srt[:-1]).any():
        raise ValueError(f"delete from {rel_name!r}: duplicate row indices")
    return idx


def _is_int(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point and dtype != torch.bool


@dataclasses.dataclass
class Relation:
    name: str
    columns: Dict[str, torch.Tensor]

    @property
    def n_rows(self) -> int:
        return int(next(iter(self.columns.values())).shape[0])

    def column(self, attr: str) -> torch.Tensor:
        return self.columns[attr]

    def validate(self, dbs: sch.DatabaseSchema) -> None:
        rs = dbs.relation(self.name)
        if set(self.columns) != set(rs.attrs):
            raise ValueError(
                f"relation {self.name!r}: columns {sorted(self.columns)} != schema {sorted(rs.attrs)}")
        n = self.n_rows
        for a, col in self.columns.items():
            if tuple(col.shape) != (n,):
                raise ValueError(f"relation {self.name!r}: column {a!r} shape {tuple(col.shape)} != ({n},)")
            if dbs.attr(a).is_discrete:
                if not _is_int(col.dtype):
                    raise ValueError(f"{self.name}.{a}: discrete column must be integer, got {col.dtype}")
            elif not col.dtype.is_floating_point:
                raise ValueError(f"{self.name}.{a}: continuous column must be float, got {col.dtype}")

    def append(self, columns: Mapping[str, np.ndarray],
               dbs: Optional[sch.DatabaseSchema] = None) -> "Relation":
        """New relation with ``columns`` rows appended.  With a schema the
        batch is validated and cast (:func:`check_update_columns`).  Without
        one, appending to a discrete (integer) column is an error: its code
        domain is unknown, so out-of-range codes could not be checked here
        and would silently drop out of the segment sums.  Schema-less
        appends therefore only accept all-continuous relations (names,
        lengths and dtype kinds still checked)."""
        if dbs is not None:
            cast = check_update_columns(dbs, self.name, columns)
        else:
            if set(columns) != set(self.columns):
                raise ValueError(
                    f"append to {self.name!r}: columns {sorted(columns)} != {sorted(self.columns)}")
            n = int(np.asarray(next(iter(columns.values()))).shape[0])
            cast = {}
            for a, cur in self.columns.items():
                col = np.asarray(columns[a])
                if col.shape != (n,):
                    raise ValueError(
                        f"append to {self.name!r}: column {a!r} shape {col.shape} != ({n},)")
                if _is_int(cur.dtype) != np.issubdtype(col.dtype, np.integer):
                    raise ValueError(
                        f"append to {self.name}.{a}: dtype kind {col.dtype} != {cur.dtype}")
                if _is_int(cur.dtype):
                    raise ValueError(
                        f"append to {self.name}.{a}: discrete column codes cannot "
                        "be bounds-checked without a schema (out-of-range codes "
                        "would silently corrupt aggregates); pass dbs=")
                cast[a] = col
        return Relation(self.name, {
            a: torch.cat([c, torch.from_numpy(np.ascontiguousarray(cast[a])).to(
                device=c.device, dtype=c.dtype)])
            for a, c in self.columns.items()})

    def delete_rows(self, idx: np.ndarray) -> "Relation":
        """New relation with the rows at positions ``idx`` removed, the rest
        in their order.  Indices must be unique and in ``[0, n_rows)`` —
        deletes are positional, so a duplicate would silently delete fewer
        tuples than the delta scan subtracts."""
        idx = check_delete_idx(self.name, idx, self.n_rows)
        if idx.size == 0:
            return Relation(self.name, dict(self.columns))
        keep = np.ones(self.n_rows, dtype=bool)
        keep[idx] = False
        mask = torch.from_numpy(keep)
        return Relation(self.name, {a: c[mask.to(c.device)]
                                    for a, c in self.columns.items()})


@dataclasses.dataclass
class Database:
    schema: sch.DatabaseSchema
    relations: Dict[str, Relation]

    def validate(self) -> None:
        for r in self.relations.values():
            r.validate(self.schema)
        if set(self.relations) != set(self.schema.relations):
            raise ValueError("database relations do not match schema relations")

    def relation(self, name: str) -> Relation:
        return self.relations[name]

    def sizes(self) -> Dict[str, int]:
        return {n: r.n_rows for n, r in self.relations.items()}

    def total_tuples(self) -> int:
        return sum(self.sizes().values())

    @property
    def device(self) -> torch.device:
        """The device the relations' columns lie on."""
        return next(iter(next(iter(self.relations.values())).columns.values())).device


def from_numpy(dbs: sch.DatabaseSchema,
               tables: Mapping[str, Mapping[str, np.ndarray]],
               device) -> Database:
    """Build a Database on ``device`` from host numpy columns, casting to
    engine dtypes; discrete codes are checked against their domains on the
    host first."""
    rels = {}
    for name, cols in tables.items():
        rs = dbs.relation(name)
        tcols = {}
        for a in rs.attrs:
            col = np.asarray(cols[a])
            attr = dbs.attr(a)
            if attr.is_discrete:
                codes = col.astype(np.int32)
                if codes.size and (codes.min() < 0 or codes.max() >= attr.domain):
                    raise ValueError(
                        f"{name}.{a}: codes outside [0, {attr.domain}) "
                        f"(min {codes.min()}, max {codes.max()})")
                tcols[a] = torch.from_numpy(np.ascontiguousarray(codes)).to(device)
            else:
                tcols[a] = torch.from_numpy(
                    np.ascontiguousarray(col.astype(np.float32))).to(device)
        rels[name] = Relation(name, tcols)
    db = Database(dbs, rels)
    db.validate()
    return db


def sort_by(rel: Relation, attrs: list) -> Relation:
    """Sort a relation by the given attribute order (LMFAO's trie order)."""
    keys = [rel.columns[a].cpu().numpy() for a in reversed(attrs)]
    order = torch.from_numpy(np.lexsort(keys))
    return Relation(rel.name, {a: c[order.to(c.device)]
                               for a, c in rel.columns.items()})


# ------------------------------------------------------- device residency

def _resident_advance(buffers: Mapping[str, torch.Tensor], n_valid: int,
                      ins: Mapping[str, torch.Tensor],
                      del_idx: Optional[torch.Tensor], n_ins: int, n_del: int,
                      capacity: int) -> Dict[str, torch.Tensor]:
    """Device-side relation update into new ``capacity``-row buffers:
    delete ``del_idx[:n_del]`` from the valid prefix ``[0, n_valid)``
    keeping the survivors' order (the host oracle's boolean-mask delete,
    :meth:`Relation.delete_rows`), then append ``ins[a][:n_ins]``.

    Compaction is a stable partition without a host round trip: a keep
    mask, its running sum for the survivors' destinations, and the deleted
    rows' ranks behind them, so the destinations are a permutation of the
    prefix and one ``index_copy_`` per column moves it.  ``del_idx`` may
    carry pads past ``n_del`` (any value); ``ins`` columns may carry pad
    rows past ``n_ins``.  The input buffers are only read: a published
    epoch keeps them."""
    n_after = n_valid - n_del
    dest = None
    if n_del:
        device = next(iter(buffers.values())).device
        keep = torch.ones(n_valid, dtype=torch.bool, device=device)
        keep.index_fill_(0, del_idx[:n_del].long(), False)
        ck = torch.cumsum(keep, 0)
        dest = torch.where(keep, ck - 1,
                           torch.arange(n_after, n_after + n_valid,
                                        device=device) - ck)
    out = {}
    for a, buf in buffers.items():
        new = buf.new_empty(capacity)
        if dest is not None:
            new.index_copy_(0, dest, buf[:n_valid])
        elif n_valid:
            new[:n_valid].copy_(buf[:n_valid])
        if n_ins:
            new[n_after:n_after + n_ins].copy_(ins[a][:n_ins])
        out[a] = new
    return out


@dataclasses.dataclass(frozen=True)
class ResidentRelation:
    """A relation kept on its device between updates: power-of-two
    *capacity* column buffers and the valid-row count ``n_valid``, a host
    int (the reference also carries it as a device scalar, to keep one jit
    trace; the port's scans take the host count and read ``[0, n_valid)``).

    Rows ``[0, n_valid)`` are live and ordered exactly like the equivalent
    host :class:`Relation`; rows beyond are never read.  Updates are
    functional — buffers are never written after they are built, so a
    published epoch's relations stay readable while the next one builds."""

    name: str
    buffers: Dict[str, torch.Tensor]
    n_valid: int

    @property
    def capacity(self) -> int:
        return int(next(iter(self.buffers.values())).shape[0])

    @classmethod
    def from_relation(cls, rel: Relation) -> "ResidentRelation":
        n = rel.n_rows
        cap = next_pow2(max(n, 1))
        bufs = {a: torch.cat([c, c.new_zeros(cap - n)]) if cap > n else c
                for a, c in rel.columns.items()}
        return cls(rel.name, bufs, n)

    @property
    def scan_valid(self) -> int:
        """The valid rows a scan of :meth:`columns` counts."""
        return self.n_valid

    def columns(self) -> Dict[str, torch.Tensor]:
        """The live rows of every column (views of the buffers)."""
        return {a: c[:self.n_valid] for a, c in self.buffers.items()}

    def to_relation(self) -> Relation:
        return Relation(self.name, self.columns())

    def advance(self, ins: Optional[Mapping[str, torch.Tensor]],
                del_idx: Optional[torch.Tensor],
                n_ins: int, n_del: int) -> "ResidentRelation":
        """Functional update: delete then append, all on the device.  ``ins``
        columns and ``del_idx`` are device tensors that may be padded past
        the true counts ``n_ins``/``n_del`` (host ints).  Capacity grows by
        doubling, so a growing stream re-keys the tick runners only log2
        times."""
        n_new = self.n_valid - n_del + n_ins
        cap = max(self.capacity, next_pow2(max(n_new, 1)))
        bufs = _resident_advance(self.buffers, self.n_valid, dict(ins or {}),
                                 del_idx, n_ins, n_del, cap)
        return ResidentRelation(self.name, bufs, n_new)


@dataclasses.dataclass(frozen=True)
class ShardedResidentRelation:
    """This rank's shard of a resident relation partitioned row-wise over
    one mesh axis (``ax``, a :class:`~repro_torch.core.distributed.AxisInfo`):
    ``capacity``-row (power-of-two, the same on every rank) column buffers
    with the shard's *own* valid prefix.  Compaction and append stay local
    to a shard: there is no global row order on the device.

    The oracle's row order survives through ``gids``: an int64 buffer
    holding, per live row, its position in the equivalent single-device
    :class:`Relation` (deletes renumber survivors on the device, appends
    take fresh trailing positions round-robin across shards).  Positional
    delete batches route to their owning shard by matching ``gids``, so a
    steady tick needs no host-side placement map.

    Counts: ``n_valid`` is the *exact* total live rows (host arithmetic,
    the same on every rank); ``n_valid_dev`` is this shard's live rows, a
    0-d device tensor, since a delete's shard is data-dependent;
    ``n_valid_ub`` holds every shard's host **upper bound** (inserts are
    counted, local deletes are not).  Scans read the prefix ``[0,
    n_scan)`` — this shard's bound — against the device count; every slot
    below the capacity holds values a scan may read (codes in their
    domains, finite floats), live or not.  Growth checks run against the
    bounds and call :meth:`synced` (one ``all_reduce`` of the per-shard
    counts, copied to the host: a documented sync of metadata, never of
    columns) only when a bound would overflow."""

    name: str
    buffers: Dict[str, torch.Tensor]    # (capacity,) each: this shard
    gids: torch.Tensor                  # (capacity,) int64
    n_valid: int                        # exact total live rows (host)
    n_valid_ub: np.ndarray              # (ndev,) per-shard bounds (host)
    n_valid_dev: torch.Tensor           # 0-d int64: this shard's live rows
    ax: object                          # core.distributed.AxisInfo

    @property
    def n_devices(self) -> int:
        return self.ax.size

    @property
    def shard(self) -> int:
        return self.ax.index

    @property
    def capacity(self) -> int:
        """Per-shard capacity (the same on every rank)."""
        return int(self.gids.shape[0])

    @property
    def n_scan(self) -> int:
        """Rows a scan of this shard reads: its host upper bound."""
        return int(self.n_valid_ub[self.shard])

    @property
    def scan_valid(self) -> torch.Tensor:
        """The valid rows a scan counts: this shard's device count."""
        return self.n_valid_dev

    @classmethod
    def from_relation(cls, rel: Relation, ax,
                      min_capacity: int = 1) -> "ShardedResidentRelation":
        """Round-robin split: shard ``s`` takes global rows ``s, s + ndev,
        …`` with gids equal to those row indices (any split works: gids
        carry the order)."""
        ndev, s = ax.size, ax.index
        n = rel.n_rows
        counts = np.asarray([len(range(r, n, ndev)) for r in range(ndev)],
                            np.int64)
        cap = next_pow2(max(int(counts.max()), min_capacity, 1))
        k = int(counts[s])

        def lay(col):
            col = col[s::ndev]
            return torch.cat([col, col.new_zeros(cap - k)]) if cap > k \
                else col.contiguous()

        device = next(iter(rel.columns.values())).device
        gids = torch.arange(s, s + ndev * k, ndev, dtype=torch.int64,
                            device=device)
        return cls(rel.name, {a: lay(c) for a, c in rel.columns.items()},
                   torch.cat([gids, gids.new_zeros(cap - k)]), n, counts,
                   torch.tensor(k, dtype=torch.int64, device=device), ax)

    def columns(self) -> Dict[str, torch.Tensor]:
        """The scanned prefix ``[0, n_scan)`` of every column (views of the
        buffers); rows past :attr:`scan_valid` are dead."""
        n = self.n_scan
        return {a: c[:n] for a, c in self.buffers.items()}

    def to_relation(self) -> Relation:
        """The whole relation in the oracle's row order, on every rank: each
        rank scatters its live rows by gid into a zeroed global buffer and
        the buffers are summed over the axis — exact, since every position
        has one nonzero contribution, and an ``all_reduce``, which gloo
        offers on CUDA tensors too.  A collective: every rank calls it."""
        n, k = self.n_valid, self.n_scan
        device = self.gids.device
        live = torch.arange(k, device=device) < self.n_valid_dev
        idx = torch.where(live, self.gids[:k], torch.full_like(
            self.gids[:k], n))
        cols = {}
        for a, c in self.buffers.items():
            out = c.new_zeros(n + 1)
            out.index_put_((idx,), torch.where(live, c[:k], c.new_zeros(())),
                           accumulate=True)
            out = out[:n].contiguous()
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.ax.group)
            cols[a] = out
        return Relation(self.name, cols)

    def synced(self) -> "ShardedResidentRelation":
        """Bounds refreshed to the exact per-shard counts: one
        ``all_reduce`` of a (ndev,) vector, copied to the host — the
        documented sync of the growth check."""
        vec = torch.zeros(self.n_devices, dtype=torch.int64,
                          device=self.gids.device)
        vec[self.shard] = self.n_valid_dev
        dist.all_reduce(vec, op=dist.ReduceOp.SUM, group=self.ax.group)
        return dataclasses.replace(self, n_valid_ub=vec.cpu().numpy())

    def grown(self, min_rows_per_shard: int) -> "ShardedResidentRelation":
        """Capacity >= ``min_rows_per_shard`` (power-of-two doubling, every
        shard together, so buffers stay uniform); the new rows are zeros."""
        cap = next_pow2(max(min_rows_per_shard, 1))
        old = self.capacity
        if cap <= old:
            return self

        def pad(buf):
            return torch.cat([buf, buf.new_zeros(cap - old)])

        return dataclasses.replace(
            self, buffers={a: pad(c) for a, c in self.buffers.items()},
            gids=pad(self.gids))


# --------------------------------------------------------------------- deltas

@dataclasses.dataclass
class RelationDelta:
    """One relation's update batch: ``inserts`` are new rows (full column
    dict), ``delete_idx`` are positional row indices into the relation *as it
    was when the update was created*.  Either may be empty/None."""

    inserts: Optional[Mapping[str, np.ndarray]] = None
    delete_idx: Optional[np.ndarray] = None

    @property
    def n_inserts(self) -> int:
        if not self.inserts:
            return 0
        return int(np.asarray(next(iter(self.inserts.values()))).shape[0])

    @property
    def n_deletes(self) -> int:
        return 0 if self.delete_idx is None else int(np.asarray(self.delete_idx).shape[0])

    @property
    def n_rows(self) -> int:
        return self.n_inserts + self.n_deletes


@dataclasses.dataclass
class DeltaBatchUpdate:
    """A multi-relation update batch (the maintenance unit of work):
    relation name → :class:`RelationDelta`.  Relations are applied in sorted
    name order; the post-update database equals applying every
    per-relation delta sequentially, which is also how ``core/ivm.py``
    maintains view state."""

    updates: Dict[str, RelationDelta] = dataclasses.field(default_factory=dict)

    def insert(self, rel: str, columns: Mapping[str, np.ndarray]) -> "DeltaBatchUpdate":
        d = self.updates.setdefault(rel, RelationDelta())
        if d.inserts is not None:
            raise ValueError(f"update already has inserts for {rel!r}")
        d.inserts = columns
        return self

    def delete(self, rel: str, idx: np.ndarray) -> "DeltaBatchUpdate":
        d = self.updates.setdefault(rel, RelationDelta())
        if d.delete_idx is not None:
            raise ValueError(f"update already has deletes for {rel!r}")
        d.delete_idx = np.asarray(idx)
        return self

    def relations(self):
        """Updated relation names in application order (sorted, non-empty)."""
        return [r for r in sorted(self.updates) if self.updates[r].n_rows > 0]

    def validate(self, db: "Database") -> None:
        for name, d in self.updates.items():
            if name not in db.relations:
                raise ValueError(f"update targets unknown relation {name!r}")
            if d.inserts is not None:
                check_update_columns(db.schema, name, d.inserts)
            if d.delete_idx is not None:
                check_delete_idx(name, d.delete_idx, db.relation(name).n_rows)


def apply_delta(db: Database, update: DeltaBatchUpdate) -> Database:
    """Apply an update batch to a plain database (deletes first, then
    inserts, per relation in sorted order) — the from-scratch semantics the
    maintained path in ``core/ivm.py`` must agree with."""
    update.validate(db)
    rels = dict(db.relations)
    for name in update.relations():
        d = update.updates[name]
        r = rels[name]
        if d.n_deletes:
            r = r.delete_rows(np.asarray(d.delete_idx))
        if d.n_inserts:
            r = r.append(d.inserts, db.schema)
        rels[name] = r
    return Database(db.schema, rels)

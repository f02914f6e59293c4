"""Columnar relation storage on a torch device; the batch subset of
``repro/data/relations.py`` (``Relation``, ``Database``, ``from_numpy``).

Relations are dictionaries of same-length 1-D tensors: int32 codes for
key/categorical attributes, float32 for continuous ones, all on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core import schema as sch


@dataclasses.dataclass
class Relation:
    name: str
    columns: Dict[str, torch.Tensor]

    @property
    def n_rows(self) -> int:
        return int(next(iter(self.columns.values())).shape[0])

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
                if col.dtype.is_floating_point or col.dtype == torch.bool:
                    raise ValueError(f"{self.name}.{a}: discrete column must be integer, got {col.dtype}")
            elif not col.dtype.is_floating_point:
                raise ValueError(f"{self.name}.{a}: continuous column must be float, got {col.dtype}")


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

"""Hands the benchmark's tables to the program under test: the port
(``repro_torch``), never the JAX package.  The tables stay the
benchmark's: the session's relations hold the same device tensors, which
the program only reads."""

from __future__ import annotations

import repro_torch
from repro_torch.core.schema import schema
from repro_torch.data import relations as rel_mod
from repro_torch.data.datasets import Dataset


def connect(tables, config: dict):
    """The port's session over ``tables``, and the ``Dataset`` its ML
    entry points take (schema, join tree and features; no host tables)."""
    dbs = schema(tables.attrs, tables.relations)
    data = rel_mod.Database(dbs, {name: rel_mod.Relation(name, dict(cols))
                                  for name, cols in tables.columns.items()})
    data.validate()
    db = repro_torch.connect(data, config=repro_torch.ExecutionConfig(
        block_size=config["block_size"]), edges=tables.edges)
    ds = Dataset(tables.name, dbs, {}, list(tables.edges),
                 features_cont=list(tables.features_cont),
                 features_cat=list(tables.features_cat),
                 label=tables.label, fact=tables.fact)
    return db, ds


def launches():
    """The port's kernel launch counters, a copy."""
    from repro_torch.kernels import ops

    return dict(ops.LAUNCHES)


def tracing(on: bool) -> None:
    from repro_torch.obs import trace

    trace.clear()
    trace.enable(on)


def spans():
    from repro_torch.obs import trace

    return trace.get_tracer().events()

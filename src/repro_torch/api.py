"""Session API of the port: one ``Database`` facade over the batch engine;
counterpart of ``repro/api.py`` (batch subset).

    import repro_torch
    db = repro_torch.connect(dataset)              # relations on the card
    out = db.views(queries).run()                  # {name: dense tensor}
    outs = db.views(queries).run_batched(params)   # N param settings at once

Entry points run on the card unless the caller asks for the CPU
(``connect(..., device="cpu")``): without a CUDA device and without that
request, ``connect`` raises instead of running somewhere else.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.aggregates import Params, Query
from repro_torch.core.engine import BatchStats, CompiledBatch, Engine
from repro_torch.core.lowering import BACKENDS
from repro_torch.core.plan import validate_block_size
from repro_torch.core.schema import DatabaseSchema
from repro_torch.data import relations as rel_mod
from repro_torch.data.datasets import Dataset
from repro_torch.device import resolve_device

__all__ = ["ExecutionConfig", "Database", "ViewHandle", "connect"]


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """One frozen execution policy for a whole session.

    ``backend`` selects the lowering path ("cuda": the hand-written
    kernels); ``fuse_kernels`` collapses each step's reductions into ONE
    fused launch per row block (off: one launch per reduction, the
    comparison baseline); ``block_size`` is the rows per launch;
    ``multi_root`` enables the paper's find-roots layer (off: every query
    of a batch is rooted at one relation, the paper's ablation)."""

    backend: str = "cuda"
    block_size: int = 1 << 20
    fuse_kernels: bool = True
    multi_root: bool = True

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r} "
                             f"(expected one of {BACKENDS})")
        validate_block_size(self.block_size)

    def replace(self, **overrides) -> "ExecutionConfig":
        """A copy with the given fields changed."""
        return dataclasses.replace(self, **overrides)

    def compile_kwargs(self) -> Dict[str, object]:
        """The compile-stage subset, as `Engine._compile` keywords."""
        return dict(block_size=self.block_size, backend=self.backend,
                    fuse_kernels=self.fuse_kernels,
                    multi_root=self.multi_root)


class ViewHandle:
    """A registered batch of named views (create via :meth:`Database.views`)."""

    def __init__(self, database: "Database", compiled: CompiledBatch):
        self._database = database
        self.compiled = compiled        #: the underlying CompiledBatch

    @property
    def stats(self) -> BatchStats:
        """Compile-time layer statistics (paper Table 2 analogue)."""
        return self.compiled.stats

    def run(self, params: Optional[Params] = None) -> Dict[str, torch.Tensor]:
        """Evaluate the views over the session's relations and return
        ``{name: dense tensor}`` on the session's device.  Launches are
        asynchronous: reading a result synchronises."""
        return self.compiled(self._database.data, params)

    def run_batched(self, params: Params,
                    n_nodes: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Evaluate ``N`` settings of the batch's ``Param(batched=True)``
        params in one pass (``CompiledBatch.run_batched``): each batched
        param carries a leading axis of size ``N``, and batched outputs come
        back as ``(N, *group_dims, n_aggs)``.  Numpy params move to the
        session's device once per call."""
        return self.compiled.run_batched(self._database.data, params,
                                         n_nodes=n_nodes)


class Database:
    """The session facade: schema + join tree + resident relations + one
    frozen :class:`ExecutionConfig`.  Create via :func:`connect`."""

    def __init__(self, schema: DatabaseSchema, data: rel_mod.Database,
                 edges: Optional[Sequence[Tuple[str, str]]] = None,
                 config: Optional[ExecutionConfig] = None):
        self.schema = schema
        self.data = data                      #: resident relations
        self.config = config or ExecutionConfig()
        self._engine = Engine(schema, edges=edges, sizes=data.sizes())

    def sizes(self) -> Dict[str, int]:
        return self.data.sizes()

    def views(self, queries: Sequence[Query]) -> ViewHandle:
        """Compile a query batch into one :class:`ViewHandle`."""
        return ViewHandle(self, self._engine._compile(
            queries, **self.config.compile_kwargs()))


def connect(source, config: Optional[ExecutionConfig] = None, *,
            device="cuda",
            tables: Optional[Mapping[str, Mapping[str, object]]] = None,
            data: Optional[rel_mod.Database] = None,
            edges: Optional[Sequence[Tuple[str, str]]] = None) -> Database:
    """Open a session: ``repro_torch.connect(dataset_or_schema, config=...)``.

    ``source`` may be a :class:`~repro_torch.data.datasets.Dataset` (schema,
    join edges and tables come from it; the tables move to ``device``), a
    relations :class:`~repro_torch.data.relations.Database` (already on its
    device), or a bare
    :class:`~repro_torch.core.schema.DatabaseSchema` plus either ``data=``
    or ``tables=`` (numpy column dicts, moved to ``device``)."""
    if isinstance(source, Dataset):
        return Database(source.schema,
                        rel_mod.from_numpy(source.schema, source.tables,
                                           resolve_device(device)),
                        edges=edges if edges is not None else source.edges,
                        config=config)
    if isinstance(source, rel_mod.Database):
        return Database(source.schema, source, edges=edges, config=config)
    if isinstance(source, DatabaseSchema):
        if data is None:
            if tables is None:
                raise ValueError("connect(schema, ...) needs data= (a "
                                 "relations Database) or tables= (numpy "
                                 "column dicts)")
            data = rel_mod.from_numpy(source, tables, resolve_device(device))
        return Database(source, data, edges=edges, config=config)
    raise TypeError(f"cannot connect to {type(source).__name__}: expected a "
                    "Dataset, a relations Database, or a DatabaseSchema")

"""Session API of the port: one ``Database`` facade over the engine;
counterpart of ``repro/api.py`` (no mesh, serving, routing, workload
recording or ``explain``).

    import repro_torch
    db = repro_torch.connect(dataset)              # relations on the card
    out = db.views(queries).run()                  # {name: dense tensor}
    outs = db.views(queries).run_batched(params)   # N param settings at once

    m = db.views(queries, maintain=True)           # incremental views
    m.run()                                        # full scan -> epoch 0
    m.apply(update)                                # work ∝ |update|
    m.snapshot(ckpt_dir)                           # crash-safe epoch checkpoint

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
    """A registered batch of named views (create via :meth:`Database.views`).

    Batch views: ``run(params=)`` scans the session's relations on every
    call; ``run_batched(params)`` evaluates N param settings in one pass.
    Maintained views (``maintain=True``): ``run()`` materializes epoch 0 by
    a full scan (later calls read the current epoch), ``apply(update)``
    folds a delta batch and publishes the next epoch, and
    ``snapshot()``/``restore()`` checkpoint one epoch."""

    def __init__(self, database: "Database", compiled: CompiledBatch,
                 maintained=None):
        self._database = database
        self.compiled = compiled        #: the underlying CompiledBatch
        self._maintained = maintained

    @property
    def stats(self) -> BatchStats:
        """Compile-time layer statistics (paper Table 2 analogue)."""
        return self.compiled.stats

    @property
    def is_maintained(self) -> bool:
        return self._maintained is not None

    @property
    def maintained(self):
        """The underlying :class:`~repro_torch.core.ivm.MaintainedBatch`."""
        if self._maintained is None:
            raise ValueError(
                "views were compiled without maintenance; register them with "
                "db.views(queries, maintain=True) to get apply()")
        return self._maintained

    def run(self, params: Optional[Params] = None) -> Dict[str, torch.Tensor]:
        """Evaluate the views and return ``{name: dense tensor}`` on the
        session's device.  Launches are asynchronous: reading a result
        synchronises.

        Batch views scan the session's relations.  Maintained views: the
        first call runs the full scan and publishes epoch 0; later calls
        read the current epoch (no rescans — :meth:`apply` advances it)."""
        mb = self._maintained
        if mb is None:
            return self.compiled(self._database.data, params)
        if not mb.initialized:
            return mb.init(self._database.data, params=params)
        if params:
            raise ValueError(
                "maintained views bind params at the initial full scan; "
                "re-init via handle.maintained.init(db, params=...) to "
                "change them (a later run() only reads the epoch)")
        return mb.results()

    def run_batched(self, params: Params,
                    n_nodes: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Evaluate ``N`` settings of the batch's ``Param(batched=True)``
        params in one pass (``CompiledBatch.run_batched``): each batched
        param carries a leading axis of size ``N``, and batched outputs come
        back as ``(N, *group_dims, n_aggs)``.  Numpy params move to the
        session's device once per call."""
        if self._maintained is not None:
            raise ValueError("maintained views do not support the "
                             "param-batch axis; register a batch view")
        return self.compiled.run_batched(self._database.data, params,
                                         n_nodes=n_nodes)

    # -- incremental maintenance ---------------------------------------------

    def apply(self, update, params: Optional[Params] = None):
        """Fold a :class:`~repro_torch.data.relations.DeltaBatchUpdate` into
        the maintained state and publish the next epoch; returns the
        refreshed results on the session's device.  Initializes (full
        scan) first if :meth:`run` has not."""
        mb = self.maintained
        if not mb.initialized:
            mb.init(self._database.data)
        return mb.apply(update, params=params)

    def results(self, epoch: Optional[int] = None):
        """Maintained-view outputs read from one epoch's frozen state."""
        return self.maintained.results(epoch=epoch)

    def snapshot(self, ckpt_dir: str, keep: int = 3,
                 epoch: Optional[int] = None) -> str:
        """Crash-safe checkpoint of one epoch of maintained state."""
        return self.maintained.save(ckpt_dir, keep=keep, epoch=epoch)

    def restore(self, ckpt_dir: str, step: Optional[int] = None) -> int:
        """Restore maintained state from a checkpoint (works before any
        ``run()`` — the state skeleton comes from the compiled plan)."""
        return self.maintained.restore(ckpt_dir, step=step)


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

    def views(self, queries: Sequence[Query], maintain: bool = False, *,
              roots: Optional[Dict[str, str]] = None,
              warm_rels: Sequence[str] = ()) -> ViewHandle:
        """Compile a query batch into one :class:`ViewHandle`.

        ``maintain=False``: a batch view — ``run()``/``run_batched()`` scan
        the session's relations on every call.  ``maintain=True``: an
        incrementally maintained view — ``run()`` materializes epoch 0 and
        ``apply(update)`` folds delta batches with work ∝ |update|;
        ``warm_rels`` builds those relations' delta programs now.
        ``roots`` overrides the find-roots layer per query (e.g. rooting
        every covar view at the fact table so that fact-only updates scan
        only the delta tuples)."""
        kw = self.config.compile_kwargs()
        if maintain:
            mb = self._engine._compile_maintained(
                queries, root_override=roots, warm_rels=warm_rels,
                device=self.data.device, **kw)
            return ViewHandle(self, mb.batch, maintained=mb)
        return ViewHandle(self, self._engine._compile(
            queries, root_override=roots, **kw))

    def view(self, q: Query, maintain: bool = False, **kw) -> ViewHandle:
        """Single-query convenience wrapper around :meth:`views`."""
        return self.views([q], maintain=maintain, **kw)


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

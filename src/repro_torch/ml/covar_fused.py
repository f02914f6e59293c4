"""Gathered-XᵀX covar path: factorized gather + blocked ``C += Eᵀ·diag(w)·E``;
counterpart of ``repro/ml/covar_fused.py``.

For FK-join (star/snowflake) schemas every fact row matches exactly one row
per dimension, so the joined row count equals the fact row count and each
joined feature vector is a *gather*, never an expansion.  The whole covar
batch (hundreds of engine queries) then collapses into one blocked product
over the gathered one-hot-extended feature matrix ``E``, which the
``covar_xtx`` kernel computes on the card (its plain version on the CPU).

The join is still never materialized as a table: per block of fact rows,
the features are gathered into one preallocated ``(block, p)`` buffer.
Many-to-many schemas (Yelp's Category/Attribute) violate the one-match
precondition — :func:`supports_fused` detects this and callers fall back to
the general engine path (``ml/covar.py``).

What differs from the reference, on purpose:

* there is no ``use_pallas`` switch and no einsum route: every block goes
  through ``kernels.ops.covar_xtx``, the kernel on a card session and its
  plain version on a CPU one;
* ``database=`` reuses an open session's resident relations;
* the last block is simply shorter: no padding rows, and ``w`` is the
  validity of the block's rows (all ones);
* ``block_size`` defaults to 2²⁰ rows, not 8192: the reference's
  ``lax.scan`` makes small blocks cheap, while eager PyTorch pays host time
  for every block;
* a many-to-many schema raises ``ValueError`` instead of failing an
  ``assert``.

The across-block accumulator is float32, as in the reference.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.api import Database, connect
from repro_torch.core.jointree import JoinTree
from repro_torch.data.datasets import Dataset
from repro_torch.kernels import ops
from repro_torch.ml.covar import CovarLayout, covar_queries


def _dim_keys(ds: Dataset, tree: JoinTree, rel: str):
    """Parent relation, sorted join-key attrs and their flattened key per
    row of ``rel`` (host numpy)."""
    parent = tree.parent(rel, ds.fact)
    keys = sorted(tree.join_attrs(rel, parent))
    doms = [ds.schema.domain(k) for k in keys]
    cols = [np.asarray(ds.tables[rel][k]) for k in keys]
    flat = cols[0].astype(np.int64)
    for c, d in zip(cols[1:], doms[1:]):
        flat = flat * d + c
    return parent, keys, doms, flat


def supports_fused(ds: Dataset) -> bool:
    """True when every non-fact relation is keyed uniquely by its join key(s)
    reachable FK-style from the fact table (each fact row joins exactly one
    row per dimension)."""
    tree = JoinTree(ds.schema, ds.edges)
    for rel in tree.nodes:
        if rel == ds.fact:
            continue
        flat = _dim_keys(ds, tree, rel)[3]
        if len(np.unique(flat)) != len(flat):
            return False
    return True


def _dim_maps(ds: Dataset, device="cpu") -> Dict[str, Dict]:
    """Per non-fact relation: key attrs, their domains, the parent relation
    and a dense key → row lookup table on ``device``."""
    tree = JoinTree(ds.schema, ds.edges)
    maps = {}
    for rel in tree.nodes:
        if rel == ds.fact:
            continue
        parent, keys, doms, flat = _dim_keys(ds, tree, rel)
        lut = np.zeros(int(np.prod(doms)), dtype=np.int64)
        lut[flat] = np.arange(len(flat))
        maps[rel] = {"keys": keys, "doms": doms, "parent": parent,
                     "lut": torch.from_numpy(lut).to(device)}
    return maps


def make_fused_covar(ds: Dataset, layout: Optional[CovarLayout] = None,
                     block_size: int = 1 << 20,
                     database: Optional[Database] = None,
                     device="cuda") -> Tuple[Callable[[], torch.Tensor], CovarLayout]:
    """Build a reusable callable computing the (p, p) covar by blocked
    gathered XᵀX.  Returns ``(fn, layout)``; ``fn()`` gives the float32
    covar on the session's device.  Pass ``database`` to reuse an open
    session's relations (its device wins), or ``device`` to upload
    ``ds.tables`` there."""
    if layout is None:
        _, layout = covar_queries(ds)
    if not supports_fused(ds):
        raise ValueError(f"{ds.name}: a many-to-many join (some dimension "
                         "is not keyed uniquely by its join keys); use the "
                         "engine path, ml/covar.compute_covar")
    if block_size < 1:
        raise ValueError(f"block_size must be positive, got {block_size}")
    db = database or connect(ds, device=device)
    rel_cols = {r: db.data.relation(r).columns for r in db.data.relations}
    fact_cols = rel_cols[ds.fact]
    dev = next(iter(fact_cols.values())).device
    maps = _dim_maps(ds, dev)
    rel_of = {a: min(ds.schema.relations_with(a),
                     key=lambda r: 0 if r == ds.fact else 1)
              for a in list(layout.cont) + list(layout.cat) + [layout.label]}
    n = db.data.relation(ds.fact).n_rows
    p = layout.p
    rows = max(1, min(block_size, n))
    E = torch.empty((rows, p), dtype=torch.float32, device=dev)
    valid = torch.ones(rows, dtype=torch.float32, device=dev)
    oh_lo = 1 + len(layout.cont)

    def row_index(rel, s, e, cache):
        # chain of gathers fact -> dim (snowflake: dim of dim via parent rows)
        if rel not in cache:
            m = maps[rel]
            if m["parent"] == ds.fact:
                key = {k: fact_cols[k][s:e] for k in m["keys"]}
            else:
                pidx = row_index(m["parent"], s, e, cache)
                key = {k: rel_cols[m["parent"]][k][pidx] for k in m["keys"]}
            flat = key[m["keys"][0]].long()
            for k, d in zip(m["keys"][1:], m["doms"][1:]):
                flat = flat * d + key[k]
            cache[rel] = m["lut"][flat]
        return cache[rel]

    def run() -> torch.Tensor:
        acc = torch.zeros((p, p), dtype=torch.float32, device=dev)
        for s in range(0, n, block_size):
            e = min(n, s + block_size)
            cache: Dict[str, torch.Tensor] = {}

            def col(a):
                r = rel_of[a]
                if r == ds.fact:
                    return fact_cols[a][s:e]
                return rel_cols[r][a][row_index(r, s, e, cache)]

            Eb = E[:e - s]
            Eb[:, 0] = 1.0                                   # intercept
            for k, a in enumerate(layout.cont):
                Eb[:, 1 + k] = col(a)
            Eb[:, oh_lo:p - 1] = 0.0
            for a in layout.cat:
                Eb.scatter_(1, (layout.cat_offsets[a] + col(a).long())[:, None], 1.0)
            Eb[:, p - 1] = col(layout.label)
            acc += ops.covar_xtx(Eb, valid[:e - s])
        return acc

    return run, layout


def compute_covar_fused(ds: Dataset, layout: Optional[CovarLayout] = None,
                        block_size: int = 1 << 20,
                        database: Optional[Database] = None,
                        device="cuda") -> Tuple[np.ndarray, float, CovarLayout]:
    """One-shot wrapper around :func:`make_fused_covar`: ``(C float64 numpy,
    N, layout)``."""
    fn, layout = make_fused_covar(ds, layout, block_size, database, device)
    n = len(next(iter(ds.tables[ds.fact].values())))
    return fn().cpu().numpy().astype(np.float64), float(n), layout

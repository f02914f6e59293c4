"""Dataset statistics computed by the engine; counterpart of
``repro/data/statistics.py``.

Training pipelines routinely need sufficient statistics over metadata-joined
corpora: feature moments for normalization, per-key load counts.  These are
aggregate batches over the join, run here as one engine batch each.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.api import Database, ExecutionConfig, connect
from repro_torch.core.aggregates import COUNT, query, sum_of, sum_sq
from repro_torch.core.schema import schema as mk_schema
from repro_torch.data.datasets import Dataset


def feature_moments(ds: Dataset, attrs: Optional[Sequence[str]] = None,
                    block_size: int = 1 << 20,
                    database: Optional[Database] = None,
                    device="cuda") -> Dict[str, Dict[str, float]]:
    """Mean/var of continuous features over the (non-materialized) join —
    the normalization statistics a data pipeline applies before training.
    Pass ``database`` to reuse an open session."""
    attrs = list(attrs if attrs is not None else ds.features_cont)
    qs = [query("n", [], [COUNT])]
    for a in attrs:
        qs.append(query(f"m_{a}", [], [sum_of(a), sum_sq(a)]))
    sess = database or connect(
        ds, config=ExecutionConfig(block_size=block_size), device=device)
    out = {k: v.cpu().numpy().astype(np.float64)
           for k, v in sess.views(qs).run().items()}
    n = float(out["n"][0])
    stats = {}
    for a in attrs:
        s, s2 = out[f"m_{a}"]
        mean = s / n
        stats[a] = {"count": n, "mean": mean, "var": max(s2 / n - mean * mean, 0.0)}
    return stats


def expert_load_aggregate(expert_ids: np.ndarray, n_experts: int,
                          device="cuda") -> np.ndarray:
    """MoE router load counters as a group-by-expert COUNT through the
    engine (a one-relation join)."""
    S = mk_schema([("expert", "categorical", n_experts)], [("Route", ["expert"])])
    out = connect(S, tables={"Route": {"expert": expert_ids.astype(np.int32)}},
                  device=device).views([query("load", ["expert"], [COUNT])]).run()
    return out["load"].cpu().numpy()[:, 0]

"""The one generator of the mixes' inputs: what a traffic file asks for,
made on the device from the seed.  The batch jobs (a covar batch, a tree
fit) take no input beyond the tables; a stream of fact updates is a pool
of deltas, drawn once in set-up and cycled through in the window.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from cardbench.data._tables import generator

#: the deltas' random stream, apart from the tables' stream of one seed
DELTA_STREAM = 0x5EED_DE17A


def fact_deltas(traffic: dict, tables, seed: int) -> List[Dict[str, torch.Tensor]]:
    """``traffic["pool"]`` deltas of the fact, each inserting
    ``insert_share`` of its rows (positions ``pick`` of the initial fact,
    drawn with replacement) and deleting ``delete_share`` of them
    (``dels``: distinct positions below the live row count).  Inserting at
    least as many rows as a delta deletes keeps every position valid
    however the pool is cycled."""
    fact = tables.columns[tables.fact]
    device = next(iter(fact.values())).device
    n = tables.n_rows(tables.fact)
    k_ins = max(int(n * traffic["insert_share"]), 1)
    k_del = max(int(n * traffic["delete_share"]), 1)
    if k_ins < k_del:
        raise ValueError("a delta must insert at least as many rows as it deletes")
    g = generator(int(seed) ^ DELTA_STREAM, device)
    out = []
    for _ in range(traffic["pool"]):
        pick = torch.randint(0, n, (k_ins,), generator=g, device=device)
        dels = torch.randperm(n, generator=g, device=device)[:k_del]
        out.append({"pick": pick, "dels": dels})
    return out

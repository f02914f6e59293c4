"""repro_torch — the layered aggregate engine (LMFAO) in PyTorch with
hand-written CUDA kernels for Hopper.

A port of the JAX package ``repro``, which stays the reference; this
package imports nothing of it.

    import repro_torch
    db = repro_torch.connect(dataset, config=repro_torch.ExecutionConfig())
    out = db.views(queries).run()

The session facade loads lazily, so ``import repro_torch`` stays cheap.
"""

from repro_torch.core.aggregates import (COUNT, agg, query, sum_of,
                                         sum_prod)

_API = ("connect", "Database", "ExecutionConfig", "ViewHandle", "ViewReport")

__all__ = list(_API) + ["COUNT", "agg", "query", "sum_of", "sum_prod"]


def __getattr__(name):
    if name in _API:
        from repro_torch import api
        return getattr(api, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")

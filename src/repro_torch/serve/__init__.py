"""Serving layer; counterpart of ``repro/serve``.

``engine.py`` — the LM decode loop (batched greedy decoding).  The
aggregate engine's serving front end (``views.py``), the query router and
its planner are not ported yet (ROADMAP Queue 1).
"""

from repro_torch.serve.engine import BatchedServer, greedy, make_serve_step

__all__ = ["BatchedServer", "greedy", "make_serve_step"]

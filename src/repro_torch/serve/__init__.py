"""Serving layer; counterpart of ``repro/serve``.

``views.py`` — the aggregate engine's serving front end: epoch-pinned,
snapshot-consistent reads over incrementally maintained views
(:class:`~repro_torch.serve.views.ViewServer`).

``router.py`` / ``planner.py`` — ad-hoc query serving: a signature router
answering *arbitrary* group-by aggregates from the session's views (exact
match / subsumption re-aggregation / verified compile-and-cache), driven
by an adaptive planner over the signature lattice.  Reached through
``Database.query`` / ``ViewServer.query``.

``engine.py`` — the LM decode loop (batched greedy decoding).
"""

from repro_torch.core.ivm import EpochEvictedError
from repro_torch.serve.engine import BatchedServer, greedy, make_serve_step
from repro_torch.serve.planner import AdaptivePlanner, Candidate, RoutePlan
from repro_torch.serve.router import QueryRouter, RouteResult
from repro_torch.serve.views import EpochView, ViewServer

__all__ = ["AdaptivePlanner", "BatchedServer", "Candidate",
           "EpochEvictedError", "EpochView", "QueryRouter", "RoutePlan",
           "RouteResult", "ViewServer", "greedy", "make_serve_step"]

"""Copy of ``repro/core/pushdown.py`` for the PyTorch port: identical apart
from imports, so that the port compiles the same plans without importing
the JAX package.

Aggregate Pushdown + Merge Views layers (paper Fig. 1 layers 3–4).

Each (query, root) pair is decomposed into one *directional view* per join-tree
edge, flowing from the leaves toward the query's root (paper §3.2): the view at
edge c→p computes the query's aggregate restricted to the subtree rooted at c,
grouped by the edge's join attributes plus any attributes that must be *pulled
up* (needed above c: query group-bys living in the subtree, or attributes of
terms evaluated above c).

Merging is integrated into construction: views live in **merged containers**
keyed by ``(edge, group_by)``; structurally identical aggregate columns are
deduplicated (paper merge type 3), distinct aggregates over the same key join
their column lists (type 2), and same-key views with different bodies share one
dense container (type 1 — sound because dense code-domain arrays make the
"join on group-by attributes" an axis-aligned concatenation; DESIGN.md §2).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from repro_torch.core.aggregates import Aggregate, Constant, ProductAgg, Query, Term
from repro_torch.core.jointree import JoinTree


@dataclasses.dataclass(frozen=True)
class ColRef:
    """Reference to aggregate column ``col`` of view ``vid``."""

    vid: int
    col: int


@dataclasses.dataclass(frozen=True)
class ProductSpec:
    """One product contribution at a node: local terms × child-view columns."""

    local_terms: Tuple[Term, ...]
    child_cols: Tuple[ColRef, ...]

    def skey(self) -> Tuple:
        return (tuple(sorted((t.key() for t in self.local_terms), key=repr)),
                tuple(sorted((c.vid, c.col) for c in self.child_cols)))


@dataclasses.dataclass(frozen=True)
class AggColSpec:
    """One output aggregate column: a sum of products."""

    products: Tuple[ProductSpec, ...]

    def skey(self) -> Tuple:
        return tuple(sorted((p.skey() for p in self.products), key=repr))


@dataclasses.dataclass
class ViewDef:
    """A merged directional-view container (or query-output container)."""

    vid: int
    edge: Optional[Tuple[str, str]]  # (child, parent); None for query outputs
    rel: str                         # relation scanned to compute this view
    group_by: Tuple[str, ...]        # canonical: sorted local keys + sorted pulled keys
    local_keys: Tuple[str, ...]      # group_by ∩ ω_rel (segment ids during the scan)
    pulled_keys: Tuple[str, ...]     # group_by \ ω_rel (axes pulled from child views)
    agg_cols: List[AggColSpec] = dataclasses.field(default_factory=list)
    _agg_index: Dict[Tuple, int] = dataclasses.field(default_factory=dict)
    bodies: set = dataclasses.field(default_factory=set)  # distinct bodies merged (stats)

    @property
    def n_aggs(self) -> int:
        return len(self.agg_cols)

    def add_col(self, spec: AggColSpec, body: FrozenSet[str]) -> Tuple[int, bool]:
        """Returns (column index, was_new)."""
        self.bodies.add(body)
        k = spec.skey()
        if k in self._agg_index:
            return self._agg_index[k], False
        idx = len(self.agg_cols)
        self.agg_cols.append(spec)
        self._agg_index[k] = idx
        return idx, True


@dataclasses.dataclass
class QueryOutput:
    """How to read a query's result out of its output container."""

    query: Query
    vid: int
    cols: Tuple[int, ...]           # one per aggregate of the query
    canonical_group_by: Tuple[str, ...]


@dataclasses.dataclass
class PushdownStats:
    n_app_aggregates: int = 0
    n_views_premerge: int = 0       # one per (product × edge) as in the paper's 3,256
    n_intermediate_cols: int = 0    # synthesized aggregate columns across all views
    n_views: int = 0                # merged containers
    n_dedup_hits: int = 0


class PushdownResult:
    def __init__(self, views: Dict[int, ViewDef], outputs: Dict[str, QueryOutput],
                 stats: PushdownStats):
        self.views = views
        self.outputs = outputs
        self.stats = stats


class _Orientation:
    """Per-root orientation of the join tree with LCA support."""

    def __init__(self, tree: JoinTree, root: str):
        self.tree = tree
        self.root = root
        self.parent: Dict[str, Optional[str]] = {root: None}
        self.depth: Dict[str, int] = {root: 0}
        stack = [root]
        while stack:
            n = stack.pop()
            for c in tree.adj[n]:
                if c not in self.depth:
                    self.parent[c] = n
                    self.depth[c] = self.depth[n] + 1
                    stack.append(c)

    def children(self, n: str) -> List[str]:
        return [m for m in self.tree.adj[n] if self.parent.get(m) == n]

    def lca(self, nodes: Sequence[str]) -> str:
        cur = nodes[0]
        for other in nodes[1:]:
            a, b = cur, other
            while self.depth[a] > self.depth[b]:
                a = self.parent[a]
            while self.depth[b] > self.depth[a]:
                b = self.parent[b]
            while a != b:
                a, b = self.parent[a], self.parent[b]
            cur = a
        return cur

    def home(self, attr: str) -> str:
        """Node containing ``attr`` closest to the root (unique: the nodes
        containing an attribute form a connected subtree by RIP)."""
        rels = self.tree.schema.relations_with(attr)
        if not rels:
            raise ValueError(f"attribute {attr!r} not in any relation")
        return min(rels, key=lambda r: self.depth[r])

    def eval_node(self, term: Term) -> str:
        attrs = term.attrs()
        if not attrs:
            return self.root
        return self.lca([self.home(a) for a in attrs])


class PushdownBuilder:
    """Builds the merged directional-view DAG for a query batch."""

    def __init__(self, tree: JoinTree):
        self.tree = tree
        self.schema = tree.schema
        self.views: Dict[int, ViewDef] = {}
        self._by_key: Dict[Tuple, int] = {}   # (edge_or_out_marker, group_by) → vid
        self.outputs: Dict[str, QueryOutput] = {}
        self.stats = PushdownStats()

    # -- containers ---------------------------------------------------------

    def _container(self, edge: Optional[Tuple[str, str]], rel: str,
                   group_by: Tuple[str, ...]) -> ViewDef:
        key = (edge if edge is not None else ("__out__", rel), group_by)
        if key not in self._by_key:
            vid = len(self.views)
            local = tuple(a for a in group_by if a in self.schema.relation(rel).attr_set)
            pulled = tuple(a for a in group_by if a not in self.schema.relation(rel).attr_set)
            vd = ViewDef(vid=vid, edge=edge, rel=rel, group_by=group_by,
                         local_keys=local, pulled_keys=pulled)
            self.views[vid] = vd
            self._by_key[key] = vid
        return self.views[self._by_key[key]]

    # -- public entry ---------------------------------------------------------

    def add_query(self, q: Query, root: str) -> None:
        if q.name in self.outputs:
            raise ValueError(f"duplicate query name {q.name!r}")
        ori = _Orientation(self.tree, root)
        for a in q.group_by:
            if not self.schema.attr(a).is_discrete:
                raise ValueError(f"query {q.name!r}: group-by {a!r} must be discrete")
        out_gb = self._canonical(root, q.group_by)
        container = self._container(None, root, out_gb)
        cols = []
        for agg_i in q.aggregates:
            self.stats.n_app_aggregates += 1
            prods = []
            for prod in agg_i.products:
                prods.append(self._place_product(ori, root, None, prod.terms,
                                                 frozenset(q.group_by)))
            col, new = container.add_col(AggColSpec(tuple(prods)),
                                         frozenset(self.tree.nodes))
            if not new:
                self.stats.n_dedup_hits += 1
            cols.append(col)
        self.outputs[q.name] = QueryOutput(q, container.vid, tuple(cols), out_gb)

    def finish(self) -> PushdownResult:
        self.stats.n_views = len(self.views)
        self.stats.n_intermediate_cols = sum(
            v.n_aggs for v in self.views.values() if v.edge is not None)
        return PushdownResult(self.views, self.outputs, self.stats)

    # -- recursion ------------------------------------------------------------

    def _canonical(self, rel: str, attrs: Sequence[str]) -> Tuple[str, ...]:
        rel_attrs = self.schema.relation(rel).attr_set
        local = sorted(a for a in attrs if a in rel_attrs)
        pulled = sorted(a for a in attrs if a not in rel_attrs)
        return tuple(local + pulled)

    def _place_product(self, ori: _Orientation, node: str, parent: Optional[str],
                       terms: Tuple[Term, ...], needed_out: FrozenSet[str]) -> ProductSpec:
        """Contribution of the subtree at ``node`` to one product: evaluates
        local terms at ``node`` and recurses one directional view per child
        edge.  ``needed_out`` = attrs this node's output must carry (the view's
        group_by for edge views; the query group-by at the root)."""
        node_attrs = self.schema.relation(node).attr_set
        local_terms = tuple(t for t in terms if ori.eval_node(t) == node)
        child_cols: List[ColRef] = []
        for c in ori.children(node):
            sub_nodes = self.tree.subtree_nodes(c, node)
            sub_attrs = self.tree.subtree_attrs(c, node)
            terms_below = tuple(t for t in terms if ori.eval_node(t) in sub_nodes)
            terms_outside = tuple(t for t in terms if ori.eval_node(t) not in sub_nodes)
            need_above = set(needed_out)
            for t in terms_outside:
                need_above |= t.attrs()
            pulled = sorted(a for a in need_above
                            if a in sub_attrs and a not in node_attrs)
            for a in pulled:
                if not self.schema.attr(a).is_discrete:
                    raise ValueError(
                        f"continuous attribute {a!r} would need to be pulled through "
                        f"edge {c}->{node}; only discrete attributes can be view keys "
                        "(paper §3.2: added as group-by attributes)")
            join = sorted(self.tree.join_attrs(c, node))
            gb = tuple(sorted(set(join)) + [a for a in pulled if a not in join])
            self.stats.n_views_premerge += 1
            col = self._build_edge_view(ori, c, node, gb, terms_below)
            child_cols.append(col)
        return ProductSpec(local_terms, tuple(child_cols))

    def _build_edge_view(self, ori: _Orientation, child: str, parent: str,
                         group_by: Tuple[str, ...], terms: Tuple[Term, ...]) -> ColRef:
        container = self._container((child, parent), child, group_by)
        spec = self._place_product(ori, child, parent, terms, frozenset(group_by))
        body = self.tree.subtree_nodes(child, parent)
        col, new = container.add_col(AggColSpec((spec,)), body)
        if not new:
            self.stats.n_dedup_hits += 1
        return ColRef(container.vid, col)


def push_down(tree: JoinTree, queries: Sequence[Query],
              roots: Dict[str, str]) -> PushdownResult:
    b = PushdownBuilder(tree)
    for q in queries:
        b.add_query(q, roots[q.name])
    return b.finish()

"""Copy of ``repro/core/jointree.py`` for the PyTorch port: identical apart
from imports, so that the port compiles the same plans without importing
the JAX package.

Join-tree layer (paper Fig. 1, layer 1).

Builds one join tree used to compute *all* aggregates in a batch.  The tree is
a maximum spanning tree over shared-attribute weights, verified against the
running-intersection property (RIP).  Cyclic schemas must be pre-decomposed by
materializing hypertree bags (``materialize_bag``), after which the residual
schema is acyclic — mirroring the paper's footnote 1.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from repro_torch.core.schema import DatabaseSchema


@dataclasses.dataclass(frozen=True)
class Edge:
    a: str
    b: str

    def other(self, node: str) -> str:
        return self.b if node == self.a else self.a

    def as_tuple(self) -> Tuple[str, str]:
        return (self.a, self.b)


class JoinTree:
    """Undirected tree over relation names; RIP-validated."""

    def __init__(self, schema: DatabaseSchema, edges: Sequence[Tuple[str, str]]):
        self.schema = schema
        self.nodes: List[str] = list(schema.relations)
        self.edges: List[Edge] = [Edge(a, b) for a, b in edges]
        self.adj: Dict[str, List[str]] = {n: [] for n in self.nodes}
        for e in self.edges:
            self.adj[e.a].append(e.b)
            self.adj[e.b].append(e.a)
        self._validate_tree()
        self._validate_rip()
        # caches
        self._subtree_cache: Dict[Tuple[str, str], FrozenSet[str]] = {}

    # -- construction -----------------------------------------------------

    @staticmethod
    def build(schema: DatabaseSchema, sizes: Optional[Dict[str, int]] = None) -> "JoinTree":
        """Maximum spanning tree over |shared attrs| (ties: larger relations
        first, so big fact tables sit centrally)."""
        nodes = list(schema.relations)
        if len(nodes) == 1:
            return JoinTree(schema, [])
        sizes = sizes or {}
        cand = []
        for i, a in enumerate(nodes):
            for b in nodes[i + 1:]:
                w = len(schema.shared_attrs(a, b))
                if w > 0:
                    tie = sizes.get(a, 0) + sizes.get(b, 0)
                    cand.append((w, tie, a, b))
        cand.sort(reverse=True)
        parent: Dict[str, str] = {n: n for n in nodes}

        def find(x: str) -> str:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        edges = []
        for w, _, a, b in cand:
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb
                edges.append((a, b))
        if len(edges) != len(nodes) - 1:
            raise ValueError("schema join graph is disconnected; cannot build a join tree")
        return JoinTree(schema, edges)

    # -- validation -------------------------------------------------------

    def _validate_tree(self) -> None:
        if len(self.edges) != len(self.nodes) - 1:
            raise ValueError(f"{len(self.edges)} edges for {len(self.nodes)} nodes: not a tree")
        seen: Set[str] = set()
        stack = [self.nodes[0]] if self.nodes else []
        while stack:
            n = stack.pop()
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self.adj[n])
        if seen != set(self.nodes):
            raise ValueError("join tree is disconnected")

    def _validate_rip(self) -> None:
        """For every pair of nodes, shared attrs must appear along their path."""
        for i, a in enumerate(self.nodes):
            for b in self.nodes[i + 1:]:
                shared = self.schema.shared_attrs(a, b)
                if not shared:
                    continue
                for mid in self._path(a, b)[1:-1]:
                    if not shared <= self.schema.relation(mid).attr_set:
                        raise ValueError(
                            f"running-intersection violated: {sorted(shared)} shared by "
                            f"{a},{b} missing from {mid}; materialize a bag first")

    def _path(self, a: str, b: str) -> List[str]:
        prev: Dict[str, str] = {a: a}
        stack = [a]
        while stack:
            n = stack.pop()
            if n == b:
                break
            for m in self.adj[n]:
                if m not in prev:
                    prev[m] = n
                    stack.append(m)
        path = [b]
        while path[-1] != a:
            path.append(prev[path[-1]])
        return list(reversed(path))

    # -- orientation / subtree queries -------------------------------------

    def join_attrs(self, a: str, b: str) -> FrozenSet[str]:
        return self.schema.shared_attrs(a, b)

    def subtree_nodes(self, child: str, parent: str) -> FrozenSet[str]:
        """Relations in the subtree rooted at ``child`` when the edge
        (child, parent) is cut — i.e. the scope of a directional view
        child→parent."""
        key = (child, parent)
        if key not in self._subtree_cache:
            seen = {parent, child}
            stack = [child]
            out = {child}
            while stack:
                n = stack.pop()
                for m in self.adj[n]:
                    if m not in seen:
                        seen.add(m)
                        out.add(m)
                        stack.append(m)
            self._subtree_cache[key] = frozenset(out)
        return self._subtree_cache[key]

    def subtree_attrs(self, child: str, parent: str) -> FrozenSet[str]:
        out: FrozenSet[str] = frozenset()
        for n in self.subtree_nodes(child, parent):
            out |= self.schema.relation(n).attr_set
        return out

    def children(self, node: str, root: str) -> List[str]:
        """Neighbors of ``node`` away from ``root`` (node's children when the
        tree is rooted at ``root``)."""
        if node == root:
            return list(self.adj[node])
        path = self._path(node, root)
        toward_root = path[1]
        return [m for m in self.adj[node] if m != toward_root]

    def parent(self, node: str, root: str) -> Optional[str]:
        if node == root:
            return None
        return self._path(node, root)[1]

    def attrs_at_or_below(self, node: str, root: str) -> FrozenSet[str]:
        out = self.schema.relation(node).attr_set
        for c in self.children(node, root):
            out |= self.subtree_attrs(c, node)
        return out


def materialize_bag(schema_in: DatabaseSchema, bag: Sequence[str], bag_name: str):
    """Hypertree-decomposition helper: declare that the relations in ``bag``
    will be joined into a single materialized relation ``bag_name``.

    Returns the new :class:`DatabaseSchema`; the caller materializes the bag's
    data with :func:`repro_torch.core.plan.materialize_join` before execution.
    """
    from repro_torch.core.schema import RelationSchema

    bag_set = set(bag)
    attrs: List[str] = []
    for r in bag:
        for a in schema_in.relation(r).attrs:
            if a not in attrs:
                attrs.append(a)
    new_rels = [r for n, r in schema_in.relations.items() if n not in bag_set]
    new_rels.append(RelationSchema(bag_name, tuple(attrs)))
    return DatabaseSchema(list(schema_in.attributes.values()), new_rels)

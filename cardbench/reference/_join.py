"""The join of a configuration's tables, gathered a block of fact rows at a
time: plain PyTorch, independent of the program.

Every dimension relation holds at most one row for each value of the
attributes it shares with its parent in the join tree (a key–foreign-key
join), which the constructor checks.  Its rows are found through a lookup
table over those attributes' domains, built from its own key columns; a
fact row whose keys find no row drops out of the join.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Tuple

import torch


class GatheredJoin:
    def __init__(self, tables, fact_columns: Dict[str, torch.Tensor] = None,
                 chunk: int = 1 << 22):
        """``tables``: the data maker's :class:`Tables`; ``fact_columns``
        replaces the fact's columns (the fact after a stream of updates)."""
        self.t = tables
        self.chunk = chunk
        self.cols = dict(tables.columns)
        if fact_columns is not None:
            self.cols[tables.fact] = fact_columns
        self.parent: Dict[str, str] = {}
        self.keys: Dict[str, List[str]] = {}
        order, frontier = [tables.fact], [tables.fact]
        while frontier:
            p = frontier.pop(0)
            for a, b in tables.edges:
                for par, ch in ((a, b), (b, a)):
                    if par == p and ch not in order:
                        self.parent[ch] = p
                        shared = set(tables.rel_attrs(p)) & set(tables.rel_attrs(ch))
                        self.keys[ch] = [x for x in tables.rel_attrs(ch) if x in shared]
                        order.append(ch)
                        frontier.append(ch)
        self.order = order                     # parents before children
        self.home = {}
        for r in order:
            for a in tables.rel_attrs(r):
                self.home.setdefault(a, r)
        self.lut = {r: self._lookup(r) for r in order[1:]}
        self.n = int(next(iter(self.cols[tables.fact].values())).shape[0])

    def _flat(self, rel: str, col: Callable[[str], torch.Tensor]) -> torch.Tensor:
        """The shared attributes' values as one index into their domains
        (the last attribute fastest)."""
        idx = None
        for k in self.keys[rel]:
            v = col(k).long()
            idx = v if idx is None else idx * self.t.domain(k) + v
        return idx

    def _lookup(self, rel: str) -> torch.Tensor:
        cols = self.cols[rel]
        n = int(next(iter(cols.values())).shape[0])
        size = 1
        for k in self.keys[rel]:
            size *= self.t.domain(k)
        flat = self._flat(rel, lambda k: cols[k])
        if int(torch.bincount(flat, minlength=size).max()) > 1:
            raise ValueError(f"{rel} holds two rows of one {self.keys[rel]}")
        lut = torch.full((size,), -1, dtype=torch.long, device=flat.device)
        lut[flat] = torch.arange(n, device=flat.device)
        return lut

    def chunks(self) -> Iterator[Tuple[int, Callable[[str], torch.Tensor]]]:
        """``(rows, col)`` per block of fact rows: ``col(attr)`` is the
        attribute's column over the block's joined rows."""
        fact = self.t.fact
        for s in range(0, self.n, self.chunk):
            e = min(self.n, s + self.chunk)
            rows: Dict[str, torch.Tensor] = {}
            for r in self.order[1:]:
                p = self.parent[r]
                own = (lambda k, s=s, e=e: self.cols[fact][k][s:e]) if p == fact \
                    else (lambda k, p=p: self.cols[p][k][rows[p].clamp(min=0)])
                idx = self.lut[r][self._flat(r, own)]
                rows[r] = idx if p == fact else torch.where(rows[p] >= 0, idx, -1)
            fact_rows = None
            if rows:
                live = torch.stack([v >= 0 for v in rows.values()]).all(0)
                if not bool(live.all()):
                    fact_rows = s + live.nonzero().squeeze(1)
                    rows = {r: v[live] for r, v in rows.items()}

            def col(a, s=s, e=e, rows=rows, fact_rows=fact_rows):
                r = self.home[a]
                if r != fact:
                    return self.cols[r][a][rows[r]]
                c = self.cols[fact][a]
                return c[s:e] if fact_rows is None else c[fact_rows]

            m = e - s if fact_rows is None else int(fact_rows.shape[0])
            yield m, col

"""Plain reference of the regression tree's fit (CART on the label's
variance, level by level, as the paper's tree workload defines it).

A fit's statistics at a tree level are, for each frontier node and each
split feature, ``[count, Σy, Σy²]`` of the node's joined rows grouped by
the feature's code.  The reference routes every joined row down the judged
tree (the program's, or the control's) and sums in float64, so it follows
the judged tree's splits; it then checks each split on its own:

- ``stat_err``: the largest gap between the judged and the reference
  statistics, each bin's gap over that bin's ``Σ|terms|``;
- ``split_regret``: how far each node's split falls short of the best
  split that the reference's statistics allow, as a share of the best
  gain (1 where the judged tree stops at a node the reference would split,
  infinite where it splits against the rule).

``control`` grows a tree from statistics summed in bfloat16, the precision
below the configuration's float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cardbench.reference._join import GatheredJoin

GAIN_EPS = 1e-9        # a split must reduce the squared error by more


def features(tables) -> List[Tuple[str, str, int]]:
    return [(a, "ordered" if a.endswith("__b") else "categorical",
             tables.domain(a)) for a in tables.tree_features()]


def level_stats(join: GatheredJoin, tables, nodes: List[dict],
                front: List[int], dtype=torch.float64) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """``{feature: (stats, scale)}``, each ``(len(front), D, 3)``: the
    frontier nodes' statistics and each bin's ``[count, Σ|y|, Σy²]``."""
    feats = features(tables)
    device = next(iter(tables.columns[tables.fact].values())).device
    pos_of = torch.full((len(nodes),), -1, dtype=torch.long, device=device)
    pos_of[torch.tensor(front, dtype=torch.long, device=device)] = torch.arange(
        len(front), device=device)
    depth = nodes[front[0]]["depth"]
    acc = {a: torch.zeros((len(front) * d, 4), dtype=dtype, device=device)
           for a, _, d in feats}
    for m, col in join.chunks():
        idx = torch.zeros(m, dtype=torch.long, device=device)
        for i, nd in enumerate(nodes):
            if nd["depth"] < depth and nd["left"] >= 0:
                codes = col(nd["feature"])
                go = (codes <= nd["threshold"]) if nd["kind"] == "ordered" \
                    else (codes == nd["threshold"])
                here = idx == i
                idx = torch.where(here & go, nd["left"],
                                  torch.where(here, nd["right"], idx))
        # nodes route in id order, and a child's id is above its parent's
        pos = pos_of[idx]
        live = pos >= 0
        pos = pos[live]
        y = col(tables.label)[live].to(dtype)
        pay = torch.stack([torch.ones_like(y), y, y * y, y.abs()], 1)
        for a, _, d in feats:
            acc[a].index_add_(0, pos * d + col(a)[live].long(), pay)
    out = {}
    for a, _, d in feats:
        s = acc[a].double().view(len(front), d, 4).cpu().numpy()
        out[a] = (s[..., :3], s[..., [0, 3, 2]])
    return out


def split_gains(stats: np.ndarray, kind: str, min_instances: int) -> np.ndarray:
    """The squared-error reduction of each candidate split of one feature's
    ``(D, 3)`` statistics; ``-inf`` where a side would hold fewer than
    ``min_instances`` rows (ordered: threshold ``t`` sends codes ``<= t``
    left; categorical: code ``t`` against the rest)."""
    def cost(s):
        n = s[..., 0]
        return n, s[..., 2] - s[..., 1] ** 2 / np.maximum(n, 1e-9)

    tot = stats.sum(axis=0)
    n_tot, c_tot = cost(tot)
    left = np.cumsum(stats, axis=0)[:-1] if kind == "ordered" else stats
    nl, cl = cost(left)
    nr, cr = cost(tot[None, :] - left)
    ok = (nl >= min_instances) & (nr >= min_instances) & (n_tot >= 2 * min_instances)
    return np.where(ok, c_tot - (cl + cr), -np.inf)


def best_split(node_stats: Dict[str, np.ndarray], feats, min_instances: int
               ) -> Optional[Tuple[str, str, int, float]]:
    best = None
    for a, kind, _ in feats:
        g = split_gains(node_stats[a], kind, min_instances)
        if g.size and np.max(g) > -np.inf:
            t = int(np.argmax(g))
            if best is None or g[t] > best[3]:
                best = (a, kind, t, float(g[t]))
    return best


def grow(tables, params: dict, dtype) -> dict:
    """A whole fit from statistics summed in ``dtype``: the tree's nodes
    and each level's statistics, as a run records them."""
    join = GatheredJoin(tables)
    feats = features(tables)
    nodes = [dict(depth=0, feature=None, kind="", threshold=-1, left=-1, right=-1)]
    front, levels = [0], []
    while front:
        st = level_stats(join, tables, nodes, front, dtype)
        levels.append({a: s for a, (s, _) in st.items()})
        nxt = []
        for i, nid in enumerate(front):
            nd = nodes[nid]
            if nd["depth"] >= params["max_depth"]:
                continue
            best = best_split({a: s[i] for a, (s, _) in st.items()}, feats,
                              params["min_instances"])
            if best is None or best[3] <= GAIN_EPS or len(nodes) + 2 > params["max_nodes"]:
                continue
            nd.update(feature=best[0], kind=best[1], threshold=best[2],
                      left=len(nodes), right=len(nodes) + 1)
            for _ in range(2):
                nodes.append(dict(depth=nd["depth"] + 1, feature=None, kind="",
                                  threshold=-1, left=-1, right=-1))
            nxt += [nd["left"], nd["right"]]
        front = nxt
    return {"nodes": nodes, "levels": levels}


def judge(tables, record: dict) -> Dict[str, float]:
    """``record``: ``params`` of the fit and ``trees``, each fit's nodes
    and per-level statistics."""
    params = record["params"]
    join = GatheredJoin(tables)
    feats = features(tables)
    worst_stat, worst_regret = 0.0, 0.0
    cache = {}
    for tree in record["trees"]:
        nodes = tree["nodes"]
        for d, got in enumerate(tree["levels"]):
            front = [i for i, nd in enumerate(nodes) if nd["depth"] == d]
            key = _paths(nodes, front)
            if key not in cache:
                cache[key] = level_stats(join, tables, nodes, front)
            ref = cache[key]
            for a, _, _ in feats:
                want, scale = ref[a]
                err = np.abs(np.asarray(got[a], np.float64) - want) / np.maximum(scale, 1e-300)
                worst_stat = max(worst_stat, float(err.max()))
            for i, nid in enumerate(front):
                nd = nodes[nid]
                if d >= params["max_depth"]:
                    continue
                node_ref = {a: ref[a][0][i] for a, _, _ in feats}
                best = best_split(node_ref, feats, params["min_instances"])
                if nd["left"] < 0:
                    if best is not None and best[3] > GAIN_EPS:
                        worst_regret = max(worst_regret, 1.0)
                    continue
                kind = next(k for a, k, _ in feats if a == nd["feature"])
                g = split_gains(node_ref[nd["feature"]], kind, params["min_instances"])
                chosen = float(g[nd["threshold"]])
                regret = (np.inf if best is None or not np.isfinite(chosen)
                          else (best[3] - chosen) / abs(best[3]))
                worst_regret = max(worst_regret, regret)
    return {"stat_err": worst_stat, "split_regret": worst_regret}


def _paths(nodes: List[dict], front: List[int]) -> tuple:
    """Each frontier node's path of splits from the root."""
    parent = {}
    for i, nd in enumerate(nodes):
        if nd["left"] >= 0:
            parent[nd["left"]] = (i, 0)
            parent[nd["right"]] = (i, 1)
    out = []
    for nid in front:
        path = []
        while nid in parent:
            p, side = parent[nid]
            nd = nodes[p]
            path.append((nd["feature"], nd["threshold"], side))
            nid = p
        out.append(tuple(reversed(path)))
    return tuple(out)


def control(tables, traffic: dict, seed: int, units: int) -> dict:
    """A fit with the mix's parameters grown from statistics summed in
    bfloat16, in the program's place."""
    params = {k: traffic[k] for k in ("max_depth", "min_instances", "max_nodes")}
    return {"params": params, "trees": [grow(tables, params, torch.bfloat16)]}

"""Classification & regression trees (CART) over aggregate batches (paper
§2); counterpart of ``repro/ml/trees.py``.

Each CART node needs, per candidate split, COUNT / SUM(y) / SUM(y²) (variance,
regression) or per-class counts (Gini, classification) over the *fragment* of
the join satisfying the node's ancestor conditions — queries (8)-(10) of the
paper, "extended with the group-by attribute X" so that ONE query per feature
covers every threshold at once.

Dynamic functions, recompile-free: the node's conjunction of ancestor
conditions is Π_g mask_g[X_g], one mask-lookup UDAF per split attribute whose
(0/1) mask arrays are **runtime parameters**, so the whole tree is built from
a single compiled batch.

Frontier-batched fitting: with ``node_batch=True`` (default) the mask params
are declared ``batched``, the engine threads a param-batch (node) axis
through every layer, and ``fit()`` grows the tree level-synchronously — all
frontier nodes of a level are evaluated in ONE ``ViewHandle.run_batched``
pass, and each node's own stats (count, prediction) are read from the same
pass that scores its splits.  ``node_batch=False`` keeps the per-node loop
(one pass per node) for comparison; both produce the same trees.  The
stepping API (``init_fit`` / ``frontier_masks`` / ``advance``) lets
``ml/forest.py`` drive many trees' frontiers through one shared batch.

Sessions come from :func:`repro_torch.connect`, which puts the relations on
the card unless the caller passes ``database=connect(ds, device="cpu")``.
A level's statistics reach the host as float64 numpy arrays in one copy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.api import Database, ExecutionConfig, ViewHandle, connect
from repro_torch.core.aggregates import (Delta, Lambda, Param, Pow, Query, Var,
                                        agg, query)
from repro_torch.data.datasets import Dataset
from repro_torch.obs.trace import span


def _mask_term(attr: str, batched: bool = False) -> Lambda:
    p = Param(f"mask_{attr}", batched=batched)

    def fn(x, params, _name=p.name):
        # lookup-table UDAF: (D,) mask -> row mask; (N, D) batched masks ->
        # (N, *rows) with the node axis leading
        return params[_name][..., x.long()]

    tag = f"mask_{attr}" + (":batched" if batched else "")
    return Lambda((attr,), fn, tag=tag, param_refs=(p,))


@dataclasses.dataclass
class SplitFeature:
    attr: str          # categorical attr grouped by (bucket code for continuous)
    kind: str          # 'ordered' (threshold splits) | 'categorical' (one-vs-rest)
    domain: int


@dataclasses.dataclass
class TreeNode:
    node_id: int
    depth: int
    masks: Dict[str, np.ndarray]
    n: float = 0.0
    prediction: float = 0.0
    feature: Optional[str] = None
    kind: str = ""
    threshold: int = -1        # bucket threshold (ordered) or category (cat)
    left: int = -1
    right: int = -1

    @property
    def is_leaf(self) -> bool:
        return self.left < 0


def build_tree_features(ds: Dataset, label: Optional[str],
                        split_attrs: Optional[Sequence[str]]) -> List[SplitFeature]:
    if split_attrs is None:
        split_attrs = ([ds.bucket_attr(c) for c in ds.features_cont
                        if ds.bucket_attr(c) in ds.schema.attributes] +
                       [c for c in ds.features_cat if c != label])
    feats = []
    for a in split_attrs:
        kind = "ordered" if a.endswith("__b") else "categorical"
        feats.append(SplitFeature(a, kind, ds.schema.domain(a)))
    return feats


def tree_queries(features: Sequence[SplitFeature], task: str, label: str,
                 n_classes: int, node_batch: bool = True) -> List[Query]:
    """The per-feature split-statistics batch shared by a whole tree (or
    forest).  One query per feature: [COUNT, SUM(y), SUM(y²)] (regression)
    or [COUNT, per-class counts] (classification) under the node-condition
    mask product, grouped by the feature's code domain."""
    cond = [_mask_term(f.attr, batched=node_batch) for f in features]
    queries = []
    for f in features:
        if task == "regression":
            aggs = [agg(*cond), agg(Var(label), *cond),
                    agg(Pow(label, 2), *cond)]
        else:
            aggs = [agg(*cond)] + [agg(Delta(label, "==", c), *cond)
                                   for c in range(n_classes)]
        queries.append(query(f"split_{f.attr}", [f.attr], aggs))
    return queries


def build_tree_batch(ds: Dataset, features: Sequence[SplitFeature], task: str,
                     label: str, n_classes: int, *, node_batch: bool = True,
                     config: Optional[ExecutionConfig] = None,
                     database: Optional[Database] = None):
    """Register :func:`tree_queries` as session views.  ``database`` is an
    open session; without one, ``connect(ds, config)`` opens one on the
    card.  Returns ``(ViewHandle, queries)``."""
    queries = tree_queries(features, task, label, n_classes, node_batch)
    db = database or connect(ds, config=config)
    return db.views(queries), queries


def stack_mask_params(features: Sequence[SplitFeature],
                      mask_list: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack per-node mask dicts into the (N, D) batched param arrays."""
    return {f"mask_{f.attr}": np.stack([m[f.attr] for m in mask_list]
                                       ).astype(np.float32)
            for f in features}


def split_stats(outputs: Mapping[str, torch.Tensor],
                features: Sequence[SplitFeature]) -> Dict[str, np.ndarray]:
    """The ``split_<attr>`` outputs of one pass as float64 numpy arrays, in
    one device-to-host copy (the level's only synchronisation)."""
    parts = [outputs[f"split_{f.attr}"] for f in features]
    with span("tree.stats") as sp:
        flat = torch.cat([p.reshape(-1) for p in parts]).double().cpu().numpy()
        sp.set(bytes=flat.nbytes)
    out, o = {}, 0
    for f, p in zip(features, parts):
        out[f.attr] = flat[o:o + p.numel()].reshape(tuple(p.shape))
        o += p.numel()
    return out


def child_masks(masks: Dict[str, np.ndarray], feat: str, kind: str,
                thr: int) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Left/right node masks after splitting on ``feat`` at ``thr``."""
    lm = {a: m.copy() for a, m in masks.items()}
    rm = {a: m.copy() for a, m in masks.items()}
    d = lm[feat].shape[0]
    if kind == "ordered":
        ind = (np.arange(d) <= thr).astype(np.float32)
    else:
        ind = (np.arange(d) == thr).astype(np.float32)
    lm[feat] = lm[feat] * ind
    rm[feat] = rm[feat] * (1.0 - ind)
    return lm, rm


def predict_nodes(nodes: Sequence[TreeNode], rows: Dict[str, np.ndarray],
                  max_depth: int) -> np.ndarray:
    """Vectorized tree walk over materialized rows (test-time only)."""
    n = len(next(iter(rows.values())))
    out = np.zeros(n, dtype=np.float64)
    idx = np.zeros(n, dtype=np.int64)
    active = np.ones(n, dtype=bool)
    for _ in range(max_depth + 1):
        moved = False
        for nid, node in enumerate(nodes):
            sel = active & (idx == nid)
            if not sel.any():
                continue
            if node.is_leaf:
                out[sel] = node.prediction
                active[sel] = False
            else:
                moved = True
                codes = np.asarray(rows[node.feature])[sel]
                if node.kind == "ordered":
                    goleft = codes <= node.threshold
                else:
                    goleft = codes == node.threshold
                tmp = idx[sel]
                tmp[goleft] = node.left
                tmp[~goleft] = node.right
                idx[sel] = tmp
        if not moved:
            break
    for nid, node in enumerate(nodes):  # flush remaining
        sel = active & (idx == nid)
        if sel.any():
            out[sel] = node.prediction
    return out


class DecisionTree:
    """CART via one aggregate batch; task ∈ {'regression', 'classification'}.

    ``node_batch=True`` grows the tree frontier-batched (one pass per
    level); ``node_batch=False`` makes one pass per node.  Both run the same
    level-synchronous algorithm and produce the same trees.
    ``allowed_attrs`` restricts the split search to a feature subset (random
    forests pass per-tree subsets while sharing one compiled batch);
    ``batch`` injects a pre-registered shared :class:`ViewHandle` (see
    ``ml/forest.py``); ``config``/``database`` give the session.
    """

    def __init__(self, ds: Dataset, task: str = "regression",
                 label: Optional[str] = None,
                 split_attrs: Optional[Sequence[str]] = None,
                 max_depth: int = 4, min_instances: int = 1000,
                 max_nodes: int = 31, node_batch: bool = True,
                 allowed_attrs: Optional[Sequence[str]] = None,
                 batch: Optional[ViewHandle] = None,
                 config: Optional[ExecutionConfig] = None,
                 database: Optional[Database] = None):
        self.ds = ds
        self.task = task
        self.label = label or (ds.label if task == "regression" else None)
        if self.label is None:
            raise ValueError("classification needs an explicit categorical label")
        self.max_depth = max_depth
        self.min_instances = min_instances
        self.max_nodes = max_nodes
        self.node_batch = node_batch

        self.features: List[SplitFeature] = build_tree_features(
            ds, self.label if task == "classification" else None, split_attrs)
        self.allowed_attrs: Optional[Set[str]] = (
            set(allowed_attrs) if allowed_attrs is not None else None)

        if task == "classification":
            self.n_classes = ds.schema.domain(self.label)
        else:
            self.n_classes = 0

        if batch is None:
            batch, _ = build_tree_batch(
                ds, self.features, task, self.label, self.n_classes,
                node_batch=node_batch, config=config, database=database)
        self.view: ViewHandle = batch
        #: the underlying CompiledBatch (schedule/stats/dispatch counters)
        self.batch = batch.compiled
        self.n_aggregates = sum(
            (3 if task == "regression" else 1 + self.n_classes)
            * self.ds.schema.domain(f.attr) for f in self.features)
        self.nodes: List[TreeNode] = []
        self._frontier: List[int] = []

    def _node_params(self, masks: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return {f"mask_{a}": m.astype(np.float32) for a, m in masks.items()}

    # -- cost functions -------------------------------------------------------

    def _cost(self, stats: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """stats (..., n_aggs) -> (count, cost, prediction)."""
        n = stats[..., 0]
        safe_n = np.maximum(n, 1e-9)
        if self.task == "regression":
            s, s2 = stats[..., 1], stats[..., 2]
            cost = s2 - s * s / safe_n           # sum of squared errors
            pred = s / safe_n
        else:
            probs = stats[..., 1:] / safe_n[..., None]
            gini = 1.0 - (probs ** 2).sum(-1)
            cost = n * gini
            pred = stats[..., 1:].argmax(-1).astype(np.float64)
        return n, cost, pred

    # -- level-synchronous fitting (stepping API shared with ml/forest.py) ----

    def init_fit(self) -> None:
        root_masks = {f.attr: np.ones(f.domain, dtype=np.float32)
                      for f in self.features}
        self.nodes = [TreeNode(0, 0, root_masks)]
        self._frontier = [0]

    @property
    def growing(self) -> bool:
        return bool(self._frontier)

    def frontier_masks(self) -> List[Dict[str, np.ndarray]]:
        """Masks of the current frontier nodes, in frontier order."""
        return [self.nodes[nid].masks for nid in self._frontier]

    def advance(self, stats: Dict[str, np.ndarray]) -> None:
        """Consume one level's statistics — ``stats[attr]`` is
        ``(n_frontier, D_attr, n_aggs)`` — record every frontier node's count
        and prediction (leaf stats come from the same pass that scores the
        splits: no backfill), expand the winners, and move the frontier down
        one level."""
        next_frontier: List[int] = []
        with span("tree.split", n_frontier=len(self._frontier)) as sp:
            for i, nid in enumerate(self._frontier):
                node = self.nodes[nid]
                node_stats = {f.attr: stats[f.attr][i] for f in self.features}
                tot = node_stats[self.features[0].attr].sum(axis=0)
                n, _, pred = self._cost(tot)
                node.n, node.prediction = float(n), float(pred)
                if node.depth >= self.max_depth:
                    continue
                best = self._best_split(node_stats)
                if best is None:
                    continue
                feat, kind, thr, gain = best
                if gain <= 1e-9:
                    continue
                if len(self.nodes) + 2 > self.max_nodes:
                    continue
                lm, rm = child_masks(node.masks, feat, kind, thr)
                node.feature, node.kind, node.threshold = feat, kind, thr
                node.left = len(self.nodes)
                self.nodes.append(TreeNode(node.left, node.depth + 1, lm))
                node.right = len(self.nodes)
                self.nodes.append(TreeNode(node.right, node.depth + 1, rm))
                next_frontier += [node.left, node.right]
            sp.set(n_split=len(next_frontier) // 2)
        self._frontier = next_frontier

    def _eval_frontier(self) -> Dict[str, np.ndarray]:
        """One level's statistics, (n_frontier, D, n_aggs) per feature: a
        single pass when node-batched, one pass per node in the per-node
        comparison mode."""
        mask_list = self.frontier_masks()
        if self.node_batch:
            with span("tree.stage", level=self.nodes[self._frontier[0]].depth,
                      n_frontier=len(mask_list)):
                params = stack_mask_params(self.features, mask_list)
            return split_stats(self.view.run_batched(params), self.features)
        per_node = [self.view.run(params=self._node_params(m))
                    for m in mask_list]
        return split_stats({q: torch.stack([o[q] for o in per_node])
                            for q in per_node[0]}, self.features)

    def fit(self) -> "DecisionTree":
        self.init_fit()
        while self.growing:
            self.advance(self._eval_frontier())
        return self

    def split_gains(self, fstats: np.ndarray, kind: str) -> np.ndarray:
        """Cost reduction of every candidate split of one feature from its
        ``(D, n_aggs)`` statistics at a node; ``-inf`` where a side would
        hold fewer than ``min_instances`` rows or the node fewer than twice
        that."""
        tot = fstats.sum(axis=0)
        n_tot, cost_tot, _ = self._cost(tot)
        if kind == "ordered":
            left = np.cumsum(fstats, axis=0)[:-1]     # thresholds 0..D-2
        else:
            left = fstats                              # one-vs-rest
        right = tot[None, :] - left
        nl, cl, _ = self._cost(left)
        nr, cr, _ = self._cost(right)
        ok = ((nl >= self.min_instances) & (nr >= self.min_instances)
              & (n_tot >= 2 * self.min_instances))
        return np.where(ok, cost_tot - (cl + cr), -np.inf)

    def _best_split(self, stats: Dict[str, np.ndarray]) -> Optional[Tuple[str, str, int, float]]:
        best = None
        for f in self.features:
            if self.allowed_attrs is not None and f.attr not in self.allowed_attrs:
                continue
            gain = self.split_gains(stats[f.attr], f.kind)
            if gain.size and np.max(gain) > -np.inf:
                t = int(np.argmax(gain))
                cand = (f.attr, f.kind, t, float(gain[t]))
                if best is None or cand[3] > best[3]:
                    best = cand
        return best

    # -- inference over materialized rows (test-time only) ---------------------

    def predict(self, rows: Dict[str, np.ndarray]) -> np.ndarray:
        return predict_nodes(self.nodes, rows, self.max_depth)

    def n_split_nodes(self) -> int:
        return sum(1 for n in self.nodes if not n.is_leaf)

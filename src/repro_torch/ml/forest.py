"""Tree ensembles over the frontier-batched aggregate engine; counterpart of
``repro/ml/forest.py``.

Both workloads here only become feasible with the param-batch (node) axis:

* :class:`RandomForest` — bagged CART trees diversified by per-tree *feature
  masks* (each tree may only split on a random feature subset).  All trees
  share ONE compiled aggregate batch, and fitting is level-synchronous across
  the whole ensemble: the union of every tree's current frontier is evaluated
  in a single ``ViewHandle.run_batched`` pass per forest level, so a
  16-tree forest costs the same number of relation scans per level as one
  tree.

* :class:`GradientBoostedTrees` — squared-loss gradient boosting with
  *in-engine residual relabeling* (the AC/DC idea, arXiv 1803.07480): the
  residual r = y − base − Σ_ℓ v_ℓ·leafmask_ℓ never materializes as a column.
  Because node conditions and leaf regions are both mask *products*
  Π_a mask[x_a], SUM(r·cond_node) decomposes into SUM(y·cond_node) minus a
  combination of COUNT aggregates under *composed* masks (node ∧ leaf =
  elementwise mask product) — all evaluated as extra entries on the node
  axis of the same compiled batch.  Split scoring uses the first-order
  (gradient-sum) criterion gain = G_L²/n_L + G_R²/n_R − G²/n, standard for
  squared-loss GBMs, so only COUNT and SUM(y) histograms are needed.

Both ensembles are deterministic under a fixed ``seed``; feature bagging
draws from ``np.random.default_rng(seed)`` as the reference does, so one seed
gives the same feature subsets in both packages.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.api import Database, ExecutionConfig
from repro_torch.data.datasets import Dataset
from repro_torch.ml.trees import (DecisionTree, TreeNode, build_tree_batch,
                                  build_tree_features, child_masks,
                                  predict_nodes, split_stats,
                                  stack_mask_params)


class RandomForest:
    """Feature-bagged CART forest, level-synchronous over one shared batch.

    ``feature_fraction`` of the split features (at least one) is sampled per
    tree with ``np.random.default_rng(seed)``; tree growth itself is
    deterministic, so the whole ensemble is reproducible from ``seed``.
    """

    def __init__(self, ds: Dataset, n_trees: int = 8, task: str = "regression",
                 label: Optional[str] = None,
                 split_attrs: Optional[Sequence[str]] = None,
                 max_depth: int = 4, min_instances: int = 1000,
                 max_nodes: int = 31, feature_fraction: float = 0.6,
                 seed: int = 0,
                 config: Optional[ExecutionConfig] = None,
                 database: Optional[Database] = None):
        if n_trees < 1:
            raise ValueError("n_trees must be >= 1")
        self.ds = ds
        self.task = task
        self.label = label or (ds.label if task == "regression" else None)
        if self.label is None:
            raise ValueError(
                "no label: classification needs an explicit categorical label; "
                "regression needs label= or a dataset with a default label")
        self.n_trees = n_trees
        self.seed = seed

        self.features = build_tree_features(
            ds, self.label if task == "classification" else None, split_attrs)
        n_classes = ds.schema.domain(self.label) if task == "classification" else 0
        self.view, _ = build_tree_batch(
            ds, self.features, task, self.label, n_classes, node_batch=True,
            config=config, database=database)
        self.batch = self.view.compiled

        rng = np.random.default_rng(seed)
        k = max(1, int(round(feature_fraction * len(self.features))))
        attrs = [f.attr for f in self.features]
        self.trees: List[DecisionTree] = []
        for _ in range(n_trees):
            subset = list(rng.choice(attrs, size=k, replace=False))
            self.trees.append(DecisionTree(
                ds, task=task, label=self.label,
                split_attrs=[f.attr for f in self.features],
                max_depth=max_depth, min_instances=min_instances,
                max_nodes=max_nodes, node_batch=True,
                allowed_attrs=subset, batch=self.view))

    def fit(self) -> "RandomForest":
        """Grow every tree level-synchronously: one pass evaluates the union
        of all trees' frontiers per forest level."""
        for t in self.trees:
            t.init_fit()
        while any(t.growing for t in self.trees):
            spans: List[Tuple[DecisionTree, int]] = []
            mask_list: List[Dict[str, np.ndarray]] = []
            for t in self.trees:
                ms = t.frontier_masks() if t.growing else []
                spans.append((t, len(ms)))
                mask_list += ms
            params = stack_mask_params(self.features, mask_list)
            stats = split_stats(self.view.run_batched(params), self.features)
            o = 0
            for t, k in spans:
                if k:
                    t.advance({a: s[o:o + k] for a, s in stats.items()})
                    o += k
        return self

    def predict(self, rows: Dict[str, np.ndarray]) -> np.ndarray:
        preds = np.stack([t.predict(rows) for t in self.trees])
        if self.task == "regression":
            return preds.mean(axis=0)
        # majority vote over class codes
        votes = preds.astype(np.int64)
        n_classes = int(votes.max()) + 1
        counts = np.zeros((votes.shape[1], n_classes), dtype=np.int64)
        for t in range(votes.shape[0]):
            np.add.at(counts, (np.arange(votes.shape[1]), votes[t]), 1)
        return counts.argmax(axis=1).astype(np.float64)


class GradientBoostedTrees:
    """Squared-loss gradient boosting, residual-relabeled inside the engine.

    Each round grows a regression tree on the residual
    r = y − base − Σ_ℓ v_ℓ·1[x ∈ region_ℓ] using only COUNT/SUM(y)
    histograms of the shared compiled batch: residual sums are reconstructed
    from counts under composed (node ∧ leaf) masks riding the same node
    axis, so a frontier of F nodes against L prior leaves is one
    ``run_batched`` pass with N = F·(1+L) entries — never a second scan.
    """

    def __init__(self, ds: Dataset, n_rounds: int = 4,
                 learning_rate: float = 0.3,
                 split_attrs: Optional[Sequence[str]] = None,
                 max_depth: int = 3, min_instances: int = 1000,
                 max_nodes: int = 15,
                 config: Optional[ExecutionConfig] = None,
                 database: Optional[Database] = None):
        self.ds = ds
        self.label = ds.label
        self.n_rounds = n_rounds
        self.lr = learning_rate
        self.max_depth = max_depth
        self.min_instances = min_instances
        self.max_nodes = max_nodes

        self.features = build_tree_features(ds, None, split_attrs)
        self.view, _ = build_tree_batch(
            ds, self.features, "regression", self.label, 0, node_batch=True,
            config=config, database=database)
        self.batch = self.view.compiled

        self.base: float = 0.0
        self.trees: List[List[TreeNode]] = []
        self._leaves: List[Tuple[Dict[str, np.ndarray], float]] = []
        self._base_set = False

    # -- fitting --------------------------------------------------------------

    def fit(self) -> "GradientBoostedTrees":
        self.trees = []
        self._leaves = []
        self._base_set = False
        for _ in range(self.n_rounds):
            nodes = self._grow_round()
            self.trees.append(nodes)
            for nd in nodes:
                if nd.is_leaf:
                    self._leaves.append((nd.masks, self.lr * nd.prediction))
        return self

    def _residual_hists(self, frontier_masks: List[Dict[str, np.ndarray]]):
        """One pass for the whole frontier × prior-leaf grid; returns per
        frontier node, per feature: (count hist, residual-sum hist)."""
        F, L = len(frontier_masks), len(self._leaves)
        mask_list = list(frontier_masks)
        for m in frontier_masks:
            for lmask, _ in self._leaves:
                mask_list.append({a: m[a] * lmask[a] for a in m})
        params = stack_mask_params(self.features, mask_list)
        stats = split_stats(self.view.run_batched(params), self.features)
        if not self._base_set:
            tot = stats[self.features[0].attr][0].sum(axis=0)
            self.base = float(tot[1] / max(tot[0], 1e-9))
            self._base_set = True
        hists = []
        for i in range(F):
            per_feat = {}
            for f in self.features:
                cnt = stats[f.attr][i, :, 0]
                sr = stats[f.attr][i, :, 1] - self.base * cnt
                for j, (_, val) in enumerate(self._leaves):
                    sr = sr - val * stats[f.attr][F + i * L + j, :, 0]
                per_feat[f.attr] = (cnt, sr)
            hists.append(per_feat)
        return hists

    def _best_split(self, hist) -> Optional[Tuple[str, str, int, float]]:
        """First-order gain G_L²/n_L + G_R²/n_R − G²/n over all features."""
        best = None
        for f in self.features:
            cnt, sr = hist[f.attr]
            n_tot, g_tot = cnt.sum(), sr.sum()
            if n_tot < 2 * self.min_instances:
                continue
            if f.kind == "ordered":
                nl, gl = np.cumsum(cnt)[:-1], np.cumsum(sr)[:-1]
            else:
                nl, gl = cnt, sr
            nr, gr = n_tot - nl, g_tot - gl
            ok = (nl >= self.min_instances) & (nr >= self.min_instances)
            gain = np.where(
                ok,
                gl ** 2 / np.maximum(nl, 1e-9) + gr ** 2 / np.maximum(nr, 1e-9)
                - g_tot ** 2 / max(n_tot, 1e-9),
                -np.inf)
            if gain.size and np.max(gain) > -np.inf:
                t = int(np.argmax(gain))
                cand = (f.attr, f.kind, t, float(gain[t]))
                if best is None or cand[3] > best[3]:
                    best = cand
        return best

    def _grow_round(self) -> List[TreeNode]:
        root_masks = {f.attr: np.ones(f.domain, dtype=np.float32)
                      for f in self.features}
        nodes = [TreeNode(0, 0, root_masks)]
        frontier = [0]
        while frontier:
            hists = self._residual_hists([nodes[i].masks for i in frontier])
            next_frontier = []
            for hist, nid in zip(hists, frontier):
                node = nodes[nid]
                cnt, sr = hist[self.features[0].attr]
                n_tot, g_tot = cnt.sum(), sr.sum()
                node.n = float(n_tot)
                node.prediction = float(g_tot / max(n_tot, 1e-9))  # mean residual
                if node.depth >= self.max_depth:
                    continue
                best = self._best_split(hist)
                if best is None:
                    continue
                feat, kind, thr, gain = best
                if gain <= 1e-9 or len(nodes) + 2 > self.max_nodes:
                    continue
                lm, rm = child_masks(node.masks, feat, kind, thr)
                node.feature, node.kind, node.threshold = feat, kind, thr
                node.left = len(nodes)
                nodes.append(TreeNode(node.left, node.depth + 1, lm))
                node.right = len(nodes)
                nodes.append(TreeNode(node.right, node.depth + 1, rm))
                next_frontier += [node.left, node.right]
            frontier = next_frontier
        return nodes

    # -- inference ------------------------------------------------------------

    def predict(self, rows: Dict[str, np.ndarray]) -> np.ndarray:
        n = len(next(iter(rows.values())))
        out = np.full(n, self.base, dtype=np.float64)
        for nodes in self.trees:
            out += self.lr * predict_nodes(nodes, rows, self.max_depth)
        return out

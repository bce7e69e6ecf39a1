"""Random-forest regression from scratch (numpy CART ensemble).

No sklearn in this environment; the paper uses random forests [Breiman 2001]
for operator runtime prediction, so we implement one: variance-reduction
CART trees with bootstrap sampling and per-split feature subsampling,
vectorized over prefix sums.  Targets are fit in log-space by the callers
(runtimes span orders of magnitude).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class _Tree:
    feature: np.ndarray      # (nodes,) int; -1 => leaf
    threshold: np.ndarray    # (nodes,) float
    left: np.ndarray         # (nodes,) int
    right: np.ndarray        # (nodes,) int
    value: np.ndarray        # (nodes,) float

    def predict(self, X: np.ndarray) -> np.ndarray:
        out = np.empty(len(X))
        for r in range(len(X)):
            n = 0
            while self.feature[n] >= 0:
                n = (self.left[n] if X[r, self.feature[n]] <= self.threshold[n]
                     else self.right[n])
            out[r] = self.value[n]
        return out


def _best_split(X: np.ndarray, y: np.ndarray, feats: np.ndarray,
                min_leaf: int) -> Tuple[Optional[int], float, float]:
    n = len(y)
    base_sse = float(((y - y.mean()) ** 2).sum())
    best = (None, 0.0, base_sse)
    for j in feats:
        order = np.argsort(X[:, j], kind="stable")
        xs, ys = X[order, j], y[order]
        c1 = np.cumsum(ys)
        c2 = np.cumsum(ys * ys)
        ln = np.arange(1, n)
        tot1, tot2 = c1[-1], c2[-1]
        sse_l = c2[:-1] - c1[:-1] ** 2 / ln
        rn = n - ln
        sse_r = (tot2 - c2[:-1]) - (tot1 - c1[:-1]) ** 2 / rn
        sse = sse_l + sse_r
        ok = (xs[1:] != xs[:-1]) & (ln >= min_leaf) & (rn >= min_leaf)
        if not ok.any():
            continue
        sse = np.where(ok, sse, np.inf)
        i = int(np.argmin(sse))
        if sse[i] < best[2] - 1e-12:
            best = (int(j), float((xs[i] + xs[i + 1]) / 2.0), float(sse[i]))
    return best


def _grow(X: np.ndarray, y: np.ndarray, *, max_depth: int, min_leaf: int,
          max_features: int, rng: np.random.Generator) -> _Tree:
    feat, thr, left, right, val = [], [], [], [], []

    def node(idx: np.ndarray, depth: int) -> int:
        me = len(feat)
        feat.append(-1); thr.append(0.0); left.append(-1); right.append(-1)
        val.append(float(y[idx].mean()))
        if depth >= max_depth or len(idx) < 2 * min_leaf or np.ptp(y[idx]) < 1e-12:
            return me
        fs = rng.choice(X.shape[1], size=min(max_features, X.shape[1]),
                        replace=False)
        j, t, _ = _best_split(X[idx], y[idx], fs, min_leaf)
        if j is None:
            return me
        mask = X[idx, j] <= t
        if mask.all() or not mask.any():
            return me
        feat[me], thr[me] = j, t
        left[me] = node(idx[mask], depth + 1)
        right[me] = node(idx[~mask], depth + 1)
        return me

    node(np.arange(len(y)), 0)
    return _Tree(np.array(feat), np.array(thr), np.array(left),
                 np.array(right), np.array(val))


class RandomForest:
    def __init__(self, n_trees: int = 24, max_depth: int = 14,
                 min_leaf: int = 2, max_features: Optional[int] = None,
                 seed: int = 0):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.max_features = max_features
        self.seed = seed
        self.trees: List[_Tree] = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RandomForest":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        rng = np.random.default_rng(self.seed)
        mf = self.max_features or max(1, int(np.ceil(X.shape[1] / 3)))
        self.trees = []
        for _ in range(self.n_trees):
            idx = rng.integers(0, len(y), len(y))   # bootstrap
            self.trees.append(_grow(X[idx], y[idx], max_depth=self.max_depth,
                                    min_leaf=self.min_leaf, max_features=mf,
                                    rng=rng))
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float64)
        if X.ndim == 1:
            X = X[None, :]
        return np.mean([t.predict(X) for t in self.trees], axis=0)

    # ------------------------------------------------------- serialization --
    # JSON-portable dict form: hyperparameters + flat per-tree node arrays.
    # float64 round-trips exactly through repr-based json encoding, so a
    # from_dict(to_dict(f)) forest predicts bit-identically.
    def to_dict(self) -> dict:
        return {
            "n_trees": self.n_trees,
            "max_depth": self.max_depth,
            "min_leaf": self.min_leaf,
            "max_features": self.max_features,
            "seed": self.seed,
            "trees": [{
                "feature": t.feature.tolist(),
                "threshold": t.threshold.tolist(),
                "left": t.left.tolist(),
                "right": t.right.tolist(),
                "value": t.value.tolist(),
            } for t in self.trees],
        }

    @classmethod
    def from_dict(cls, data: dict) -> "RandomForest":
        forest = cls(n_trees=int(data["n_trees"]),
                     max_depth=int(data["max_depth"]),
                     min_leaf=int(data["min_leaf"]),
                     max_features=data.get("max_features"),
                     seed=int(data.get("seed", 0)))
        forest.trees = [
            _Tree(feature=np.asarray(t["feature"], np.int64),
                  threshold=np.asarray(t["threshold"], np.float64),
                  left=np.asarray(t["left"], np.int64),
                  right=np.asarray(t["right"], np.int64),
                  value=np.asarray(t["value"], np.float64))
            for t in data["trees"]]
        return forest

"""Scaling, splitting and metrics (the port's own copy of the JAX package's
`data/preprocess.py`, numpy only): re-implementations of the sklearn pieces
the reference depends on (SURVEY.md §2.11):

* ``MinMaxScaler(feature_range=(-1, 1))`` — Inverse_Diffusion.ipynb cell 23.
* ``train_test_split(test_size=0.1, random_state=235)`` — `generative.py:1044`.
* ``r2_score`` — `generative.py:636` et al.

Equality with sklearn is pinned by tests (tests/test_data.py), equality with
the JAX package's copy by tests/test_torch_data_copies.py.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


class MinMaxScaler:
    """Feature-range min-max scaler matching sklearn semantics."""

    def __init__(self, feature_range: Tuple[float, float] = (-1.0, 1.0)):
        self.feature_range = feature_range
        self.data_min_ = None
        self.data_max_ = None
        self.scale_ = None
        self.min_ = None

    def fit(self, x) -> "MinMaxScaler":
        x = np.asarray(x, dtype=np.float64)
        lo, hi = self.feature_range
        self.data_min_ = x.min(axis=0)
        self.data_max_ = x.max(axis=0)
        data_range = self.data_max_ - self.data_min_
        # sklearn's _handle_zeros_in_scale: a NEAR-constant feature
        # (range < 10*eps, not just exactly 0) keeps range 1 — dividing by
        # a denormal-scale range would explode the transform
        data_range = np.where(
            data_range < 10 * np.finfo(np.float64).eps, 1.0, data_range)
        self.scale_ = (hi - lo) / data_range
        self.min_ = lo - self.data_min_ * self.scale_
        return self

    def transform(self, x) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        return x * self.scale_ + self.min_

    def fit_transform(self, x) -> np.ndarray:
        return self.fit(x).transform(x)

    def inverse_transform(self, x) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        return (x - self.min_) / self.scale_

    def state_dict(self) -> Dict:
        return {"feature_range": list(self.feature_range),
                "data_min": self.data_min_.tolist(),
                "data_max": self.data_max_.tolist()}

    @classmethod
    def from_state_dict(cls, state: Dict) -> "MinMaxScaler":
        s = cls(tuple(state["feature_range"]))
        s.fit(np.stack([state["data_min"], state["data_max"]]))
        return s


def train_test_split_indices(n_samples: int, test_size: float = 0.1,
                             random_state: int = 235) -> Tuple[np.ndarray, np.ndarray]:
    """Reproduce sklearn's shuffled split exactly: a seeded permutation whose
    first ``ceil(test_size*n)`` entries are the test set."""
    n_test = int(np.ceil(test_size * n_samples))
    n_train = n_samples - n_test
    rng = np.random.RandomState(random_state)
    permutation = rng.permutation(n_samples)
    test_idx = permutation[:n_test]
    train_idx = permutation[n_test:n_test + n_train]
    return train_idx, test_idx


def train_test_split(X, y, test_size: float = 0.1, random_state: int = 235):
    train_idx, test_idx = train_test_split_indices(len(X), test_size,
                                                   random_state)
    return X[train_idx], X[test_idx], y[train_idx], y[test_idx]


def r2_score(y_true, y_pred) -> float:
    """Coefficient of determination, sklearn-compatible on flat arrays."""
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    y_pred = np.asarray(y_pred, dtype=np.float64).ravel()
    ss_res = float(((y_true - y_pred) ** 2).sum())
    ss_tot = float(((y_true - y_true.mean()) ** 2).sum())
    if ss_tot == 0.0:
        return 1.0 if ss_res == 0.0 else 0.0
    return 1.0 - ss_res / ss_tot


def mean_absolute_error(y_true, y_pred) -> float:
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    return float(np.abs(y_true - y_pred).mean())

"""Deterministic dataset splits (port of `ssl4gie_tpu/data/splits.py`),
bit for bit.

The reference's chained sklearn `train_test_split(random_state=42)`
80/10/10 split (`Binary_segmentation/Data/dataloaders.py:42-57`, the same
in every task) in pure numpy: sklearn's ShuffleSplit draws
`RandomState(seed).permutation(n)`, takes `perm[:n_test]` as test and
`perm[n_test:n_test+n_train]` as train.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _train_test_split(indices: np.ndarray, test_size: int,
                      random_state: int = 42
                      ) -> Tuple[np.ndarray, np.ndarray]:
    n = len(indices)
    n_test = int(test_size)
    perm = np.random.RandomState(random_state).permutation(n)
    return indices[perm[n_test:n]], indices[perm[:n_test]]


def split_ids(len_ids: int, seed: int = 42
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(train_indices, test_indices, val_indices), as the reference's
    split_ids: both chained splits take test_size = round(10% of all)."""
    test_size = int(round((10 / 100) * len_ids))
    all_ids = np.linspace(0, len_ids - 1, len_ids).astype(int)
    train_indices, test_indices = _train_test_split(all_ids, test_size, seed)
    train_indices, val_indices = _train_test_split(train_indices, test_size,
                                                   seed)
    return train_indices, test_indices, val_indices

"""Synthetic datasets (plain numpy, copied from the JAX package's
``data/pipeline.py`` so that both packages draw bitwise-equal data)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def gaussian_mixture_dataset(n_classes: int, dim: int, n: int, seed: int = 0,
                             noise: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Fixed class means on a sphere, isotropic noise. Returns (X, y)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n_classes, dim))
    means /= np.linalg.norm(means, axis=1, keepdims=True)
    means *= 3.0
    y = rng.integers(0, n_classes, size=n)
    X = means[y] + noise * rng.normal(size=(n, dim))
    return X.astype(np.float32), y.astype(np.int32)

"""Synthetic datasets (the port's own copy of ``gen_dataset`` from
image_matching_tpu/utils/io.py: the same generator, the same vectors for
one seed)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def gen_dataset(n: int, vector_dim: int = 512, seed: int = 0,
                match_index: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic planted-match dataset (reference tools/gen_dataset.sh):
    query = all ones; the planted matching vector has values in 1..3
    (cosine similarity ~0.9 with the query); others uniform in [-99, 99]
    (expected similarity ~0)."""
    rng = np.random.default_rng(seed)
    query = np.ones(vector_dim)
    db = rng.integers(-99, 100, size=(n, vector_dim)).astype(np.float64)
    db[match_index] = rng.integers(1, 4, size=vector_dim)
    return query, db

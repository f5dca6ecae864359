"""Plaintext vector math (reference src/vector_utils.cpp) — the oracle for
accuracy checks, vectorized in numpy.  The port's own copy of
image_matching_tpu/matching/vector_utils.py."""

from __future__ import annotations

import numpy as np


def normalize(x: np.ndarray) -> np.ndarray:
    """L2-normalize rows; zero rows stay zero
    (reference plaintextNormalize, src/vector_utils.cpp:42-51)."""
    x = np.asarray(x, dtype=np.float64)
    m = np.linalg.norm(x, axis=-1, keepdims=True)
    return np.where(m == 0, x, x / np.where(m == 0, 1.0, m))


def cosine_similarity(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Cosine similarity between x [..., d] and y [..., d]
    (reference plaintextCosineSim, src/vector_utils.cpp:12-29)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    num = (x * y).sum(axis=-1)
    den = np.linalg.norm(x, axis=-1) * np.linalg.norm(y, axis=-1)
    return num / den


def inner_product(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return (np.asarray(x, dtype=np.float64) * np.asarray(y, dtype=np.float64)).sum(axis=-1)


def magnitude(x: np.ndarray) -> np.ndarray:
    return np.linalg.norm(np.asarray(x, dtype=np.float64), axis=-1)

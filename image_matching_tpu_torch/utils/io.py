"""Dataset IO and synthetic datasets (the port's own copy of
image_matching_tpu/utils/io.py: the same `.dat` reader and writer, the same
generators, the same vectors for one seed).

The `.dat` text format matches the reference (tools/gen_dataset.sh /
src/main.cpp:216-230): first line N, then the query vector, then N database
vectors, whitespace-separated integers (dimension inferred from config).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from . import native


def read_dataset(path: str, vector_dim: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """-> (query [dim], database [N, dim]), through the host C++ parser
    (``native.parse_dat``) where its library loads, else in Python."""
    if native.available():
        head = native.parse_dat(path, 1)
        n = int(head[0])
        vals = native.parse_dat(path, 1 + (n + 1) * vector_dim)[1:]
    else:
        with open(path) as f:
            tokens = f.read().split()
        n = int(tokens[0])
        vals = np.array(tokens[1 : 1 + (n + 1) * vector_dim], dtype=np.float64)
    query = vals[:vector_dim]
    db = vals[vector_dim:].reshape(n, vector_dim)
    return query, db


def write_dataset(path: str, query: np.ndarray, db: np.ndarray):
    with open(path, "w") as f:
        f.write(f"{db.shape[0]}\n")
        f.write(" ".join(str(int(v)) for v in query) + " \n")
        for row in db:
            f.write(" ".join(str(int(v)) for v in row) + " \n")


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


def gen_identity_dataset(n_ids: int, per_id: int, n_queries: int,
                         vector_dim: int = 512, seed: int = 0,
                         noise: float = 0.35, borderline: int = 0,
                         borderline_band=(0.38, 0.50)):
    """Synthetic FRGC-like identity-labeled embeddings (the real FRGC 2.0
    files used by the reference accuracy program, src/main_accuracy.cpp:45-97,
    are not distributed).  Same-identity embeddings are noisy copies of an
    identity prototype, giving realistic same/different cosine separation.

    With borderline > 0, each query additionally gets that many planted
    cross-identity DB entries whose cosine similarity to the query is drawn
    uniformly from `borderline_band`, straddling the 0.44 match threshold,
    so the hybrid sign approximation is exercised where the reference
    validates it (tools/figures/signApprox.csv).  Planted entries carry
    fresh identity labels (>= n_ids), so ground truth says non-match.

    The draws are made one vector at a time in this order, as the JAX
    package makes them: the arrays are the accuracy campaign's ground
    truth, and drawing in bulk would change them.

    -> (db [n_ids*per_id + n_queries*borderline, dim], db_ids,
        queries [n_queries, dim], query_ids)
    """
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(n_ids, vector_dim))
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    # per-component noise scaled so same-identity cosine ~ 1/(1+noise^2)
    # independent of dimension
    sd = noise / np.sqrt(vector_dim)
    db = []
    db_ids = []
    for i in range(n_ids):
        for _ in range(per_id):
            db.append(protos[i] + sd * rng.normal(size=vector_dim))
            db_ids.append(i)
    qids = rng.integers(0, n_ids, size=n_queries)
    queries = protos[qids] + sd * rng.normal(size=(n_queries, vector_dim))
    next_id = n_ids
    for qi in range(n_queries if borderline else 0):
        u = queries[qi] / np.linalg.norm(queries[qi])
        for _ in range(borderline):
            c = rng.uniform(*borderline_band)
            w = rng.normal(size=vector_dim)
            w -= (w @ u) * u
            w /= np.linalg.norm(w)
            # cosine(v, query) == c by construction (both get normalized
            # before scoring)
            db.append(c * u + math.sqrt(1.0 - c * c) * w)
            db_ids.append(next_id)
            next_id += 1
    return (np.array(db), np.array(db_ids, dtype=np.int64),
            queries, qids.astype(np.int64))

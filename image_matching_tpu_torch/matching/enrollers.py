"""Encrypted-database enrollment, one packing layout per approach (port of
image_matching_tpu/matching/enrollers.py).

The plaintext layouts are the JAX package's numpy code; what changes is
that the ciphertexts are torch tensors on the context's device, written
chunk by chunk into one preallocated stack so the database is never held
twice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..ckks.context import CkksContext
from .config import MatchConfig
from .vector_utils import normalize


@dataclasses.dataclass
class BaseDB:
    """Vector-sequential layout (approaches 1-2): ciphertext i holds
    slots/dim whole vectors back to back."""
    data: torch.Tensor  # [num_batches, 2, L, N]
    num_vectors: int
    scale: float


@dataclasses.dataclass
class BlindDB:
    """Chunk-column layout (approach 3): ciphertext (m, j) holds chunk j of
    slots/chunk_len vectors."""
    data: torch.Tensor  # [num_matrices, chunks_per_vector, 2, L, N]
    num_vectors: int
    scale: float


@dataclasses.dataclass
class DiagDB:
    """Diagonalized layout (approach 5, HyDia): square dim x dim matrices
    turned into generalized diagonals, diagonals of matrices_per_batch
    matrices concatenated per ciphertext.

    When `bsgs` is set, diagonal (g*j + b) is pre-rotated by +g*j slots at
    enrollment so the sender only needs baby-step rotations of the query
    plus one giant rotation per partial sum."""
    data: torch.Tensor  # [groups, dim, 2, L, N]; dim axis = (j, b) if bsgs
    num_vectors: int
    scale: float
    bsgs: bool
    n1: int  # baby steps (bsgs only)


@dataclasses.dataclass
class HersDB:
    """Dimension-major layout (approach 4, HERS): ciphertext (m, j) holds
    feature j of ``slots`` consecutive vectors."""
    data: torch.Tensor  # [num_matrices, dim, 2, L, N]
    num_vectors: int
    scale: float


def _encrypt_stack(ctx: CkksContext, values: np.ndarray, chunk: int = 64) -> torch.Tensor:
    """Encrypt [B, slots] -> [B, 2, L, N] in chunks of `chunk` (one
    encryption seed drawn per chunk, as in the JAX package)."""
    B = values.shape[0]
    out = torch.empty((B, 2, ctx.Lq, ctx.n), dtype=torch.int32, device=ctx.device)
    for i in range(0, B, chunk):
        out[i : i + chunk] = ctx.encrypt_batch(values[i : i + chunk])
    return out


def enroll_base(ctx: CkksContext, cfg: MatchConfig, db: np.ndarray) -> BaseDB:
    dim = cfg.vector_dim
    per = ctx.slots // dim
    nvec = db.shape[0]
    nb = math.ceil(nvec / per)
    flat = np.zeros((nb * per, dim))
    flat[:nvec] = normalize(db)
    return BaseDB(_encrypt_stack(ctx, flat.reshape(nb, per * dim)), nvec, ctx.fresh_scale)


def enroll_blind(ctx: CkksContext, cfg: MatchConfig, db: np.ndarray) -> BlindDB:
    dim, cl = cfg.vector_dim, cfg.chunk_len
    cpb = ctx.slots // cl  # vectors ("chunks") per batch
    cpv = dim // cl        # chunks per vector
    nvec = db.shape[0]
    nm = math.ceil(nvec / cpb)
    full = np.zeros((nm * cpb, dim))
    full[:nvec] = normalize(db)
    # values[m, j, i*cl + t] = full[m*cpb + i][j*cl + t]
    vals = full.reshape(nm, cpb, cpv, cl).transpose(0, 2, 1, 3).reshape(nm * cpv, ctx.slots)
    data = _encrypt_stack(ctx, vals).reshape(nm, cpv, 2, -1, ctx.n)
    return BlindDB(data, nvec, ctx.fresh_scale)


def hers_group_vals(rows: np.ndarray, batch: int) -> np.ndarray:
    """Slot values of one HERS matrix: up to ``batch`` normalized vectors
    [rows, dim] -> [dim, batch], values[j, k] = rows[k][j] (zero padded)."""
    full = np.zeros((batch, rows.shape[1]))
    full[: rows.shape[0]] = rows
    return np.ascontiguousarray(full.T)


def enroll_hers(ctx: CkksContext, cfg: MatchConfig, db: np.ndarray) -> HersDB:
    dim = cfg.vector_dim
    batch = ctx.slots
    nvec = db.shape[0]
    nm = math.ceil(nvec / batch)
    db = normalize(db)
    # values[m, j, k] = db[m*batch + k][j]
    vals = np.concatenate([hers_group_vals(db[m * batch: (m + 1) * batch], batch)
                           for m in range(nm)])
    data = _encrypt_stack(ctx, vals).reshape(nm, dim, 2, -1, ctx.n)
    return HersDB(data, nvec, ctx.fresh_scale)


def diag_group_vals(sq: np.ndarray, dim: int, mpb: int, bsgs: bool,
                    n1: int) -> np.ndarray:
    """Slot values for one diagonal group: [mpb, dim, dim] normalized
    square matrices -> [dim, mpb*dim] generalized diagonals, BSGS
    pre-rotated when requested."""
    # generalized diagonals: diag[i][j] = M[j][(j+i) % dim]
    j_idx = np.arange(dim)[None, :]
    i_idx = np.arange(dim)[:, None]
    col = (j_idx + i_idx) % dim  # [dim(i), dim(j)]
    diags = sq[:, j_idx.ravel(), col.reshape(dim, dim)]  # [mpb, dim(i), dim(j)]
    vals = diags.transpose(1, 0, 2).reshape(dim, mpb * dim)
    if bsgs:
        n2 = dim // n1
        out = np.empty_like(vals)
        for j in range(n2):
            blk = vals[n1 * j : n1 * (j + 1), :]
            out[n1 * j : n1 * (j + 1), :] = np.roll(blk, n1 * j, axis=-1)
        vals = out
    return vals


def diag_bsgs_n1(dim: int) -> int:
    return 1 << math.ceil(math.log2(dim) / 2)


def enroll_diag(ctx: CkksContext, cfg: MatchConfig, db: np.ndarray,
                bsgs: Optional[bool] = None) -> DiagDB:
    dim = cfg.vector_dim
    batch = ctx.slots
    mpb = batch // dim  # matrices per batch/ciphertext
    nvec = db.shape[0]
    if bsgs is None:
        bsgs = cfg.use_bsgs
    db = normalize(db)
    nmat = math.ceil(nvec / dim)
    groups = math.ceil(nmat / mpb)
    full = np.zeros((groups * mpb * dim, dim))
    full[:nvec] = db
    sq = full.reshape(groups, mpb, dim, dim)  # square matrices
    n1 = diag_bsgs_n1(dim) if bsgs else 1
    vals = np.stack([
        diag_group_vals(sq[g], dim, mpb, bsgs, n1) for g in range(groups)
    ])
    data = _encrypt_stack(ctx, vals.reshape(groups * dim, batch))
    data = data.reshape(groups, dim, 2, -1, ctx.n)
    return DiagDB(data, nvec, ctx.fresh_scale, bsgs, n1)

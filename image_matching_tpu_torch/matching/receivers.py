"""Receivers: client-side query encryption and result decryption/decoding
(port of image_matching_tpu/matching/receivers.py, approaches 1-5)."""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np

from ..ckks import encoding
from ..ckks.context import CkksContext, Ciphertext
from .config import MatchConfig
from .vector_utils import normalize


def decrypt_all(ctx: CkksContext, cts: Sequence[Ciphertext]) -> List[np.ndarray]:
    """Each ciphertext's slots, as ``ctx.decrypt`` gives them: the list
    decrypted at once (``ctx._decrypt_many``), decoded one by one."""
    return [encoding.decode(c, ctx.n, ct.scale) for c, ct in zip(ctx._decrypt_many(cts), cts)]


class HersReceiver:
    """Approach 4 query layout (one ciphertext per feature, replicated in
    every slot) and the decode rules approaches 4 and 5 share."""

    def __init__(self, ctx: CkksContext, cfg: MatchConfig, num_vectors: int):
        self.ctx = ctx
        self.cfg = cfg
        self.num_vectors = num_vectors

    def encrypt_query(self, query: np.ndarray) -> List[Ciphertext]:
        q = normalize(np.asarray(query, dtype=np.float64))
        if self.cfg.hers_alt_query:
            # encryptQueryAlt: one ciphertext with the query replicated
            # every vector_dim slots
            reps = self.ctx.slots // self.cfg.vector_dim
            return [self.ctx.encrypt(np.tile(q, reps))]
        vals = np.repeat(q[:, None], self.ctx.slots, axis=1)
        data = self.ctx.encrypt_batch(vals)
        return [Ciphertext(data[i], self.ctx.fresh_scale)
                for i in range(self.cfg.vector_dim)]

    def decrypt_membership(self, ct: Ciphertext) -> bool:
        """True iff slot 0 >= 1.0."""
        return bool(self.ctx.decrypt(ct)[0] >= 1.0)

    def decrypt_index(self, cts: Sequence[Ciphertext]) -> List[int]:
        """Every slot >= 1.0 maps to DB id j + i*batch."""
        batch = self.ctx.slots
        out = []
        for i, vals in enumerate(decrypt_all(self.ctx, cts)):
            for j in np.nonzero(vals >= 1.0)[0]:
                idx = int(j) + i * batch
                if idx < self.num_vectors:
                    out.append(idx)
        return out

    def decrypt_scores(self, cts: Sequence[Ciphertext]) -> np.ndarray:
        return np.concatenate(decrypt_all(self.ctx, cts))


class BaseReceiver(HersReceiver):
    """Approach 1: the query replicated every vector_dim slots into one
    ciphertext."""

    def encrypt_query(self, query: np.ndarray) -> List[Ciphertext]:
        q = normalize(np.asarray(query, dtype=np.float64))
        reps = self.ctx.slots // self.cfg.vector_dim
        return [self.ctx.encrypt(np.tile(q, reps))]


class DiagonalReceiver(BaseReceiver):
    """Approach 5: the single replicated-query ciphertext; HERS decode
    rules."""


class GroteReceiver(BaseReceiver):
    """Approach 2: decodes the group-testing row and column flags."""

    def decrypt_index(self, cts: Sequence[Ciphertext]) -> List[int]:
        ctx = self.ctx
        batch = ctx.slots
        row_len = 2 ** math.ceil(math.log2(batch) / 2)
        col_len = batch // row_len
        n_score = math.ceil(self.num_vectors / batch)
        n_row = math.ceil(n_score / row_len)
        n_col = math.ceil(n_score / col_len)
        if n_row + n_col != len(cts):
            raise ValueError(f"GROTE index: {len(cts)} ciphertexts, expected "
                             f"{n_row} rows + {n_col} columns")
        vals = decrypt_all(ctx, cts)
        row_vals = np.concatenate(vals[:n_row])
        col_vals = np.concatenate(vals[n_row:])
        rows = np.nonzero(row_vals >= 1.0)[0]
        cols = np.nonzero(col_vals >= 1.0)[0]
        out = []
        for r in rows:
            rm = r // col_len
            for c in cols:
                cm = c // row_len
                if rm == cm:
                    idx = int(r) * row_len + int(c) % row_len
                    if idx < self.num_vectors:
                        out.append(idx)
        return out


class BlindReceiver(HersReceiver):
    """Approach 3: the query split into chunks, each replicated across the
    batch; the index decode inverts the compression permutation."""

    def encrypt_query(self, query: np.ndarray) -> List[Ciphertext]:
        cl = self.cfg.chunk_len
        cpv = self.cfg.vector_dim // cl
        q = normalize(np.asarray(query, dtype=np.float64))
        reps = self.ctx.slots // cl
        vals = np.stack([np.tile(q[i * cl : (i + 1) * cl], reps) for i in range(cpv)])
        data = self.ctx.encrypt_batch(vals)
        return [Ciphertext(data[i], self.ctx.fresh_scale) for i in range(cpv)]

    def decrypt_index(self, cts: Sequence[Ciphertext]) -> List[int]:
        batch = self.ctx.slots
        cl = self.cfg.chunk_len
        spb = batch // cl  # scores per batch
        out = []
        for i, vals in enumerate(decrypt_all(self.ctx, cts)):
            for j in np.nonzero(vals >= 1.0)[0]:
                j = int(j)
                idx = i * batch + j // cl + (j % cl) * spb
                if idx < self.num_vectors:
                    out.append(idx)
        return sorted(out)

    def decrypt_scores(self, cts: Sequence[Ciphertext]) -> np.ndarray:
        """Scores in vector order: slot j of ciphertext i holds the score
        of vector i*batch + j//cl + (j%cl)*spb, inverted here."""
        batch = self.ctx.slots
        cl = self.cfg.chunk_len
        spb = batch // cl
        j = np.arange(batch)
        order = j // cl + (j % cl) * spb  # slot -> vector offset
        outs = []
        for vals in decrypt_all(self.ctx, cts):
            inv = np.empty(batch, vals.dtype)
            inv[order] = vals
            outs.append(inv)
        return np.concatenate(outs)


RECEIVERS = {1: BaseReceiver, 2: GroteReceiver, 3: BlindReceiver, 4: HersReceiver,
             5: DiagonalReceiver}


def make_receiver(approach: int, ctx: CkksContext, cfg: MatchConfig,
                  num_vectors: int) -> HersReceiver:
    if approach not in RECEIVERS:
        raise ValueError(f"approach must be 1..5, got {approach}")
    return RECEIVERS[approach](ctx, cfg, num_vectors)

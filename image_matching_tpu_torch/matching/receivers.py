"""Receivers: client-side query encryption and result decryption/decoding
(port of image_matching_tpu/matching/receivers.py, approaches 4 and 5)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from image_matching_tpu.matching.config import MatchConfig
from image_matching_tpu.matching.vector_utils import normalize

from ..ckks.context import CkksContext, Ciphertext


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
        for i, ct in enumerate(cts):
            vals = self.ctx.decrypt(ct)
            for j in np.nonzero(vals >= 1.0)[0]:
                idx = int(j) + i * batch
                if idx < self.num_vectors:
                    out.append(idx)
        return out

    def decrypt_scores(self, cts: Sequence[Ciphertext]) -> np.ndarray:
        return np.concatenate([self.ctx.decrypt(ct) for ct in cts])


class BaseReceiver(HersReceiver):
    """Query replicated every vector_dim slots into one ciphertext."""

    def encrypt_query(self, query: np.ndarray) -> List[Ciphertext]:
        q = normalize(np.asarray(query, dtype=np.float64))
        reps = self.ctx.slots // self.cfg.vector_dim
        return [self.ctx.encrypt(np.tile(q, reps))]


class DiagonalReceiver(BaseReceiver):
    """Approach 5: the single replicated-query ciphertext; HERS decode
    rules."""


def make_receiver(approach: int, ctx: CkksContext, cfg: MatchConfig,
                  num_vectors: int) -> HersReceiver:
    if approach not in (4, 5):
        raise NotImplementedError(f"approach {approach} receiver is not ported yet: ROADMAP A9")
    cls = HersReceiver if approach == 4 else DiagonalReceiver
    return cls(ctx, cfg, num_vectors)

"""End-to-end protocol orchestration: enroller + sender + receiver wired
together (port of image_matching_tpu/matching/protocol.py; approaches 4
and 5, each with an in-memory or a streamed, seed-compressed encrypted
DB)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from image_matching_tpu.ckks.params import SchemeParams, compute_required_depth
from image_matching_tpu.matching.config import MatchConfig

from ..ckks.context import CkksContext, Ciphertext
from . import enrollers, receivers, senders, streaming

APPROACH_NAMES = {1: "Baseline", 2: "GROTE", 3: "Blind", 4: "HERS", 5: "Diagonal"}


@dataclasses.dataclass
class MatchingProtocol:
    approach: int
    ctx: CkksContext
    cfg: MatchConfig
    sender: senders.Sender
    receiver: receivers.HersReceiver

    @staticmethod
    def setup(approach: int, database: np.ndarray, cfg: Optional[MatchConfig] = None,
              params: Optional[SchemeParams] = None, seed: int = 0,
              ctx: Optional[CkksContext] = None, device="cpu",
              streamed: bool = False, **stream_kw) -> "MatchingProtocol":
        """Build the context (depth from computeRequiredDepth) on `device`
        unless one is given, generate keys, enroll the database.  With
        streamed=True the DB is enrolled seed-compressed into a DiagStore
        (approach 5) or a HersStore (approach 4) by
        ``streaming.enroll_diag_streamed`` / ``enroll_hers_streamed``, which
        take ``stream_kw``, and served by the matching streamed sender."""
        if approach in senders.NOT_PORTED:
            raise NotImplementedError(senders.NOT_PORTED[approach])
        if approach not in (4, 5):
            raise ValueError(f"approach must be 1..5, got {approach}")
        cfg = cfg or MatchConfig()
        if ctx is None:
            if params is None:
                depth = compute_required_depth(approach, cfg.comp_depth, cfg.alpha_depth)
                params = SchemeParams.create(mult_depth=depth)
            ctx = CkksContext(params, seed=seed, device=device)
        sender: senders.Sender
        if streamed and approach == 4:
            hstore = streaming.enroll_hers_streamed(ctx, cfg, database, **stream_kw)
            sender = streaming.StreamedHersSender(ctx, cfg, hstore)
        elif streamed:
            store = streaming.enroll_diag_streamed(ctx, cfg, database, **stream_kw)
            sender = streaming.StreamedDiagonalSender(ctx, cfg, store)
        else:
            enroll = enrollers.enroll_hers if approach == 4 else enrollers.enroll_diag
            sender = senders.make_sender(approach, ctx, cfg, enroll(ctx, cfg, database))
        receiver = receivers.make_receiver(approach, ctx, cfg, database.shape[0])
        ctx.gen_power_of_two_rotation_keys()
        ctx.gen_rotation_keys(sender.required_rotations(), force=True)
        return MatchingProtocol(approach, ctx, cfg, sender, receiver)

    def encrypt_query(self, query: np.ndarray) -> List[Ciphertext]:
        return self.receiver.encrypt_query(query)

    def membership(self, query_cts: List[Ciphertext]) -> Ciphertext:
        return self.sender.run_membership(query_cts)

    def index(self, query_cts: List[Ciphertext]) -> List[Ciphertext]:
        return self.sender.run_index(query_cts)

    def decrypt_membership(self, ct: Ciphertext) -> bool:
        return self.receiver.decrypt_membership(ct)

    def decrypt_index(self, cts: List[Ciphertext]) -> List[int]:
        return self.receiver.decrypt_index(cts)

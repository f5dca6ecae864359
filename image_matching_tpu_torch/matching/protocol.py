"""End-to-end protocol orchestration: enroller + sender + receiver wired
together (port of image_matching_tpu/matching/protocol.py): approaches 1-5
with an in-memory encrypted DB, approaches 4 and 5 also with a streamed,
seed-compressed one."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..ckks.context import CkksContext, Ciphertext
from ..ckks.params import SchemeParams, compute_required_depth
from ..utils import spans
from . import enrollers, receivers, senders, streaming
from .config import MatchConfig

APPROACH_NAMES = {1: "Baseline", 2: "GROTE", 3: "Blind", 4: "HERS", 5: "Diagonal"}
# looked up on the module at call time, so a caller may wrap one (timing)
ENROLLERS = {1: "enroll_base", 2: "enroll_base", 3: "enroll_blind", 4: "enroll_hers",
             5: "enroll_diag"}


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
              ctx: Optional[CkksContext] = None, device="cuda",
              streamed: bool = False, **stream_kw) -> "MatchingProtocol":
        """Build the context (depth from computeRequiredDepth) on `device`
        (the card unless the caller asks for the CPU) unless one is given,
        generate keys, enroll the database.  With streamed=True the DB is
        enrolled seed-compressed into a DiagStore (approach 5) or a
        HersStore (approach 4) by ``streaming.enroll_diag_streamed`` /
        ``enroll_hers_streamed``, which take ``stream_kw``, and served by
        the matching streamed sender; approaches 1-3 have no streamed
        store, as in the JAX package."""
        if approach not in senders.SENDERS:
            raise ValueError(f"approach must be 1..5, got {approach}")
        if streamed and approach not in (4, 5):
            raise ValueError("streaming is implemented for approaches 4 (HERS) and 5 (HyDia)")
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
            enroll = getattr(enrollers, ENROLLERS[approach])
            sender = senders.make_sender(approach, ctx, cfg, enroll(ctx, cfg, database))
        receiver = receivers.make_receiver(approach, ctx, cfg, database.shape[0])
        ctx.gen_power_of_two_rotation_keys()
        ctx.gen_rotation_keys(sender.required_rotations(), force=True)
        return MatchingProtocol(approach, ctx, cfg, sender, receiver)

    def encrypt_query(self, query: np.ndarray) -> List[Ciphertext]:
        return self.receiver.encrypt_query(query)

    def _request(self, kind: str, query_cts: List[Ciphertext]):
        """The ``imtpu.<kind>`` span of one served request, with the
        next request id."""
        return spans.span(kind, {"request": next(spans.REQUESTS), "approach": self.approach,
                                 "cts": len(query_cts)})

    def membership(self, query_cts: List[Ciphertext]) -> Ciphertext:
        with self._request("membership", query_cts):
            return self.sender.run_membership(query_cts)

    def index(self, query_cts: List[Ciphertext]) -> List[Ciphertext]:
        with self._request("index", query_cts):
            return self.sender.run_index(query_cts)

    def decrypt_membership(self, ct: Ciphertext) -> bool:
        return self.receiver.decrypt_membership(ct)

    def decrypt_index(self, cts: List[Ciphertext]) -> List[int]:
        return self.receiver.decrypt_index(cts)

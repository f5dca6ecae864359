"""The streamed senders' compare circuit over chunks of scores (C1):
streamed HyDia membership and index residues equal the JAX package's
(its streaming loop compares chunks of IMTPU_COMPARE_CHUNK scores through
its jit segments) and equal the flags of the circuit run on each score
alone, for every chunk size; streamed HERS likewise against the per-score
flags (its JAX parity: tests/test_torch_c3.py).  Ring 512, dim 64,
comparison depth 8, 2 groups in the host tier."""

import os

import pytest

from image_matching_tpu.ckks.context import CkksContext as JCtx
from image_matching_tpu.ckks.params import SchemeParams, compute_required_depth
from image_matching_tpu.matching.config import MatchConfig
from image_matching_tpu.matching.protocol import MatchingProtocol as JProto
from image_matching_tpu.utils import io as dio
from image_matching_tpu_torch.ckks import poly_eval as tpe
from image_matching_tpu_torch.ckks.context import CkksContext as TCtx
from image_matching_tpu_torch.matching import streaming
from image_matching_tpu_torch.matching.protocol import MatchingProtocol

from _torch_parity import assert_same, jax_noise, jax_seeded_noise, port_cfg, port_params

DIM, NVEC = 64, 300  # 2 groups of 256 slots
CFG = MatchConfig(vector_dim=DIM, chunk_len=16, comp_depth=8)
STREAM = dict(streamed=True, resident_budget=0, engine="device")


def _params(approach):
    return SchemeParams.create(ring_dim=512, security="none",
                               mult_depth=compute_required_depth(approach, CFG.comp_depth))


def _port(approach, db):
    params = _params(approach)
    ctx = TCtx(port_params(params), seed=7, device="cpu", noise=jax_noise(params.sigma),
               seeded_noise=jax_seeded_noise(params.sigma))
    return MatchingProtocol.setup(approach, db, port_cfg(CFG), ctx=ctx, **STREAM)


@pytest.fixture(scope="module")
def hydia():
    query, db = dio.gen_dataset(NVEC, DIM, seed=1)
    old = os.environ.get("IMTPU_STORE_DIR")
    os.environ["IMTPU_STORE_DIR"] = ""  # no on-disk store cache
    try:
        jp = JProto.setup(5, db, CFG, ctx=JCtx(_params(5), seed=7), **STREAM)
    finally:
        if old is None:
            del os.environ["IMTPU_STORE_DIR"]
        else:
            os.environ["IMTPU_STORE_DIR"] = old
    tp = _port(5, db)
    return jp, tp, jp.encrypt_query(query), tp.encrypt_query(query)


def _per_score(tp, tq):
    """The flags of the circuit run on each score alone (the dataflow
    before the compare was batched) and their membership."""
    sender = tp.sender
    flags = [tpe.chebyshev_compare(tp.ctx, s, CFG.match_threshold, CFG.comp_depth)
             for s in sender.compute_similarity(tq)]
    return flags, sender._membership_reduce(flags)


def test_streamed_hydia_matches_jax(hydia):
    jp, tp, jq, tq = hydia
    jm, tm = jp.sender.run_membership(jq), tp.sender.run_membership(tq)
    assert_same(jm.data, tm.data)
    assert tm.scale == jm.scale
    ji, ti = jp.sender.run_index(jq), tp.sender.run_index(tq)
    assert len(ji) == len(ti) == 2
    for a, b in zip(ji, ti):
        assert_same(a.data, b.data)
        assert b.scale == a.scale
    assert tp.decrypt_membership(tm) is True and tp.decrypt_index(ti) == [0]


@pytest.mark.parametrize("chunk", ["1", "16"])
def test_streamed_hydia_chunks_equal_per_score(hydia, chunk, monkeypatch):
    """Chunks of 1 (two circuits) and of 16 (one over both scores) give the
    per-score flags and membership."""
    _, tp, _, tq = hydia
    flags, member = _per_score(tp, tq)
    monkeypatch.setenv("IMTPU_COMPARE_CHUNK", chunk)
    for a, b in zip(flags, tp.sender.run_index(tq)):
        assert_same(a.data, b.data)
    assert_same(member.data, tp.sender.run_membership(tq).data)


def test_streamed_hers_equals_per_score():
    query, db = dio.gen_dataset(NVEC, DIM, seed=1)
    tp = _port(4, db)
    tq = tp.encrypt_query(query)
    assert isinstance(tp.sender, streaming.StreamedHersSender)
    flags, member = _per_score(tp, tq)
    for a, b in zip(flags, tp.sender.run_index(tq)):
        assert_same(a.data, b.data)
    tm = tp.sender.run_membership(tq)
    assert_same(member.data, tm.data)
    assert tp.decrypt_membership(tm) is True


def test_compare_in_chunks_asks_for_scores_a_chunk_at_a_time(monkeypatch):
    """The stream is drawn one chunk ahead of the compare and no further:
    each full chunk is compared before the next score is produced (so a
    host-tier group's copy, issued when its predecessor is handed out,
    overlaps the chunk's compare), the remainder at the end, keys kept."""
    events = []

    class Fake:
        def _compare_many(self, scores):
            events.append(("compare", list(scores)))
            return [s * 10 for s in scores]

    def scores():
        for k in range(5):
            events.append(("score", k))
            yield k, k

    monkeypatch.setenv("IMTPU_COMPARE_CHUNK", "2")
    out = streaming.compare_in_chunks(Fake(), scores())
    assert out == [(k, 10 * k) for k in range(5)]
    assert events == [("score", 0), ("score", 1), ("compare", [0, 1]), ("score", 2),
                      ("score", 3), ("compare", [2, 3]), ("score", 4), ("compare", [4])]

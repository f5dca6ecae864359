"""Port parity and end-to-end tests of HERS (approach 4) at
tests/test_matching.py scale: ring 512, dim 64, comparison depth 8.

Bit-exact against the JAX package on the same keys, DB and query: the
enrolled dimension-major DB and the 64-ciphertext query (public-key
encryption with the JAX noise injected), the similarity residues in the
default, faithful_hers and hers_alt_query modes, the streamed HersStore's
groups and the streamed similarity, and the rotation keys after a HERS
setup.  The port alone: membership and index decisions equal to the
plaintext match set, and scores within 1e-4 of the plaintext cosine (the
reference's decode bar: encoding rounds through a float64 FFT and the
scheme adds noise)."""

import os

import numpy as np
import pytest
import torch

from image_matching_tpu.ckks.context import CkksContext as JCtx
from image_matching_tpu.ckks.params import SchemeParams, compute_required_depth
from image_matching_tpu.matching import vector_utils as vu
from image_matching_tpu.matching.config import MatchConfig
from image_matching_tpu.matching.protocol import MatchingProtocol as JProto
from image_matching_tpu.utils import io as dio
from image_matching_tpu_torch.ckks.context import CkksContext as TCtx
from image_matching_tpu_torch.matching import enrollers, receivers, senders, streaming
from image_matching_tpu_torch.matching.protocol import MatchingProtocol
from image_matching_tpu_torch.utils import carry

from _torch_parity import (assert_same, carry_context, jax_noise, jax_seeded_noise, port_cfg,
                           port_params, u32)

DIM, NVEC = 64, 40
DIMS = {"faithful": 16}  # the per-term mode runs dim products, relinearizations
MODES = {
    "default": {},
    "faithful": {"faithful_hers": True},
    "alt": {"hers_alt_query": True},
}
NVEC_STREAM = 300  # 2 groups of 256 slots


def _cfg(mode):
    return MatchConfig(vector_dim=DIMS.get(mode, DIM), chunk_len=16, comp_depth=8, alpha_depth=2,
                       **MODES[mode])


def _params(mode):
    # the alt query's server-side expansion costs one more level
    # (tests/test_faithful_modes.py)
    depth = compute_required_depth(4, 8, 2) + (mode == "alt")
    return SchemeParams.create(ring_dim=512, mult_depth=depth, security="none")


def _tcfg(mode):
    return port_cfg(_cfg(mode))


def _tctx(mode, seed):
    return TCtx(port_params(_params(mode)), seed=seed, device="cpu")


def _port_ctx(params, seed=7):
    return TCtx(port_params(params), seed=seed, device="cpu", noise=jax_noise(params.sigma),
                seeded_noise=jax_seeded_noise(params.sigma))


def _expected(query, db, thr=0.44):
    sims = vu.cosine_similarity(vu.normalize(query)[None, :], vu.normalize(db))
    return sims, sorted(int(i) for i in np.nonzero(sims >= thr)[0])


def _pair(mode, **stream):
    """The same HERS protocol in both packages from one seed, with the
    query encrypted in both."""
    cfg, params = _cfg(mode), _params(mode)
    query, db = dio.gen_dataset(NVEC_STREAM if stream else NVEC, cfg.vector_dim, seed=1)
    old = os.environ.get("IMTPU_STORE_DIR")
    os.environ["IMTPU_STORE_DIR"] = ""  # no on-disk store cache
    try:
        jp = JProto.setup(4, db, cfg, ctx=JCtx(params, seed=7), **stream)
    finally:
        if old is None:
            del os.environ["IMTPU_STORE_DIR"]
        else:
            os.environ["IMTPU_STORE_DIR"] = old
    tp = MatchingProtocol.setup(4, db, port_cfg(cfg), ctx=_port_ctx(params), **stream)
    return jp, tp, jp.encrypt_query(query), tp.encrypt_query(query), query, db


@pytest.fixture(scope="module")
def pairs():
    return {}


def _get(pairs, mode):
    if mode not in pairs:
        pairs[mode] = _pair(mode)
    return pairs[mode]


@pytest.fixture(scope="module")
def spair():
    return _pair("default", streamed=True, resident_budget=0, engine="device")


def test_keys_db_and_query_identical(pairs):
    jp, tp, jq, tq, *_ = _get(pairs, "default")
    assert isinstance(tp.sender, senders.HersSender)
    assert isinstance(tp.receiver, receivers.HersReceiver)
    assert tp.sender.required_rotations() == []
    assert_same(jp.ctx.relin_key, tp.ctx.relin_key)
    assert tp.ctx.rot_keys == jp.ctx.rot_keys
    assert len(tp.ctx._rot_sets) == len(jp.ctx._rot_sets) == 1  # power-of-two keys only
    for (jperm, jk), (tperm, tk) in zip(jp.ctx._rot_sets, tp.ctx._rot_sets):
        np.testing.assert_array_equal(np.asarray(jperm), tperm.numpy())
        assert_same(jk, tk)
    assert tp.sender.db.data.shape == (1, DIM, 2, tp.ctx.Lq, 512)
    assert_same(jp.sender.db.data, tp.sender.db.data)
    assert len(jq) == len(tq) == DIM
    assert_same(np.stack([np.asarray(c.data) for c in jq]), torch.stack([c.data for c in tq]))


@pytest.mark.parametrize("mode", list(MODES))
def test_similarity_bit_exact(pairs, mode):
    jp, tp, jq, tq, *_ = _get(pairs, mode)
    assert len(tq) == (1 if mode == "alt" else tp.cfg.vector_dim)
    jsc = jp.sender.compute_similarity(jq)
    tsc = tp.sender.compute_similarity(tq)
    assert len(jsc) == len(tsc) == 1
    assert_same(jsc[0].data, tsc[0].data)
    assert tsc[0].scale == jsc[0].scale


def test_alt_query_expansion_bit_exact(pairs):
    """The server-side expansion of the replicated query (mask, EvalSum,
    rescale) equals the JAX vmapped expansion ciphertext by ciphertext."""
    from image_matching_tpu.matching import senders as jsenders

    jp, tp, jq, tq, *_ = _get(pairs, "alt")
    jx = jsenders.expand_query_alt(jp.ctx, jp.cfg, jq[0])
    tx = senders.expand_query_alt(tp.ctx, tp.cfg, tq[0])
    assert_same(np.stack([np.asarray(c.data) for c in jx]), torch.stack([c.data for c in tx]))
    assert tx[0].scale == jx[0].scale
    assert_same(jsenders.generate_query_helper(jp.ctx, jp.cfg, jq[0], 5).data,
                senders.generate_query_helper(tp.ctx, tp.cfg, tq[0], 5).data)


@pytest.mark.parametrize("mode", list(MODES))
def test_decisions_and_score_parity(pairs, mode):
    """Membership True, the index set equal to the plaintext match set
    (vector 0 planted), scores within 1e-4 of the plaintext cosine."""
    _, tp, _, tq, query, db = _get(pairs, mode)
    sims, expect = _expected(query, db)
    assert tp.decrypt_membership(tp.membership(tq)) is True
    got = tp.decrypt_index(tp.index(tq))
    assert sorted(got) == expect and 0 in got
    vals = tp.receiver.decrypt_scores(tp.sender.compute_similarity(tq))
    np.testing.assert_allclose(vals[:NVEC], sims, atol=1e-4)


def test_membership_false_when_no_match():
    rng = np.random.default_rng(9)
    query = np.ones(DIM)
    db = rng.integers(-99, 100, size=(NVEC, DIM)).astype(np.float64)  # no plant
    sims, _ = _expected(query, db)
    assert np.all(sims < 0.44 - 0.05), "fixture accidentally contains a match"
    proto = MatchingProtocol.setup(4, db, _tcfg("default"), ctx=_tctx("default", 3))
    assert proto.decrypt_membership(proto.membership(proto.encrypt_query(query))) is False


def test_carried_hers_db_reproduces_jax(pairs):
    """Keys, HersDB and query carried from the JAX objects into a port
    context of another seed give the JAX scores."""
    jp, _, jq, *_ = _get(pairs, "default")
    ctx = _tctx("default", 3)
    carry_context(jp.ctx, ctx)
    d = jp.sender.db
    sender = senders.HersSender(ctx, _tcfg("default"),
                                carry.hers_db(u32(d.data), d.num_vectors, d.scale, device="cpu"))
    scores = sender.compute_similarity([carry.ciphertext(u32(c.data), c.scale, device="cpu")
                                        for c in jq])
    assert_same(jp.sender.compute_similarity(jq)[0].data, scores[0].data)


def test_streamed_store_bit_exact(spair):
    jp, tp, *_ = spair
    js, ts = jp.sender.store, tp.sender.store
    assert isinstance(ts, streaming.HersStore)
    assert ts.num_groups == js.num_groups == 2
    assert ts.resident_count() == 0 and ts.host_count() == 2
    assert (ts.seed, ts.num_vectors, ts.scale) == (js.seed, js.num_vectors, js.scale)
    for a, b in zip(js.groups, ts.groups):
        assert_same(a, b)


def test_rotation_keys_after_streamed_setup(spair):
    jp, tp, *_ = spair
    assert tp.ctx.rot_keys == jp.ctx.rot_keys
    for (_, jk), (_, tk) in zip(jp.ctx._rot_sets, tp.ctx._rot_sets):
        assert_same(jk, tk)


def test_streamed_similarity_bit_exact(spair):
    jp, tp, jq, tq, *_ = spair
    jsim, jscale = jp.sender._similarity_stream(jq)
    scores = tp.sender.compute_similarity(tq)
    assert_same(jsim, torch.stack([s.data for s in scores]))
    assert scores[0].scale == jscale


def test_streamed_equals_in_memory_sender(spair):
    """The in-memory HERS sender over the store's full ciphertexts (c0 and
    the expanded c1) gives the streamed sender's residues."""
    _, tp, _, tq, *_ = spair
    store, ctx = tp.sender.store, tp.ctx
    data = torch.stack([torch.stack([c0, ctx.expand_c1(store.seed, g, DIM, ctx.Lq)], dim=1)
                        for g, c0 in enumerate(store.groups)])
    mem = senders.HersSender(ctx, tp.cfg, enrollers.HersDB(data, store.num_vectors, store.scale))
    for a, b in zip(mem.compute_similarity(tq), tp.sender.compute_similarity(tq)):
        assert_same(a.data, b.data)


def test_streamed_decisions(spair):
    _, tp, _, tq, query, db = spair
    sims, expect = _expected(query, db)
    assert tp.decrypt_membership(tp.membership(tq)) is True
    assert sorted(tp.decrypt_index(tp.index(tq))) == expect
    vals = tp.receiver.decrypt_scores(tp.sender.compute_similarity(tq))
    np.testing.assert_allclose(vals[:NVEC_STREAM], sims, atol=1e-4)


def test_carried_store_serves_jax_similarity(spair):
    jp, _, jq, *_ = spair
    js = jp.sender.store
    ctx = _tctx("default", 3)
    carry_context(jp.ctx, ctx)
    store = carry.hers_store(ctx, [u32(g) for g in js.groups], js.num_vectors, js.scale, js.seed)
    assert store.resident_count() == 2
    sender = streaming.StreamedHersSender(ctx, _tcfg("default"), store)
    scores = sender.compute_similarity([carry.ciphertext(u32(c.data), c.scale, device="cpu")
                                        for c in jq])
    jsim, _ = jp.sender._similarity_stream(jq)
    assert_same(jsim, torch.stack([s.data for s in scores]))


def test_reserve_holds_the_query():
    """The HERS store's device reserve: only the power-of-two keys, but
    room for the dim-ciphertext query and the sender's stacked copy of it
    (two groups' worth each) beside the six groups of working set and one
    compare stack's Chebyshev basis (16 scores of deg/2 ciphertexts)."""
    ctx = _tctx("default", 2)
    gbytes = DIM * ctx.Lq * ctx.n * 4
    kbytes = ctx.dnum * 2 * ctx.Ltot * ctx.n * 4
    basis = 16 * (13 // 2) * 2 * ctx.Lq * ctx.n * 4  # comparison depth 8: degree 13
    assert streaming._reserve_bytes(ctx, _tcfg("default"), 0, 4) == (
        16 * kbytes + 10 * gbytes + basis)

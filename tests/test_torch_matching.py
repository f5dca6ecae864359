"""Port parity and end-to-end tests of the HyDia (approach 5) slice at
tests/test_matching.py scale: ring 512, dim 64, 40 vectors, comparison
depth 8; and the port's own end-to-end runs of approaches 1-3 (their
parity with the JAX package is in test_torch_approaches.py).

Sender outputs (similarity, membership, index residues) are bit-exact
against the JAX sender on the same DB and query (BSGS mode here; the
dim-1 rotation mode is in test_torch_diag_rotations.py).  The only float
tolerance is the reference's decode bar: decrypted scores within 1e-4 of
the plaintext cosine, because encoding and decoding round through a
float64 FFT and the scheme adds noise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.ckks.context import CkksContext as JCtx
from image_matching_tpu.ckks.params import SchemeParams, compute_required_depth
from image_matching_tpu.matching import senders as jsenders
from image_matching_tpu.matching import vector_utils as vu
from image_matching_tpu.matching.config import MatchConfig
from image_matching_tpu.utils import io as dio
from image_matching_tpu_torch.ckks.context import CkksContext as TCtx
from image_matching_tpu_torch.ckks.params import SchemeParams as TParams
from image_matching_tpu_torch.ckks.params import compute_required_depth as t_required_depth
from image_matching_tpu_torch.matching import senders as tsenders
from image_matching_tpu_torch.matching.config import MatchConfig as TConfig
from image_matching_tpu_torch.matching.protocol import MatchingProtocol
from image_matching_tpu_torch.ops import modmath as tmm
from image_matching_tpu_torch.utils import carry

from _torch_parity import assert_same, carry_context, port_cfg, port_params, protocol_pair, u32

DIM, NVEC = 64, 40
CFG = MatchConfig(vector_dim=DIM, chunk_len=16, comp_depth=8, alpha_depth=2)
PARAMS = SchemeParams.create(
    ring_dim=512, mult_depth=compute_required_depth(5, CFG.comp_depth), security="none")
TCFG, TPARAMS = port_cfg(CFG), port_params(PARAMS)  # the port's own copies
RNG = np.random.default_rng(4)


@pytest.fixture(scope="module")
def pair():
    query, db = dio.gen_dataset(NVEC, DIM, seed=1)
    return protocol_pair(CFG, PARAMS, db, query)


@pytest.fixture(scope="module")
def port_ctx():
    return TCtx(TPARAMS, seed=7, device="cpu")


def _expected(query, db):
    sims = vu.cosine_similarity(vu.normalize(query)[None, :], vu.normalize(db))
    return sims, sorted(int(i) for i in np.nonzero(sims >= CFG.match_threshold)[0])


def test_keys_db_and_query_identical(pair):
    jp, tp, jq, tq, _ = pair
    assert_same(jp.ctx.relin_key, tp.ctx.relin_key)
    assert tp.ctx.rot_keys == jp.ctx.rot_keys
    for (_, jk), (_, tk) in zip(jp.ctx._rot_sets, tp.ctx._rot_sets):
        assert_same(jk, tk)
    assert_same(jp.sender.db.data, tp.sender.db.data)
    assert (tp.sender.db.bsgs, tp.sender.db.n1) == (jp.sender.db.bsgs, jp.sender.db.n1) == (True, 8)
    assert_same(jq[0].data, tq[0].data)


def test_similarity_bit_exact(pair):
    jp, tp, jq, tq, (jsim, jscale) = pair
    scores = tp.sender.compute_similarity(tq)
    assert_same(jsim, torch.stack([s.data for s in scores]))
    assert scores[0].scale == jscale


def test_membership_bit_exact(pair):
    jp, tp, jq, tq, _ = pair
    jm, tm = jp.membership(jq), tp.membership(tq)
    assert_same(jm.data, tm.data)
    assert tm.scale == jm.scale
    assert tp.decrypt_membership(tm) is True


def test_index_bit_exact(pair):
    jp, tp, jq, tq, _ = pair
    ji, ti = jp.index(jq), tp.index(tq)
    assert len(ji) == len(ti)
    for a, b in zip(ji, ti):
        assert_same(a.data, b.data)
        assert a.scale == b.scale
    assert tp.decrypt_index(ti) == jp.decrypt_index(ji) == [0]


def test_carried_state_reproduces_jax_similarity(pair):
    """Keys, DiagDB and query carried from the JAX objects into a port
    context of another seed give the JAX scores."""
    jp, _, jq, _, (jsim, _) = pair
    ctx = TCtx(TPARAMS, seed=3, device="cpu")
    carry_context(jp.ctx, ctx)
    d = jp.sender.db
    db = carry.diag_db(u32(d.data), d.num_vectors, d.scale, d.bsgs, d.n1, device="cpu")
    sender = tsenders.DiagonalSender(ctx, TCFG, db)
    scores = sender.compute_similarity([carry.ciphertext(u32(jq[0].data), jq[0].scale,
                                                         device="cpu")])
    assert_same(jsim, torch.stack([s.data for s in scores]))


@pytest.mark.parametrize("blocked", [False, True])
def test_ct_dot_bit_exact(blocked):
    """ct_dot's plain version against the JAX ct_dot, with operands at
    different limb counts (the higher one's top limbs drop)."""
    jctx = JCtx(PARAMS, seed=1)
    tctx = TCtx(TPARAMS, seed=1, device="cpu")
    P = PARAMS.q_primes
    K = 5

    def res(shape, L):
        return np.stack([RNG.integers(0, q, size=shape + (512,)) for q in P[:L]],
                        axis=-2).astype(np.uint32)

    A = res((K, 2), 6)
    B = res((3, K, 2) if blocked else (K, 2), 4)
    got = tsenders.ct_dot(tctx, tmm.to_tensor(A, "cpu"), tmm.to_tensor(B, "cpu"))
    blocks = B if blocked else B[None]
    want = np.stack([np.asarray(jsenders.ct_dot(jctx, jnp.asarray(A), jnp.asarray(b)))
                     for b in blocks])
    assert_same(want if blocked else want[0], got)


@pytest.mark.parametrize("bsgs", [True, False])
def test_end_to_end_port_alone(port_ctx, bsgs):
    """The port on its own (torch.Generator noise): membership True and
    the index set equal to the plaintext match set, holding vector 0."""
    query, db = dio.gen_dataset(NVEC, DIM, seed=2)
    cfg = TConfig(vector_dim=DIM, chunk_len=16, comp_depth=8, use_bsgs=bsgs)
    proto = MatchingProtocol.setup(5, db, cfg, ctx=port_ctx)
    assert proto.sender.db.bsgs is bsgs
    qcts = proto.encrypt_query(query)
    assert proto.decrypt_membership(proto.membership(qcts)) is True
    _, expect = _expected(query, db)
    got = proto.decrypt_index(proto.index(qcts))
    assert sorted(got) == expect and 0 in got


def test_score_parity(port_ctx):
    """Decrypted scores within 1e-4 of the plaintext cosine (the
    reference's bar, float decode)."""
    query, db = dio.gen_dataset(NVEC, DIM, seed=1)
    proto = MatchingProtocol.setup(5, db, TCFG, ctx=port_ctx)
    scores = proto.sender.compute_similarity(proto.encrypt_query(query))
    sims, _ = _expected(query, db)
    vals = proto.receiver.decrypt_scores(scores)
    np.testing.assert_allclose(vals[:NVEC], sims, atol=1e-4)


def test_membership_false_when_no_match(port_ctx):
    rng = np.random.default_rng(9)
    query = np.ones(DIM)
    db = rng.integers(-99, 100, size=(NVEC, DIM)).astype(np.float64)  # no plant
    sims, _ = _expected(query, db)
    assert np.all(sims < CFG.match_threshold - 0.05), "fixture accidentally contains a match"
    proto = MatchingProtocol.setup(5, db, TCFG, ctx=port_ctx)
    assert proto.decrypt_membership(proto.membership(proto.encrypt_query(query))) is False


def test_setup_builds_its_own_context():
    query, db = dio.gen_dataset(8, DIM, seed=5)
    proto = MatchingProtocol.setup(5, db, TCFG, params=TPARAMS, seed=5, device="cpu")
    assert proto.ctx.device == torch.device("cpu") and proto.ctx.seed == 5
    assert proto.decrypt_membership(proto.membership(proto.encrypt_query(query))) is True


@pytest.mark.parametrize("approach", [1, 2, 3])
def test_ported_approaches_end_to_end(approach):
    """Approaches 1-3 on the port alone (torch.Generator noise), each
    setting up its own context at its required depth: the sender and
    receiver of the approach, scores within 1e-4 of the plaintext cosine
    and membership True.  (Their index decisions and parity with the JAX
    package: test_torch_approaches.py.)"""
    cfg = TConfig(vector_dim=DIM, chunk_len=16, comp_depth=8)
    params = TParams.create(
        ring_dim=512, mult_depth=t_required_depth(approach, cfg.comp_depth, cfg.alpha_depth),
        security="none")
    query, db = dio.gen_dataset(NVEC, DIM, seed=2)
    proto = MatchingProtocol.setup(approach, db, cfg, params=params, seed=3, device="cpu")
    assert type(proto.sender) is tsenders.SENDERS[approach]
    assert proto.ctx.params.mult_depth == {1: 11, 2: 16, 3: 10}[approach]
    qcts = proto.encrypt_query(query)
    sims, _ = _expected(query, db)
    vals = proto.receiver.decrypt_scores(proto.sender.compute_similarity(qcts))
    np.testing.assert_allclose(vals[:NVEC], sims, atol=1e-4)
    assert proto.decrypt_membership(proto.membership(qcts)) is True


@pytest.mark.parametrize("approach", [1, 2, 3])
def test_streamed_store_raises(approach):
    """The streamed store serves approaches 4 and 5; the JAX package has
    none for approaches 1-3 either."""
    with pytest.raises(ValueError, match=r"approaches 4 \(HERS\) and 5"):
        MatchingProtocol.setup(approach, np.ones((4, DIM)), TCFG, params=TPARAMS,
                               device="cpu", streamed=True)

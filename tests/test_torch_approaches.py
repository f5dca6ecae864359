"""Port parity of approaches 1-3 (Baseline, GROTE, Blind-Match) at
tests/test_matching.py scale: ring 512, dim 64, chunk_len 16, 40 vectors,
comparison depth 8 (10 for GROTE, whose alpha threshold 0.44^4 needs it).

Both packages set up the same protocol from one seed, each with its own
SchemeParams and MatchConfig of the same fields; the port runs on the CPU
with the JAX package's noise, so keys, DB and query agree bit for bit and
every sender output must equal the JAX sender's residue for residue.  The
only float tolerance is the reference's decode bar: decrypted scores
within 1e-4 of the plaintext cosine.  Each JAX reference is built once per
module.  For Baseline and Blind-Match the JAX side runs its jitted
segments (similarity, membership, index).  GROTE's JAX side runs jitted
up to the compare circuit (the similarity segment, and the alpha-norm
rows and columns in one jit): its depth-10 compare segments take minutes
to compile, the compare circuit is held bit-exact at depth 10 in
test_torch_poly_eval.py and the membership sum in the other two
approaches, and its decisions are held to the plaintext set here."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.ckks.context import Ciphertext as JCt
from image_matching_tpu.ckks.params import SchemeParams, compute_required_depth
from image_matching_tpu.matching import vector_utils as vu
from image_matching_tpu.matching.config import MatchConfig
from image_matching_tpu.utils import io as dio
from image_matching_tpu_torch.ckks.context import CkksContext as TCtx
from image_matching_tpu_torch.matching.protocol import MatchingProtocol
from image_matching_tpu_torch.matching.senders import grote_row_len

from _torch_parity import assert_same, port_cfg, port_params, protocol_pair

DIM, NVEC = 64, 40
APPROACHES = [1, 2, 3]


def _cfg(approach):
    return MatchConfig(vector_dim=DIM, chunk_len=16, comp_depth=10 if approach == 2 else 8,
                       alpha_depth=2)


def _params(approach):
    cfg = _cfg(approach)
    depth = compute_required_depth(approach, cfg.comp_depth, cfg.alpha_depth)
    return SchemeParams.create(ring_dim=512, mult_depth=depth, security="none")


@pytest.fixture(scope="module")
def refs():
    """approach -> both protocols, queries and the JAX outputs, built on
    first use."""
    cache = {}

    def get(approach):
        if approach not in cache:
            query, db = dio.gen_dataset(NVEC, DIM, seed=1)
            jp, tp, jq, tq, (jsim, jscale) = protocol_pair(
                _cfg(approach), _params(approach), db, query, approach=approach)
            r = types.SimpleNamespace(query=query, db=db, jp=jp, tp=tp, jq=jq, tq=tq,
                                      jsim=jsim, jscale=jscale)
            if approach == 2:
                r.jrows, r.jcols = _jax_alpha_norms(jp, jsim, jscale)
            else:
                r.jm, r.ji = jp.membership(jq), jp.index(jq)
            cache[approach] = r
        return cache[approach]

    return get


def _jax_alpha_norms(jp, jsim, scale):
    """The JAX GROTE sender's alpha-norm rows and columns of the scores
    jsim, in one jit (as its index segment computes them)."""
    ctx, sender = jp.ctx, jp.sender
    row_len = grote_row_len(ctx.slots)
    scales = {}

    def fn(state, sdata):
        with ctx.bound_state(state):
            scores = [JCt(sdata[i], scale) for i in range(sdata.shape[0])]
            rows = sender.alpha_norm_rows(scores, row_len)
            cols = sender.alpha_norm_columns(scores, row_len)
            scales.update(rows=rows[0].scale, cols=cols[0].scale)
            return jnp.stack([c.data for c in rows]), jnp.stack([c.data for c in cols])

    rows, cols = jax.jit(fn)(ctx.device_state(), jnp.asarray(jsim))
    return ([JCt(d, scales["rows"]) for d in rows], [JCt(d, scales["cols"]) for d in cols])


def _expected(query, db, thr=0.44):
    sims = vu.cosine_similarity(vu.normalize(query)[None, :], vu.normalize(db))
    return sims, sorted(int(i) for i in np.nonzero(sims >= thr)[0])


@pytest.mark.parametrize("approach", APPROACHES)
def test_keys_db_and_query_identical(refs, approach):
    r = refs(approach)
    assert r.tp.ctx.params == port_params(r.jp.ctx.params)
    assert_same(r.jp.ctx.relin_key, r.tp.ctx.relin_key)
    assert r.tp.ctx.rot_keys == r.jp.ctx.rot_keys
    assert len(r.tp.ctx._rot_sets) == len(r.jp.ctx._rot_sets)
    for (jperm, jk), (tperm, tk) in zip(r.jp.ctx._rot_sets, r.tp.ctx._rot_sets):
        np.testing.assert_array_equal(np.asarray(jperm), tperm.numpy())
        assert_same(jk, tk)
    assert r.tp.sender.required_rotations() == r.jp.sender.required_rotations()
    assert_same(r.jp.sender.db.data, r.tp.sender.db.data)
    assert r.tp.sender.db.scale == r.jp.sender.db.scale
    assert len(r.tq) == len(r.jq)
    for a, b in zip(r.jq, r.tq):
        assert_same(a.data, b.data)


@pytest.mark.parametrize("approach", APPROACHES)
def test_similarity_bit_exact(refs, approach):
    r = refs(approach)
    scores = r.tp.sender.compute_similarity(r.tq)
    assert_same(r.jsim, torch.stack([s.data for s in scores]))
    assert scores[0].scale == r.jscale


@pytest.mark.parametrize("approach", [1, 3])
def test_membership_bit_exact(refs, approach):
    r = refs(approach)
    tm = r.tp.membership(r.tq)
    assert_same(r.jm.data, tm.data)
    assert tm.scale == r.jm.scale
    assert r.tp.decrypt_membership(tm) is True


@pytest.mark.parametrize("approach", [1, 3])
def test_index_bit_exact(refs, approach):
    r = refs(approach)
    ti = r.tp.index(r.tq)
    assert len(ti) == len(r.ji)
    for a, b in zip(r.ji, ti):
        assert_same(a.data, b.data)
        assert a.scale == b.scale
    _, expect = _expected(r.query, r.db)
    assert sorted(r.tp.decrypt_index(ti)) == sorted(r.jp.decrypt_index(r.ji)) == expect
    assert 0 in expect


@pytest.mark.parametrize("part", ["rows", "columns"])
def test_grote_alpha_norms_bit_exact(refs, part):
    """GROTE's index inputs before the compare circuit: the alpha-norm rows
    (merged) and columns (packed by the combine tree)."""
    r = refs(2)
    row_len = grote_row_len(r.tp.ctx.slots)
    scores = r.tp.sender.compute_similarity(r.tq)
    fn = r.tp.sender.alpha_norm_rows if part == "rows" else r.tp.sender.alpha_norm_columns
    got, want = fn(scores, row_len), r.jrows if part == "rows" else r.jcols
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert_same(a.data, b.data)
        assert a.scale == b.scale


def test_grote_decisions(refs):
    """GROTE at depth 10: membership True and the row/column decode equal
    to the plaintext set."""
    r = refs(2)
    assert r.tp.decrypt_membership(r.tp.membership(r.tq)) is True
    got = sorted(r.tp.decrypt_index(r.tp.index(r.tq)))
    assert got == _expected(r.query, r.db)[1] and 0 in got


@pytest.mark.parametrize("approach", APPROACHES)
def test_score_parity(refs, approach):
    """Decrypted scores in vector order (Blind-Match's receiver inverts the
    compression permutation) within 1e-4 of the plaintext cosine."""
    r = refs(approach)
    vals = r.tp.receiver.decrypt_scores(r.tp.sender.compute_similarity(r.tq))
    sims, _ = _expected(r.query, r.db)
    np.testing.assert_allclose(vals[:NVEC], sims, atol=1e-4)


def test_faithful_grote_membership_bit_equal(refs):
    """faithful_grote computes (and discards) the alpha-norm columns during
    membership: the membership ciphertext is the default one, bit for bit."""
    r = refs(2)
    sender = r.tp.sender
    default = sender.run_membership(r.tq)
    sender.cfg, default_cfg = dataclasses.replace(sender.cfg, faithful_grote=True), sender.cfg
    try:
        tm = sender.run_membership(r.tq)
    finally:
        sender.cfg = default_cfg
    assert_same(default.data, tm.data)


def test_port_params_are_its_own():
    """The port's protocol takes its own SchemeParams and MatchConfig."""
    from image_matching_tpu_torch.ckks.params import SchemeParams as TParams
    from image_matching_tpu_torch.matching.config import MatchConfig as TConfig

    p, c = port_params(_params(3)), port_cfg(_cfg(3))
    assert type(p) is TParams and type(c) is TConfig
    query, db = dio.gen_dataset(8, DIM, seed=5)
    proto = MatchingProtocol.setup(3, db, c, ctx=TCtx(p, seed=5, device="cpu"))
    assert proto.decrypt_membership(proto.membership(proto.encrypt_query(query))) is True

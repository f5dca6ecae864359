"""Port parity of HyDia's dim-1 hoisted-rotation mode (use_bsgs=False, the
reference's 511 rotations at dim 512; 63 at this test's dim 64): sender
outputs bit-exact against the JAX sender on the same DB and query, at
tests/test_matching.py scale."""

import pytest
import torch

from image_matching_tpu.ckks.params import SchemeParams, compute_required_depth
from image_matching_tpu.matching.config import MatchConfig
from image_matching_tpu.utils import io as dio

from _torch_parity import assert_same, protocol_pair

DIM, NVEC = 64, 40
CFG = MatchConfig(vector_dim=DIM, chunk_len=16, comp_depth=8, alpha_depth=2, use_bsgs=False)
PARAMS = SchemeParams.create(
    ring_dim=512, mult_depth=compute_required_depth(5, CFG.comp_depth), security="none")


@pytest.fixture(scope="module")
def pair():
    query, db = dio.gen_dataset(NVEC, DIM, seed=3)
    return protocol_pair(CFG, PARAMS, db, query)


def test_rotation_mode_setup_identical(pair):
    jp, tp, jq, tq, _ = pair
    assert tp.sender.db.bsgs is False and tp.sender.db.n1 == 1
    assert tp.sender.required_rotations() == list(range(1, DIM))
    assert tp.ctx.rot_keys == jp.ctx.rot_keys
    assert_same(jp.sender.db.data, tp.sender.db.data)
    assert_same(jq[0].data, tq[0].data)


def test_rotation_mode_similarity_bit_exact(pair):
    _, tp, _, tq, (jsim, jscale) = pair
    scores = tp.sender.compute_similarity(tq)
    assert_same(jsim, torch.stack([s.data for s in scores]))
    assert scores[0].scale == jscale


def test_rotation_mode_membership_and_index_bit_exact(pair):
    jp, tp, jq, tq, _ = pair
    jm, tm = jp.membership(jq), tp.membership(tq)
    assert_same(jm.data, tm.data)
    assert tp.decrypt_membership(tm) is True
    ji, ti = jp.index(jq), tp.index(tq)
    for a, b in zip(ji, ti):
        assert_same(a.data, b.data)
    assert tp.decrypt_index(ti) == [0]

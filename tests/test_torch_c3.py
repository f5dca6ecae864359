"""Port parity of the streamed HERS sender under every combination of
``faithful_hers`` and ``hers_alt_query``: like the JAX package's
StreamedHersSender, the port's stacks the query as given and runs one
contraction, relinearization and rescale per group whatever the flags
say.  With the plain query both packages give the same residues; with the
alt query's single ciphertext the JAX sender cannot contract it against a
group of dim ciphertexts and raises, and so does the port's, with a
ValueError that says why.  Ring 512, dim 64, comparison depth 8; the
in-memory HersSender, which honours both flags in both packages, is held
by tests/test_torch_hers.py."""

import dataclasses
import os

import pytest
import torch

from image_matching_tpu.ckks.context import CkksContext as JCtx
from image_matching_tpu.ckks.params import SchemeParams, compute_required_depth
from image_matching_tpu.matching.config import MatchConfig
from image_matching_tpu.matching.protocol import MatchingProtocol as JProto
from image_matching_tpu.utils import io as dio
from image_matching_tpu_torch.ckks.context import CkksContext as TCtx
from image_matching_tpu_torch.matching import streaming
from image_matching_tpu_torch.matching.protocol import MatchingProtocol

from _torch_parity import assert_same, jax_noise, jax_seeded_noise, port_cfg, port_params

DIM, NVEC = 64, 300  # 2 groups of 256 slots
STREAM = dict(streamed=True, resident_budget=0, engine="device")


def _pair(alt: bool):
    """The streamed HERS protocol in both packages from one seed (the alt
    query's receiver encrypts one replicated ciphertext; its expansion
    would cost one more level), with the query encrypted in both."""
    cfg = MatchConfig(vector_dim=DIM, chunk_len=16, comp_depth=8, hers_alt_query=alt)
    params = SchemeParams.create(ring_dim=512, security="none",
                                 mult_depth=compute_required_depth(4, 8, 2) + alt)
    query, db = dio.gen_dataset(NVEC, DIM, seed=1)
    old = os.environ.get("IMTPU_STORE_DIR")
    os.environ["IMTPU_STORE_DIR"] = ""  # no on-disk store cache
    try:
        jp = JProto.setup(4, db, cfg, ctx=JCtx(params, seed=7), **STREAM)
    finally:
        if old is None:
            del os.environ["IMTPU_STORE_DIR"]
        else:
            os.environ["IMTPU_STORE_DIR"] = old
    tctx = TCtx(port_params(params), seed=7, device="cpu", noise=jax_noise(params.sigma),
                seeded_noise=jax_seeded_noise(params.sigma))
    tp = MatchingProtocol.setup(4, db, port_cfg(cfg), ctx=tctx, **STREAM)
    assert isinstance(tp.sender, streaming.StreamedHersSender)
    return jp, tp, jp.encrypt_query(query), tp.encrypt_query(query)


@pytest.fixture(scope="module")
def pairs():
    return {alt: _pair(alt) for alt in (False, True)}


def _with_faithful(sender, faithful: bool):
    sender.cfg = dataclasses.replace(sender.cfg, faithful_hers=faithful)
    return sender


@pytest.mark.parametrize("faithful", [False, True])
def test_streamed_hers_plain_query_matches_jax(pairs, faithful):
    """hers_alt_query off: the same scores, membership and index flags as
    the JAX streamed sender, with faithful_hers off or on."""
    jp, tp, jq, tq = pairs[False]
    js, ts = _with_faithful(jp.sender, faithful), _with_faithful(tp.sender, faithful)
    jsim, jscale = js._similarity_stream(jq)
    scores = ts.compute_similarity(tq)
    assert_same(jsim, torch.stack([s.data for s in scores]))
    assert scores[0].scale == jscale
    jm, tm = js.run_membership(jq), ts.run_membership(tq)
    assert_same(jm.data, tm.data)
    assert tm.scale == jm.scale
    for a, b in zip(js.run_index(jq), ts.run_index(tq)):
        assert_same(a.data, b.data)
    assert tp.decrypt_membership(tm) is True


@pytest.mark.parametrize("faithful", [False, True])
def test_streamed_hers_alt_query_raises_as_jax(pairs, faithful):
    """hers_alt_query on: the single query ciphertext is not expanded by
    either streamed sender; the JAX contraction fails on its shapes and
    the port refuses it with a ValueError."""
    jp, tp, jq, tq = pairs[True]
    assert len(jq) == len(tq) == 1
    js, ts = _with_faithful(jp.sender, faithful), _with_faithful(tp.sender, faithful)
    with pytest.raises(Exception):
        js._similarity_stream(jq)
    with pytest.raises(ValueError, match="alt query"):
        ts.compute_similarity(tq)
    with pytest.raises(ValueError, match="alt query"):
        ts.run_membership(tq)

"""Port parity: the compare circuit over stacks of scores
(``Sender._compare_many_with``, chunks of ``IMTPU_COMPARE_CHUNK``) equals
the circuit run on each score alone, residue for residue, and equals the
JAX package's batched ``_compare_many`` (its eager vmap) and its jit
``_compare_segments`` on the same stack; the batched residue ops it runs
(add_scalar, the add of unequal component counts, the tensor product)
equal their per-item results.  Ring 512, comparison depth 10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.ckks.context import CkksContext as JCtx
from image_matching_tpu.ckks.params import SchemeParams
from image_matching_tpu.matching.config import MatchConfig
from image_matching_tpu.matching.senders import Sender as JSender
from image_matching_tpu_torch.ckks import poly_eval as tpe
from image_matching_tpu_torch.ckks.context import Ciphertext, CkksContext as TCtx
from image_matching_tpu_torch.matching import senders as tsenders
from image_matching_tpu_torch.utils import carry

from _torch_parity import assert_same, port_cfg, port_params, u32

PARAMS = SchemeParams.create(ring_dim=512, mult_depth=10, security="none")
CFG = MatchConfig(vector_dim=64, comp_depth=10)
THR = CFG.match_threshold
NSCORES = 17


@pytest.fixture(scope="module")
def setup():
    """Both contexts from one seed, NSCORES JAX encryptions carried into
    the port, and each score's flag from the circuit run on it alone."""
    jctx = JCtx(PARAMS, seed=11)
    tctx = TCtx(port_params(PARAMS), seed=11, device="cpu")
    rng = np.random.default_rng(5)
    z = rng.uniform(-1, 1, size=(NSCORES, jctx.slots))
    z[:, :4] = [0.43, 0.45, 0.9, -0.2]
    jcts = [jctx.encrypt(v, scale=jctx.params.scale) for v in z]
    tcts = [carry.ciphertext(u32(c.data), c.scale, device="cpu") for c in jcts]
    single = [tpe.chebyshev_compare(tctx, c, THR, CFG.comp_depth) for c in tcts]
    return jctx, tctx, jcts, tcts, single


def _port_sender(tctx):
    return tsenders.Sender(tctx, port_cfg(CFG), 0)


@pytest.mark.parametrize("B", [1, 3, 16, 17])
def test_batched_flags_equal_per_score(setup, B):
    """Stacks of B scores (17: one stack of 16 and one of 1) give each
    score's own flag, at its scale."""
    _, tctx, _, tcts, single = setup
    got = _port_sender(tctx)._compare_many(tcts[:B])
    assert len(got) == B
    for g, want in zip(got, single[:B]):
        assert_same(want.data, g.data)
        assert g.scale == want.scale


def test_compare_chunk_knob(setup, monkeypatch):
    """IMTPU_COMPARE_CHUNK sets the stack size: 3 scores in stacks of 2
    take two circuits (a stack of 2, then 1) and still equal
    the per-score flags."""
    _, tctx, _, tcts, single = setup
    monkeypatch.setenv("IMTPU_COMPARE_CHUNK", "2")
    assert tsenders.compare_chunk() == 2
    sender = _port_sender(tctx)
    stacks = []
    real = tsenders.Sender._compare_stack
    monkeypatch.setattr(tsenders.Sender, "_compare_stack",
                        lambda self, s, thr: stacks.append(len(s)) or real(self, s, thr))
    got = sender._compare_many(tcts[:3])
    assert stacks == [2, 1]
    for g, want in zip(got, single[:3]):
        assert_same(want.data, g.data)


def test_stack_of_mixed_shapes_raises(setup):
    _, tctx, _, tcts, _ = setup
    low = Ciphertext(tcts[1].data[:, :-1], tcts[1].scale)
    with pytest.raises(ValueError):
        _port_sender(tctx)._compare_many([tcts[0], low])


def test_batched_flags_equal_jax_compare_many(setup):
    """The JAX package's _compare_many (one vmap over the stack, run
    eagerly as its tests run it) on the same 3 scores."""
    jctx, tctx, jcts, tcts, _ = setup
    want = JSender(jctx, CFG, 0)._compare_many(jcts[:3])
    got = _port_sender(tctx)._compare_many(tcts[:3])
    for w, g in zip(want, got):
        assert_same(w.data, g.data)
        assert g.scale == w.scale


def test_batched_flags_equal_jax_compare_segments(setup):
    """The JAX package's jit segments (basis, series, f4 over the stack)
    on the same 3 scores."""
    jctx, tctx, jcts, tcts, _ = setup
    sdata = jnp.stack([c.data for c in jcts[:3]])
    fstack, fscale = JSender(jctx, CFG, 0)._compare_segments(sdata, jcts[0].scale, THR)
    got = _port_sender(tctx)._compare_many(tcts[:3])
    assert_same(np.asarray(fstack), torch.stack([g.data for g in got]))
    assert got[0].scale == fscale


def test_batched_residue_ops_equal_per_item(setup):
    """add_scalar (head of one component), the add of a 3-component and a
    2-component ciphertext (head of two), and the tensor product and
    square over a batch equal the same ops item by item."""
    _, tctx, _, tcts, _ = setup
    x = Ciphertext(torch.stack([c.data for c in tcts[:3]]), tcts[0].scale)
    y = Ciphertext(torch.stack([c.data for c in tcts[3:6]]), tcts[3].scale)
    prod = tctx.mul(x, y)
    assert prod.data.shape[:2] == (3, 3)
    for i in range(3):
        xi, yi = Ciphertext(x.data[i], x.scale), Ciphertext(y.data[i], y.scale)
        assert_same(tctx.mul(xi, yi).data, prod.data[i])
        assert_same(tctx.square(xi).data, tctx.square(x).data[i])
    y2 = Ciphertext(y.data, prod.scale)  # a 2-component operand at the product's scale
    batched = {"add_scalar": tctx.add_scalar(x, -0.75), "add3+2": tctx.add(prod, y2),
               "add2+3": tctx.add(y2, prod)}
    for i in range(3):
        xi, yi = Ciphertext(x.data[i], x.scale), Ciphertext(y2.data[i], y2.scale)
        pi = Ciphertext(prod.data[i], prod.scale)
        assert_same(tctx.add_scalar(xi, -0.75).data, batched["add_scalar"].data[i])
        assert_same(tctx.add(pi, yi).data, batched["add3+2"].data[i])
        assert_same(tctx.add(yi, pi).data, batched["add2+3"].data[i])

"""Port parity of slot packing and the rotations it rests on: binary_rotate,
rotate_any, rotate_rows_binary, mul_scalar_int, merge_single,
merge_ciphers (with _tree_pack's zero-row padding) and compress_ciphers,
bit-exact against the JAX functions on the same input ciphertexts and
keys (JAX ciphertexts carried into the port; both contexts from one
seed).  Ring 512 (256 slots), dimension 64 for the merges, 16 for the
compression."""

import jax
import numpy as np
import pytest
import torch

from image_matching_tpu.ckks.context import Ciphertext as JCt
from image_matching_tpu.ckks.context import CkksContext as JCtx
from image_matching_tpu.ckks.params import SchemeParams
from image_matching_tpu.matching import packing as jpacking
from image_matching_tpu_torch.ckks.context import Ciphertext as TCt
from image_matching_tpu_torch.ckks.context import CkksContext as TCtx
from image_matching_tpu_torch.matching import packing as tpacking
from image_matching_tpu_torch.utils import carry

from _torch_parity import assert_same, port_params, u32

PARAMS = SchemeParams.create(ring_dim=512, mult_depth=4, security="none")
DIM = 64
RNG = np.random.default_rng(23)


@pytest.fixture(scope="module")
def ctxs():
    """Both contexts with the power-of-two keys and the merge chain's
    direct keys, in the protocol's order."""
    jctx = JCtx(PARAMS, seed=3)
    tctx = TCtx(port_params(PARAMS), seed=3, device="cpu")
    for c in (jctx, tctx):
        c.gen_power_of_two_rotation_keys()
        c.gen_rotation_keys(jpacking.merge_chain_rotations(c.slots, DIM), force=True)
    assert_same(jctx.relin_key, tctx.relin_key)
    return jctx, tctx


@pytest.fixture(scope="module")
def cts(ctxs):
    """Twenty fresh JAX ciphertexts and their port copies."""
    jctx, _ = ctxs
    jdata = jctx.encrypt_batch(RNG.uniform(-1, 1, size=(20, jctx.slots)))
    jc = [JCt(jdata[i], jctx.fresh_scale) for i in range(20)]
    return jc, [carry.ciphertext(u32(c.data), c.scale, device="cpu") for c in jc]


def _same(j, t):
    assert_same(j.data, t.data)
    assert j.scale == t.scale


@pytest.mark.parametrize("r", [5, -37, 100, 255])
def test_binary_rotate_bit_exact(ctxs, cts, r):
    (jctx, tctx), (jc, tc) = ctxs, cts
    _same(jctx.binary_rotate(jc[0], r), tctx.binary_rotate(tc[0], r))


@pytest.mark.parametrize("r", [63, 126, 7, -3])
def test_rotate_any_bit_exact(ctxs, cts, r):
    """A direct key (the merge chain's 63 and 126) or the binary steps."""
    (jctx, tctx), (jc, tc) = ctxs, cts
    _same(jctx.rotate_any(jc[1], r), tctx.rotate_any(tc[1], r))


def test_rotate_rows_binary_bit_exact(ctxs, cts):
    """Rows rotated by their own amounts, a row of amount 0 passing
    through every stage."""
    (jctx, tctx), (jc, tc) = ctxs, cts
    rots = [0, 5, -3, 128]
    jout = jctx.rotate_rows_binary(np.stack([np.asarray(c.data) for c in jc[:4]]), rots)
    tout = tctx.rotate_rows_binary(torch.stack([c.data for c in tc[:4]]), rots)
    assert_same(jout, tout)
    assert_same(tout[0], tc[0].data)


def test_batched_rotate_equals_rotate(ctxs, cts):
    """One amount over a stack (one shared key) equals each row alone."""
    _, tctx = ctxs
    _, tc = cts
    batch = tctx.rotate(TCt(torch.stack([c.data for c in tc[:3]]), tc[0].scale), 8)
    for i in range(3):
        assert_same(batch.data[i], tctx.rotate(tc[i], 8).data)


def test_mul_scalar_int_bit_exact(ctxs, cts):
    (jctx, tctx), (jc, tc) = ctxs, cts
    _same(jctx.mul_scalar_int(jc[2], -7), tctx.mul_scalar_int(tc[2], -7))


@pytest.mark.parametrize("defer", [False, True])
def test_merge_single_bit_exact(ctxs, cts, defer):
    (jctx, tctx), (jc, tc) = ctxs, cts
    jo, to = (jpacking.merge_single(jctx, jc[3], DIM, defer=defer),
              tpacking.merge_single(tctx, tc[3], DIM, defer=defer))
    if defer:
        (jo, jp), (to, tp) = jo, to
        assert jp == tp == 2
    _same(jo, to)


def test_merge_ciphers_bit_exact(ctxs, cts):
    """Six ciphertexts of 4 scores each into one output: the combine tree
    pads 58 zero rows.  The JAX side runs in one jit (eagerly its vmapped
    chains compile op by op)."""
    (jctx, tctx), (jc, tc) = ctxs, cts
    scale = {}

    def merge(datas):
        out = jpacking.merge_ciphers(jctx, [JCt(d, jc[0].scale) for d in datas], DIM)
        scale["out"] = out[0].scale
        return [o.data for o in out]

    jo = jax.jit(merge)([c.data for c in jc[:6]])
    to = tpacking.merge_ciphers(tctx, tc[:6], DIM)
    assert len(jo) == len(to) == 1
    assert_same(jo[0], to[0].data)
    assert to[0].scale == scale["out"]


def test_compress_ciphers_bit_exact(ctxs, cts):
    """Twenty ciphertexts into two outputs (dimension 16): bit stages of
    per-row amounts, then the row sums."""
    (jctx, tctx), (jc, tc) = ctxs, cts
    jo, to = jpacking.compress_ciphers(jctx, jc, 16), tpacking.compress_ciphers(tctx, tc, 16)
    assert len(jo) == len(to) == 2
    for a, b in zip(jo, to):
        _same(a, b)


def test_tree_pack_rejects_non_power_of_two_step(ctxs, cts):
    _, tctx = ctxs
    _, tc = cts
    with pytest.raises(ValueError, match="power of two"):
        tpacking._tree_pack(tctx, tc[:2], 12, 1)

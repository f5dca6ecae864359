"""Port parity: key generation, encryption and the leveled evaluator with
hybrid key switching (B6-B12), bit-exact against
image_matching_tpu.ckks.context on identical keys and ciphertexts.

Both contexts are built from one seed, so their numpy key draws agree; the
port's encryption takes the JAX package's noise through its `noise` hook.
Evaluator inputs are JAX ciphertexts carried over with utils/carry.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.ckks.context import CkksContext as JCtx
from image_matching_tpu.ckks.params import SchemeParams
from image_matching_tpu_torch.ckks.context import CkksContext as TCtx
from image_matching_tpu_torch.ops import modmath as tmm
from image_matching_tpu_torch.utils import carry

from _torch_parity import assert_same, carry_context, jax_noise, port_params, u32

PARAMS = SchemeParams.create(ring_dim=512, mult_depth=6, security="none")
TPARAMS = port_params(PARAMS)  # the port's own copy
# rotations 1 and 2 get a second key (force=True) in a later set: selection
# rules decide which key a rotation uses, and the keys of the two sets differ
EXTRA_ROTS = [1, 2, 3, 5, 7]
RNG = np.random.default_rng(8)


@pytest.fixture(scope="module")
def ctxs():
    jctx = JCtx(PARAMS, seed=42)
    tctx = TCtx(TPARAMS, seed=42, device="cpu", noise=jax_noise(PARAMS.sigma))
    for c in (jctx, tctx):
        c.gen_power_of_two_rotation_keys()
        c.gen_rotation_keys(EXTRA_ROTS, force=True)
    return jctx, tctx


@pytest.fixture(scope="module")
def cts(ctxs):
    """Two fresh JAX ciphertexts and their port copies."""
    jctx, _ = ctxs
    out = []
    for _ in range(2):
        jc = jctx.encrypt(RNG.uniform(-1, 1, size=jctx.slots))
        out.append((jc, carry.ciphertext(u32(jc.data), jc.scale, device="cpu")))
    return out


def _same_ct(jc, tc):
    assert_same(jc.data, tc.data)
    assert jc.scale == tc.scale


def test_keygen_identical(ctxs):
    jctx, tctx = ctxs
    for name in ("s_eval", "pk_b", "pk_a", "relin_key"):
        assert_same(getattr(jctx, name), getattr(tctx, name))
    assert len(jctx._rot_sets) == len(tctx._rot_sets) == 2
    for (jp, jk), (tp, tk) in zip(jctx._rot_sets, tctx._rot_sets):
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        assert_same(jk, tk)
    assert tctx.rot_keys == jctx.rot_keys
    assert tctx._pow2_set_idx == jctx._pow2_set_idx
    assert tctx.groups == jctx.groups


@pytest.mark.parametrize("limbs,scale", [(None, None), (4, 2.0 ** 26)])
def test_encrypt_with_jax_noise_bit_exact(ctxs, limbs, scale):
    jctx, tctx = ctxs
    jctx._rng = np.random.default_rng(99)
    tctx._rng = np.random.default_rng(99)
    vals = RNG.uniform(-1, 1, size=(3, jctx.slots))
    assert_same(jctx.encrypt_batch(vals, limbs, scale), tctx.encrypt_batch(vals, limbs, scale))


def test_encrypt_default_noise_decrypts(ctxs):
    """Without the hook the noise comes from a torch.Generator: not the JAX
    bits, but a valid encryption that decrypts to the message."""
    _, tctx = ctxs
    z = RNG.uniform(-1, 1, size=tctx.slots)
    ctx = TCtx(TPARAMS, seed=42, device="cpu")
    np.testing.assert_allclose(ctx.decrypt(ctx.encrypt(z)), z, atol=1e-5)


def test_decrypt_identical(ctxs, cts):
    jctx, tctx = ctxs
    jc, tc = cts[0]
    np.testing.assert_array_equal(tctx.decrypt(tc), jctx.decrypt(jc))


@pytest.fixture(scope="module")
def production_chain():
    """Both contexts over the production limb structure (14 q limbs in
    digits of 5, 6 special) at ring 512: the K3 shapes 5->15 and 6->14."""
    p = SchemeParams.create(ring_dim=512, mult_depth=11, security="none")
    return JCtx(p, seed=1), TCtx(port_params(p), seed=1, device="cpu")


@pytest.mark.parametrize("chain", ["test", "production"])
@pytest.mark.parametrize("which", ["digit", "moddown"])
def test_fbc_bit_exact(request, chain, which):
    """The float32 rounding of v must match XLA's on every coefficient:
    256K random coefficients per conversion."""
    jctx, tctx = request.getfixturevalue("ctxs" if chain == "test" else "production_chain")
    if which == "digit":
        src = tuple(jctx.groups[0])
        dst = tuple(i for i in jctx.ext_limbs(jctx.Lq) if i not in src)
    else:
        src, dst = jctx.sp_limbs(), jctx.q_limbs(jctx.Lq)
    x = np.stack([RNG.integers(0, jctx.all_primes[i], size=(512, jctx.n)) for i in src],
                 axis=1).astype(np.uint32)
    assert_same(jctx._fbc(jnp.asarray(x), src, dst), tctx._fbc(tmm.to_tensor(x, "cpu"), src, dst))


@pytest.mark.parametrize("l", [PARAMS.num_limbs, 4])
def test_decompose_and_moddown_bit_exact(ctxs, cts, l):
    jctx, tctx = ctxs
    jc, tc = cts[0]
    jd = jctx._decompose_extended(jc.data[1, :l], l)
    td = tctx._decompose_extended(tc.data[1, :l], l)
    assert_same(jd, td)
    assert_same(jctx._moddown(jd[0], l), tctx._moddown(td[0], l))


@pytest.mark.parametrize("ncomp", [2, 3])
def test_rescale_bit_exact(ctxs, cts, ncomp):
    jctx, tctx = ctxs
    (ja, ta), (jb, tb) = cts
    if ncomp == 3:
        ja, ta = jctx.mul(ja, jb), tctx.mul(ta, tb)
    _same_ct(jctx.rescale(ja), tctx.rescale(ta))


def test_mul_relinearize_bit_exact(ctxs, cts):
    jctx, tctx = ctxs
    (ja, ta), (jb, tb) = cts
    _same_ct(jctx.relinearize(jctx.mul(ja, jb)), tctx.relinearize(tctx.mul(ta, tb)))
    _same_ct(jctx.relinearize(jctx.square(ja)), tctx.relinearize(tctx.square(ta)))


def test_basic_ops_bit_exact(ctxs, cts):
    jctx, tctx = ctxs
    (ja, ta), (jb, tb) = cts
    _same_ct(jctx.add(ja, jb), tctx.add(ta, tb))
    _same_ct(jctx.sub(ja, jb), tctx.sub(ta, tb))
    _same_ct(jctx.neg(ja), tctx.neg(ta))
    _same_ct(jctx.add_scalar(ja, -0.37), tctx.add_scalar(ta, -0.37))
    _same_ct(jctx.mul_scalar(ja, 1.7, 2.0 ** 25), tctx.mul_scalar(ta, 1.7, 2.0 ** 25))
    _same_ct(jctx.drop_to(ja, 3), tctx.drop_to(ta, 3))
    # 3-component + 2-component at one scale
    _same_ct(jctx.add(jctx.mul(ja, jb), jctx.mul_scalar(jb, 1.0, jb.scale)),
             tctx.add(tctx.mul(ta, tb), tctx.mul_scalar(tb, 1.0, tb.scale)))
    mask = RNG.uniform(-1, 1, size=jctx.slots)
    jpt = jctx.encode(mask, 5, 2.0 ** 27)
    tpt = tctx.encode(mask, 5, 2.0 ** 27)
    assert_same(jpt.data, tpt.data)
    _same_ct(jctx.mul_plain(ja, jpt), tctx.mul_plain(ta, tpt))
    tgt_l, tgt_s = ja.limbs - 2, jctx.params.scale
    _same_ct(jctx.align_to(ja, tgt_l, tgt_s), tctx.align_to(ta, tgt_l, tgt_s))
    _same_ct(jctx.rescale_score(jctx.mul(ja, jb)), tctx.rescale_score(tctx.mul(ta, tb)))


@pytest.mark.parametrize("r", [1, 3, -4])
def test_rotate_bit_exact(ctxs, cts, r):
    """r=1 exists in two key sets: the first set's key is used."""
    jctx, tctx = ctxs
    (ja, ta), _ = cts
    _same_ct(jctx.rotate(ja, r), tctx.rotate(ta, r))
    jd, td = jctx.hoisted_precompute(ja), tctx.hoisted_precompute(ta)
    _same_ct(jctx.hoisted_rotate(ja, jd, r), tctx.hoisted_rotate(ta, td, r))


def test_hoisted_rotate_stack_bit_exact(ctxs, cts):
    """The batch [1, 2, 3, 5] shares only the forced set: the lowest common
    set holding all of them supplies every key."""
    jctx, tctx = ctxs
    (ja, ta), _ = cts
    jd, td = jctx.hoisted_precompute(ja), tctx.hoisted_precompute(ta)
    rots = [1, 2, 3, 5]
    assert_same(jctx.hoisted_rotate_stack(ja, jd, rots), tctx.hoisted_rotate_stack(ta, td, rots))


def test_rotate_stack_bit_exact(ctxs, cts):
    jctx, tctx = ctxs
    (ja, ta), (jb, tb) = cts
    jdata = jnp.stack([ja.data, jb.data, ja.data])
    tdata = torch.stack([ta.data, tb.data, ta.data])
    rots = [2, 7, 3]
    assert_same(jctx.rotate_stack(jdata, rots, ja.scale), tctx.rotate_stack(tdata, rots, ta.scale))


def test_relinearize_stack_matches_single(ctxs, cts):
    jctx, tctx = ctxs
    (ja, ta), (jb, tb) = cts
    prods = [tctx.mul(ta, tb), tctx.square(ta)]
    stack = tctx.relinearize_stack(torch.stack([p.data for p in prods]))
    for i, (jp, tp) in enumerate([(jctx.mul(ja, jb), prods[0]), (jctx.square(ja), prods[1])]):
        assert_same(jctx.relinearize(jp).data, stack[i])


@pytest.mark.parametrize("m", [2, 16, 256])
def test_eval_sum_bit_exact(ctxs, cts, m):
    jctx, tctx = ctxs
    (ja, ta), _ = cts
    _same_ct(jctx.eval_sum(ja, m), tctx.eval_sum(ta, m))


def test_carried_keys_reproduce_jax(ctxs, cts):
    """A port context drawn from another seed, given the JAX keys through
    utils/carry.py, computes the JAX results."""
    jctx, _ = ctxs
    other = TCtx(TPARAMS, seed=5, device="cpu")
    assert not torch.equal(other.s_eval, tmm.to_tensor(u32(jctx.s_eval), "cpu"))
    carry_context(jctx, other)
    (ja, ta), (jb, tb) = cts
    _same_ct(jctx.relinearize(jctx.mul(ja, jb)), other.relinearize(other.mul(ta, tb)))
    _same_ct(jctx.rotate(ja, 5), other.rotate(ta, 5))
    np.testing.assert_array_equal(other._s_eval_std, jctx._s_eval_std)
    with pytest.raises(ValueError):
        carry.load_context_state(other, s_eval=u32(jctx.s_eval)[:2], pk_b=u32(jctx.pk_b),
                                 pk_a=u32(jctx.pk_a), relin_key=u32(jctx.relin_key))

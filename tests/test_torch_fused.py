"""Port parity of the fused passes K7-K10 (B7, B9-B12): each plain version
bit-exact against the JAX function it replaces, over the production limb
structure (14 q limbs in digits of 5, 6 special) at ring 512, at the top
level and below it, down to a level where fewer digits than dnum are live.

Plain versions: rescale_plain (B10), moddown_plain with its centred
conversion and its rotation addend (B9, B3's c0 gather), decompose_plain
with the automorphism gathered on the way in (B7, B3's c1 gather),
tensor_plain (B11 mul/square), decrypt_plain (B11 decrypt) and
pk_encrypt_plain (B12, with the JAX noise of the same key).  Inputs are
uniform residues from a numpy seed: every pass is integer arithmetic that
is defined on any residues.  The rotations built on the fused passes are
held to the JAX context below the top level too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.ckks.context import Ciphertext as JCt
from image_matching_tpu.ckks.context import CkksContext as JCtx
from image_matching_tpu.ckks.params import SchemeParams
from image_matching_tpu.ops import modmath as jmm
from image_matching_tpu_torch.ckks import context as tc
from image_matching_tpu_torch.ckks.context import CkksContext as TCtx
from image_matching_tpu_torch.ops import kernels
from image_matching_tpu_torch.ops import modmath as tmm
from image_matching_tpu_torch.utils import carry

from _torch_parity import _jax_noise, assert_same, port_params

PARAMS = SchemeParams.create(ring_dim=512, mult_depth=11, security="none")
LEVELS = [14, 9, 4]  # 3, 2 and 1 live digits of dnum 3
RNG = np.random.default_rng(11)


@pytest.fixture(scope="module")
def ctxs():
    jctx, tctx = JCtx(PARAMS, seed=1), TCtx(port_params(PARAMS), seed=1, device="cpu")
    for c in (jctx, tctx):
        c.gen_power_of_two_rotation_keys()
        c.gen_rotation_keys([3, 5, 7], force=True)
    assert jctx.Lq == 14 and jctx.dnum == 3
    return jctx, tctx


def _res(ctx, shape, limbs):
    """Uniform residues [*shape, len(limbs), N] over the given limbs."""
    return np.stack([RNG.integers(0, ctx.all_primes[i], size=shape + (ctx.n,))
                     for i in limbs], axis=-2).astype(np.uint32)


def _t(x):
    return tmm.to_tensor(x, "cpu")


def test_levels_cover_fewer_digits(ctxs):
    _, tctx = ctxs
    assert [len(tctx._digits(l)) for l in LEVELS] == [3, 2, 1]


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("l", LEVELS)
def test_rescale_plain(ctxs, l, k):
    jctx, tctx = ctxs
    x = _res(jctx, (k,), range(l))
    want = jctx.rescale(JCt(jnp.asarray(x), 2.0 ** 40))
    assert_same(want.data, tc.rescale_plain(tctx, _t(x)))
    got = tctx.rescale(tc.Ciphertext(_t(x), 2.0 ** 40))
    assert got.scale == want.scale


@pytest.mark.parametrize("l", LEVELS)
def test_moddown_plain(ctxs, l):
    jctx, tctx = ctxs
    comp = _res(jctx, (), jctx.ext_limbs(l))
    assert_same(jctx._moddown(jnp.asarray(comp), l), tc.moddown_plain(tctx, _t(comp), l))


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("l", LEVELS)
def test_moddown_plain_rotation_addend(ctxs, l, shared):
    """The addend of a rotation: c0 gathered through each row's
    automorphism, added to component 0 only (the JAX vmapped rotation
    bodies: take, then mod_add)."""
    jctx, tctx = ctxs
    R = 3
    comp = _res(jctx, (R, 2), jctx.ext_limbs(l))
    c0 = _res(jctx, (1 if shared else R,), range(l))
    perms = np.stack([jctx.plan.auto_perm(jctx.rotation_galois(r)) for r in (1, 3, 5)])
    got = tc.moddown_plain(tctx, _t(comp), l, _t(c0)[:, None],
                           torch.from_numpy(perms))
    q, _ = jctx._qrow(jctx.q_limbs(l))
    for r in range(R):
        d0 = jctx._moddown(jnp.asarray(comp[r, 0]), l)
        d1 = jctx._moddown(jnp.asarray(comp[r, 1]), l)
        rot = jnp.take(jnp.asarray(c0[0 if shared else r]), perms[r], axis=-1)
        assert_same(jmm.mod_add(rot, d0, q), got[r, 0])
        assert_same(d1, got[r, 1])


@pytest.mark.parametrize("l", LEVELS)
def test_moddown_plain_relin_addend(ctxs, l):
    """Both components of the addend: c + d of a relinearization."""
    jctx, tctx = ctxs
    comp = _res(jctx, (1, 2), jctx.ext_limbs(l))
    x = _res(jctx, (1, 2), range(l))
    got = tc.moddown_plain(tctx, _t(comp), l, _t(x))
    q, _ = jctx._qrow(jctx.q_limbs(l))
    for c in range(2):
        assert_same(jmm.mod_add(jnp.asarray(x[0, c]), jctx._moddown(jnp.asarray(comp[0, c]), l),
                                q), got[0, c])


@pytest.mark.parametrize("perm", [False, True])
@pytest.mark.parametrize("l", LEVELS)
def test_decompose_plain(ctxs, l, perm):
    jctx, tctx = ctxs
    poly = _res(jctx, (), range(l))
    p = jctx.plan.auto_perm(jctx.rotation_galois(7)) if perm else None
    src = jnp.take(jnp.asarray(poly), p, axis=-1) if perm else jnp.asarray(poly)
    got = tc.decompose_plain(tctx, _t(poly), l, None if p is None else torch.from_numpy(p)[None])
    want = jctx._decompose_extended(src, l)
    assert want.shape[0] == len(tctx._digits(l))
    assert_same(want, got)


def test_decompose_plain_per_row_permutations(ctxs):
    """A stack [R, l, N] with one automorphism per row (rotate_stack)."""
    jctx, tctx = ctxs
    l = 9
    polys = _res(jctx, (3,), range(l))
    perms = np.stack([jctx.plan.auto_perm(jctx.rotation_galois(r)) for r in (2, 5, 3)])
    got = tc.decompose_plain(tctx, _t(polys), l, torch.from_numpy(perms))
    for r in range(3):
        assert_same(jctx._decompose_extended(jnp.take(jnp.asarray(polys[r]), perms[r], axis=-1),
                                             l), got[r])


@pytest.mark.parametrize("l", LEVELS)
def test_tensor_plain(ctxs, l):
    """mul with the higher operand's top limbs dropped, and square."""
    jctx, tctx = ctxs
    x = _res(jctx, (2,), range(l))
    y = _res(jctx, (2,), range(min(l + 2, jctx.Lq)))
    jx, jy = JCt(jnp.asarray(x), 2.0 ** 30), JCt(jnp.asarray(y), 2.0 ** 31)
    assert_same(jctx.mul(jx, jy).data, tc.tensor_plain(tctx, _t(x), _t(y)))
    assert_same(jctx.mul(jy, jx).data, tc.tensor_plain(tctx, _t(y), _t(x)))
    assert_same(jctx.square(jx).data, tc.tensor_plain(tctx, _t(x)))
    got = tctx.mul(tc.Ciphertext(_t(x), 2.0 ** 30), tc.Ciphertext(_t(y), 2.0 ** 31))
    assert got.scale == 2.0 ** 61 and got.limbs == l


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("l", LEVELS)
def test_decrypt_plain(ctxs, l, k):
    jctx, tctx = ctxs
    data = _res(jctx, (k,), range(l))
    assert_same(jctx._decrypt_impl(jnp.asarray(data)), tc.decrypt_plain(tctx, _t(data)))


@pytest.mark.parametrize("l", LEVELS)
def test_pk_encrypt_plain(ctxs, l):
    """The JAX _encrypt_impl draws its noise from a key; the plain version
    takes the same draws."""
    jctx, tctx = ctxs
    B = 3
    m = _res(jctx, (B,), range(l))
    key = jax.random.key(1234 + l)
    want = jctx._encrypt_impl(jnp.asarray(m), key, l)
    v, e0, e1 = (torch.from_numpy(np.asarray(a).astype(np.int64))
                 for a in _jax_noise(key, B, jctx.n, float(PARAMS.sigma)))
    assert_same(want, tc.pk_encrypt_plain(tctx, _t(m), v, e0, e1, l))
    assert_same(want, tctx._encrypt_impl(_t(m), v, e0, e1, l))


@pytest.mark.parametrize("l", [9, 4])
def test_rotations_below_top_level(ctxs, l):
    """rotate, the hoisted rotations, rotate_stack, eval_sum and
    relinearize, whose gathers and additions now live in the fused passes,
    at levels with fewer live digits."""
    jctx, tctx = ctxs
    x = _res(jctx, (2,), range(l))
    jx = JCt(jnp.asarray(x), 2.0 ** 30)
    tx = carry.ciphertext(x, 2.0 ** 30, device="cpu")
    assert_same(jctx.rotate(jx, 3).data, tctx.rotate(tx, 3).data)
    jd, td = jctx.hoisted_precompute(jx), tctx.hoisted_precompute(tx)
    assert_same(jd, td)
    assert_same(jctx.hoisted_rotate_stack(jx, jd, [1, 2, 4]),
                tctx.hoisted_rotate_stack(tx, td, [1, 2, 4]))
    stack = _res(jctx, (2, 2), range(l))
    assert_same(jctx.rotate_stack(jnp.asarray(stack), [5, 7], 1.0),
                tctx.rotate_stack(_t(stack), [5, 7], 1.0))
    assert_same(jctx.eval_sum(jx, 8).data, tctx.eval_sum(tx, 8).data)
    y = _res(jctx, (3,), range(l))
    assert_same(jctx.relinearize(JCt(jnp.asarray(y), 1.0)).data,
                tctx.relinearize(tc.Ciphertext(_t(y), 1.0)).data)
    for a, b in zip(jctx.keyswitch(jnp.asarray(y[2]), jctx.relin_key),
                    tctx.keyswitch(_t(y[2]), tctx.relin_key)):
        assert_same(a, b)


def test_cpu_path_launches_nothing(ctxs):
    """CPU tensors take the plain versions: no kernel counter moves."""
    _, tctx = ctxs
    before = kernels.counts()
    x = tc.Ciphertext(_t(_res(tctx, (2,), range(9))), 2.0 ** 30)
    tctx.rescale(tctx.relinearize(tctx.square(tctx.rotate(x, 1))))
    tctx.decrypt(x)
    tctx.encrypt(np.zeros(tctx.slots), limbs=4)
    assert kernels.counts() == before
    assert {"rescale_lift", "sub_scale", "decompose", "tensor", "decrypt_mac", "pk_pre",
            "pk_mac"} <= set(kernels.KERNELS)


def test_sub_scale_has_no_plain_branch(ctxs):
    """K7's sub-scale pass is reached only from the CUDA branches of
    rescale and the mod-down: handed CPU tensors it raises instead of
    computing anything."""
    _, tctx = ctxs
    x = torch.zeros((2, 3, tctx.n), dtype=torch.int32)
    with pytest.raises(ValueError):
        tctx._sub_scale(x, x, torch.zeros(3, dtype=torch.int32))

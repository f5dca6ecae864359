"""Port parity: Chebyshev/power-basis Paterson-Stockmeyer evaluation and
the hybrid compare circuit, bit-exact against
image_matching_tpu.ckks.poly_eval on the same input ciphertext and keys."""

import numpy as np
import pytest

from image_matching_tpu.ckks import poly_eval as jpe
from image_matching_tpu.ckks.context import CkksContext as JCtx
from image_matching_tpu.ckks.params import SchemeParams
from image_matching_tpu_torch.ckks import poly_eval as tpe
from image_matching_tpu_torch.ckks.context import CkksContext as TCtx
from image_matching_tpu_torch.utils import carry

from _torch_parity import assert_same, port_params, u32

PARAMS = SchemeParams.create(ring_dim=512, mult_depth=10, security="none")
RNG = np.random.default_rng(31)


@pytest.fixture(scope="module")
def ctxs():
    jctx = JCtx(PARAMS, seed=11)
    tctx = TCtx(port_params(PARAMS), seed=11, device="cpu")
    assert_same(jctx.relin_key, tctx.relin_key)
    return jctx, tctx


def _input(jctx, delta=0.44):
    z = RNG.uniform(-1, 1, size=jctx.slots)
    z[:8] = [0.3, 0.42, 0.46, 0.6, 0.9, -0.9, 0.0, 1.0]
    jc = jctx.encrypt(z, scale=jctx.params.scale)
    return z, jc, carry.ciphertext(u32(jc.data), jc.scale, device="cpu")


def test_constants_and_host_helpers_match():
    assert tpe.F4_COEFS == jpe.F4_COEFS
    assert tpe.DEPTH_TO_DEGREE == jpe.DEPTH_TO_DEGREE
    for deg in (13, 59):
        np.testing.assert_array_equal(
            tpe.chebyshev_coefficients(np.sin, deg), jpe.chebyshev_coefficients(np.sin, deg))
    c = list(RNG.normal(size=60))
    assert tpe._cheb_divmod(list(c), 32) == jpe._cheb_divmod(list(c), 32)


@pytest.mark.parametrize("limbs,deg", [(11, 59), (9, 13), (5, 9)])
def test_plan_baby_k_matches(ctxs, limbs, deg):
    jctx, tctx = ctxs
    coeffs = list(np.ones(deg + 1))
    assert (tpe.plan_baby_k(tctx, limbs, PARAMS.scale, coeffs, tpe._ChebBasis, tpe._cheb_divmod)
            == jpe.plan_baby_k(jctx, limbs, PARAMS.scale, coeffs, jpe._ChebBasis,
                               jpe._cheb_divmod))


@pytest.mark.parametrize("sign_depth", [8, 10])
def test_chebyshev_compare_bit_exact(ctxs, sign_depth):
    jctx, tctx = ctxs
    z, jc, tc = _input(jctx)
    jo = jpe.chebyshev_compare(jctx, jc, 0.44, sign_depth)
    to = tpe.chebyshev_compare(tctx, tc, 0.44, sign_depth)
    assert_same(jo.data, to.data)
    assert to.scale == jo.scale
    # exactly sign_depth levels consumed
    assert tc.limbs - to.limbs == sign_depth
    if sign_depth == 10:
        got = tctx.decrypt(to)
        margin = np.abs(z - 0.44) > 0.03
        assert np.all((got[margin] >= 1.0) == (z[margin] >= 0.44))


def test_eval_poly_ps_f4_bit_exact(ctxs):
    jctx, tctx = ctxs
    z, jc, tc = _input(jctx)
    jo = jpe.eval_poly_ps(jctx, jc, jpe.F4_COEFS)
    to = tpe.eval_poly_ps(tctx, tc, tpe.F4_COEFS)
    assert_same(jo.data, to.data)
    assert tc.limbs - to.limbs == 4
    np.testing.assert_allclose(tctx.decrypt(to), np.polyval(tpe.F4_COEFS[::-1], z), atol=5e-3)


def test_eval_chebyshev_series_smooth(ctxs):
    jctx, tctx = ctxs
    z, jc, tc = _input(jctx)
    coeffs = tpe.chebyshev_coefficients(np.sin, 27)
    to = tpe.eval_chebyshev_series(tctx, tc, coeffs)
    assert_same(jpe.eval_chebyshev_series(jctx, jc, coeffs).data, to.data)
    np.testing.assert_allclose(tctx.decrypt(to), np.sin(z), atol=5e-3)


def test_compare_depth_range_checked(ctxs):
    _, tctx = ctxs
    _, _, tc = _input(tctx)
    with pytest.raises(ValueError):
        tpe.chebyshev_compare(tctx, tc, 0.44, 6)

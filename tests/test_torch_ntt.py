"""Port parity: negacyclic NTT (B2, kernel K1's plain version) and the
Galois automorphism permutations (B3), bit-exact against
image_matching_tpu.ops.ntt at ring 512 (every limb of a production-shaped
chain) and ring 32768 (two limbs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.ckks.params import SchemeParams, root_of_unity
from image_matching_tpu.ops import ntt as jntt
from image_matching_tpu_torch.ops import modmath as tmm
from image_matching_tpu_torch.ops import ntt as tntt

from _torch_parity import assert_same

RNG = np.random.default_rng(23)
_PLANS = {}


def _plans(n, nlimbs=None):
    """(jax plan, port plan, primes) over the chain of a production-shaped
    parameter set (14 q limbs + 6 special) at ring n."""
    if (n, nlimbs) not in _PLANS:
        p = SchemeParams.create(ring_dim=n, mult_depth=11, security="none")
        primes = (p.q_primes + p.sp_primes)[:nlimbs]
        roots = [root_of_unity(q, 2 * n) for q in primes]
        _PLANS[n, nlimbs] = (jntt.NttPlan(n, primes, roots),
                             tntt.NttPlan(n, primes, roots, device="cpu"), primes)
    return _PLANS[n, nlimbs]


def _residues(batch, primes, n):
    return np.stack([RNG.integers(0, q, size=(batch, n)) for q in primes],
                    axis=1).astype(np.uint32)


@pytest.mark.parametrize("n,nlimbs", [(512, None), (32768, 2)])
@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_ntt_bit_exact(n, nlimbs, direction):
    jp, tp, primes = _plans(n, nlimbs)
    limbs = tuple(range(len(primes)))
    a = _residues(2, primes, n)
    want = getattr(jp, direction)(jnp.asarray(a), limbs)
    got = getattr(tp, direction)(tmm.to_tensor(a, "cpu"), limbs)
    assert_same(want, got)


def test_ntt_limb_subset_bit_exact():
    """A limb tuple that is not a prefix maps rows to the right tables."""
    jp, tp, primes = _plans(512)
    limbs = (3, 0, 15, 19)
    a = _residues(3, [primes[i] for i in limbs], 512)
    assert_same(jp.fwd(jnp.asarray(a), limbs), tp.fwd(tmm.to_tensor(a, "cpu"), limbs))
    assert_same(jp.inv(jnp.asarray(a), limbs), tp.inv(tmm.to_tensor(a, "cpu"), limbs))


def test_roundtrip_and_tables():
    jp, tp, primes = _plans(512)
    limbs = tuple(range(len(primes)))
    a = tmm.to_tensor(_residues(2, primes, 512), "cpu")
    assert torch.equal(tp.inv(tp.fwd(a, limbs), limbs), a)
    np.testing.assert_array_equal(tp.psis_np, jp.psis_np)
    np.testing.assert_array_equal(tp.ipsis_np, jp.ipsis_np)
    for name in ("psis_sh", "ipsis_sh", "ninv", "ninv_sh", "q"):
        assert_same(getattr(jp, name), getattr(tp, name))


@pytest.mark.parametrize("n,nlimbs", [(512, None), (32768, 2)])
def test_auto_perm_matches(n, nlimbs):
    jp, tp, _ = _plans(n, nlimbs)
    for g in (5, 25, pow(5, 31, 2 * n), pow(5, n // 2 - 1, 2 * n), 2 * n - 1):
        np.testing.assert_array_equal(tp.auto_perm(g), jp.auto_perm(g))
        assert tp.auto_perm(g).dtype == np.int32


def test_automorphism_rotates_slots():
    """Permuting the evaluation form by auto_perm(5^r) rotates the decoded
    slots left by r (the port's own check, independent of JAX)."""
    from image_matching_tpu.ckks import encoding

    n = 512
    jp, tp, primes = _plans(n)
    q = primes[0]
    z = RNG.uniform(-1, 1, size=n // 2)
    coeffs = encoding.encode(z, n, 2.0 ** 20)[0]
    ev = tntt.host_ntt_fwd(np.mod(coeffs, q).astype(np.uint64), q, tp.psis_np[0])
    for r in (1, 3, 100):
        rot = ev[tp.auto_perm(pow(5, r, 2 * n))]
        c = tntt.host_ntt_inv(rot, q, tp.ipsis_np[0], pow(n, -1, q)).astype(np.int64)
        c = np.where(c > q // 2, c - q, c)
        back = encoding.decode(c, n, 2.0 ** 20)
        np.testing.assert_allclose(back, np.roll(z, -r), atol=1e-4)


def test_host_transforms_match():
    jp, tp, primes = _plans(512)
    q = primes[4]
    a = RNG.integers(0, q, size=(3, 512)).astype(np.uint64)
    np.testing.assert_array_equal(tntt.host_ntt_fwd(a, q, tp.psis_np[4]),
                                  jntt.host_ntt_fwd(a, q, jp.psis_np[4]))
    ninv = pow(512, -1, q)
    np.testing.assert_array_equal(tntt.host_ntt_inv(a, q, tp.ipsis_np[4], ninv),
                                  jntt.host_ntt_inv(a, q, jp.ipsis_np[4], ninv))


def test_k1_row_histogram_counts_launches_by_rows(monkeypatch):
    """NttPlan.rows_hist counts K1 launches by their row count (batch x
    limbs), filled only where K1 launches (here with the launch itself
    stubbed out: the CPU has no card); a replica starts its own."""
    from image_matching_tpu_torch.ops import kernels

    _, tp, _ = _plans(512, 4)
    launched = []
    monkeypatch.setattr(kernels, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "launch", lambda *a: launched.append(a[1]))
    tp.rows_hist.clear()
    x = torch.zeros((3, 4, 512), dtype=torch.int32)
    tp._launch(x, (0, 1, 2, 3), False, None)
    tp._launch(x, (0, 1, 2, 3), True, None)
    tp._launch(x[:, 3:], (3,), True, None)
    tp.fwd_plain(x, (0, 1, 2, 3))  # the plain version is not K1
    assert launched == ["ntt_fwd", "ntt_inv", "ntt_inv"]
    assert tp.rows_hist == {12: 2, 3: 1}
    assert tp.replica("cpu").rows_hist == {}
    tp.rows_hist.clear()


def test_k1_launch_notes_rows_per_block(monkeypatch):
    """NttPlan._launch hands K1 the R' of ``rows_per_block`` (the batch
    rows of one limb that a row-pass block walks) as its last argument,
    notes each launch in ``kernels.shape_hist`` under ("ntt_rows", B, L,
    R', direction), and still fills rows_hist (launch stubbed, as above)."""
    from image_matching_tpu_torch.ops import kernels

    _, tp, _ = _plans(32768, 2)
    launched = []
    monkeypatch.setattr(kernels, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "launch", lambda *a: launched.append((a[1], a[-1])))
    monkeypatch.setattr(kernels, "shape_hist", {})
    tp.rows_hist.clear()
    big = torch.zeros((256, 2, 32768), dtype=torch.int32)
    rb = tntt.rows_per_block(256, 2, 15)
    assert rb > 1 and tntt.rows_per_block(1, 2, 15) == 1
    tp._launch(big, (0, 1), False, None)
    tp._launch(big, (0, 1), True, torch.zeros((256, 32768), dtype=torch.int32))
    tp._launch(big[:1, 1:], (1,), True, None)
    assert launched == [("ntt_fwd", rb), ("ntt_inv", rb), ("ntt_inv", 1)]
    assert kernels.shape_hist == {("ntt_rows", 256, 2, rb, "fwd"): 1,
                                  ("ntt_rows", 256, 2, rb, "inv"): 1,
                                  ("ntt_rows", 1, 1, 1, "inv"): 1}
    assert tp.rows_hist == {512: 2, 1: 1}
    tp.rows_hist.clear()

"""K1's lazy reduction (``csrc/ntt.cu``): every value a butterfly reads or
writes stays below 2q between the stages, and becomes canonical again
where a transform ends and where a pass runs alone.

Emulated in numpy uint64 with ``test_torch_ntt_rows_reduce``'s emulation
of the kernels (each butterfly asserts its bounds): the whole transform
(``imtpu_ntt``: the column pass stage by stage, R1 = 4 and R2 = 3 at N =
2^15, then either row pass; the round trip between them held below 2q,
and some of it at q or more, so the lazy range is used) bit-exact with
``ntt_fwd_plain`` / ``ntt_inv_plain``, the JAX plan and the host
transforms, on HyDia's 20 primes at N = 2^15 and 2^8, on all-(q - 1)
inputs and on the NTT-friendly primes nearest below 2^31, where 2q nears
2^32; each pass alone (``imtpu_ntt_pass``, as slot shards run them)
canonical and bit-exact with the plain split stages; and ``NttPlan``
refusing a modulus of 2^31 or more, which 2q would not fit in 32 bits."""

import numpy as np
import pytest
import torch

from image_matching_tpu.ckks.params import find_primes_near, root_of_unity
from image_matching_tpu.ops import ntt as jntt
from image_matching_tpu_torch.ops import ntt as tntt

from test_torch_ntt_rows_reduce import (BITS, _check, _perms, _plans, emulate_cols, emulate_k1,
                                        emulate_rows_alone)

RNG = np.random.default_rng(21)
_WIDE = {}


def _wide(n):
    """(jax plan, port plan, primes) over the two NTT-friendly primes
    nearest below 2^31."""
    if n not in _WIDE:
        primes = find_primes_near(1 << 31, 2 * n, 2)
        assert all((1 << 31) - (1 << 20) < q < 1 << 31 for q in primes)
        roots = [root_of_unity(q, 2 * n) for q in primes]
        _WIDE[n] = (jntt.NttPlan(n, primes, roots), tntt.NttPlan(n, primes, roots, device="cpu"),
                    primes)
    return _WIDE[n]


def _inputs(primes, shape, top):
    """Residues [*shape, L, N]: uniform, or all q - 1 (``top``)."""
    *lead, n = shape
    return np.stack([np.full(lead + [n], q - 1) if top else RNG.integers(0, q, size=lead + [n])
                     for q in primes], axis=-2).astype(np.uint32)


CASES = [("hydia", 15, 3, False), ("hydia", 15, 2, True), ("hydia", 8, 5, False),
         ("hydia", 8, 3, True), ("wide", 15, 3, False), ("wide", 15, 2, True),
         ("wide", 8, 5, False)]


@pytest.mark.parametrize("chain,logn,batch,top", CASES)
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("rb", [1, 2])
def test_lazy_k1_stays_below_2q_and_is_bit_exact(chain, logn, batch, top, inverse, rb):
    """The whole transform with the row pass a block a row (R' = 1) or
    batched (R' = 2), uniform inputs through a per-row permutation or all
    q - 1 inputs."""
    n = 1 << logn
    jp, tp, primes = (_plans if chain == "hydia" else _wide)(n)
    limbs = tuple(range(len(primes)))
    x = _inputs(primes, (batch, n), top)
    perm = None if top else _perms(tp, batch, n)
    seen = []
    got = emulate_k1(tp, x, limbs, inverse, perm, rb=rb, seen=seen)
    _check(jp, tp, primes, x, limbs, inverse, perm, got)
    if logn > BITS:
        assert len(seen) == len(limbs) and any(m >= q for m, q in seen), \
            "the round trip between the passes never left [0, q)"


@pytest.mark.parametrize("chain", ["hydia", "wide"])
@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("top", [False, True])
def test_lazy_passes_alone_leave_canonical_residues(chain, D, top):
    """imtpu_ntt_pass at N = 2^15, shards 0 and D - 1: the column pass
    forward (canonical on its own) and inverse (with 1/N) over a shard's
    [2^a, 256/D] column block, the row pass forward and inverse (canonical
    on its own) at the shard's global sub-blocks; each below q and equal to
    the plain split stages."""
    n = 1 << 15
    _, tp, primes = (_plans if chain == "hydia" else _wide)(n)
    a = tp.logn - BITS
    E, w = 1 << a, n // D
    full = _inputs(primes[:2], (2, n), top).astype(np.uint64)
    tabs = lambda t: torch.from_numpy(t[:2].view(np.uint32).astype(np.int64))  # noqa: E731
    psis, ipsis = tabs(tp.psis.numpy()), tabs(tp.ipsis.numpy())
    q_t = torch.tensor(primes[:2], dtype=torch.int64)
    for s in (0, D - 1):
        blk = full[..., s * w:(s + 1) * w]
        xt = torch.from_numpy(blk.astype(np.int64))
        off = s * E // D
        wants = [tntt.ntt_fwd_stages(xt, psis, q_t, 1, E, inner=w // E),
                 tntt.ntt_inv_stages(xt, ipsis, q_t, 1, E, inner=w // E)
                 * torch.tensor([pow(n, -1, q) for q in primes[:2]]).view(2, 1) % q_t.view(2, 1),
                 tntt.ntt_fwd_stages(xt, psis, q_t, E, n, nblk=D, blk=s),
                 tntt.ntt_inv_stages(xt, ipsis, q_t, E, n, nblk=D, blk=s)]
        for li in range(2):
            q = np.uint64(primes[li])
            tw, tsh = (tp.psis[li].numpy().view(np.uint32).astype(np.uint64),
                       tp.psis_sh[li].numpy().view(np.uint32).astype(np.uint64))
            itw, itsh = (tp.ipsis[li].numpy().view(np.uint32).astype(np.uint64),
                         tp.ipsis_sh[li].numpy().view(np.uint32).astype(np.uint64))
            div = (tp.ninv[li].numpy().view(np.uint32), tp.ninv_sh[li].numpy().view(np.uint32))
            rows = blk[:, li]
            cols = rows.reshape(2, E, w // E)
            gots = [emulate_cols(cols, tw, tsh, q, False, canon=True),
                    emulate_cols(cols, itw, itsh, q, True, div=div),
                    emulate_rows_alone(rows, tw, tsh, q, a, False, off, canon=True),
                    emulate_rows_alone(rows, itw, itsh, q, a, True, off, canon=True)]
            for i, (got, want) in enumerate(zip(gots, wants)):
                got = got.reshape(2, w)
                assert (got < q).all(), (s, li, i, "not canonical")
                np.testing.assert_array_equal(got.astype(np.int64), want[:, li].numpy())


@pytest.mark.parametrize("modulus", [1 << 31, (1 << 31) + 1, (1 << 32) - 5, 1 << 40])
def test_ntt_plan_refuses_a_modulus_of_2_31_or_more(modulus):
    """2q has to fit in 32 bits for K1's lazy residues: NttPlan raises at
    construction, before any table is built."""
    primes = find_primes_near(1 << 30, 512, 1) + [modulus]
    with pytest.raises(ValueError, match=r"2\^31"):
        tntt.NttPlan(256, primes, [root_of_unity(primes[0], 512), 1], device="cpu")

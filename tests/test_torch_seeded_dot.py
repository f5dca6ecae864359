"""Port parity of the seeded contraction (``senders.ct_dot_seeded``, the
plain version of K2's seeded variant) and of the streamed senders' group
stream (``streaming._stream_groups``), at ring 512.

The seeded contraction of a group's c0 equals ``ct_dot`` over the stack of
c0 and its expanded c1, in the port (``ct_dot_plain``, K5's plain stream)
and in the JAX package (``ct_dot`` over ``expand_c1``), bit for bit:
blocked (K = 4, two blocks), one long block (K = 32), the query at fewer
limbs than the group (the c1 counter runs over the group's limbs), a seed
and group near 2^32, and a padding group (``valid=False``, the JAX
module's ``c1 * valid`` with a zero c0).  The group stream yields each id's
c0 in order, resident, host-tier and padding alike."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.ckks.context import CkksContext as JCtx
from image_matching_tpu.ckks.params import SchemeParams
from image_matching_tpu.matching import senders as jsenders
from image_matching_tpu.matching.config import MatchConfig
from image_matching_tpu.utils import io as dio
from image_matching_tpu_torch.ckks.context import CkksContext as TCtx
from image_matching_tpu_torch.matching import senders, streaming
from image_matching_tpu_torch.ops import kernels
from image_matching_tpu_torch.ops import modmath as tmm

from _torch_parity import assert_same, port_cfg, port_params

PARAMS = SchemeParams.create(ring_dim=512, mult_depth=11, security="none")
TPARAMS = port_params(PARAMS)
HIGH = (2 ** 32 - 7, 2 ** 32 - 3)  # seed and group near 2^32


@pytest.fixture(scope="module")
def ctxs():
    return JCtx(PARAMS, seed=7), TCtx(TPARAMS, seed=7, device="cpu")


def _residues(rng, shape, primes):
    q = np.array(primes, dtype=np.uint64)[:, None]
    return (rng.integers(0, 2 ** 62, size=shape, dtype=np.uint64) % q).astype(np.uint32)


def _jax_dot(jctx, A, c0, c1, blocks):
    """JAX ct_dot of A with each block of the stack [c0, c1]."""
    BK, L, n = c0.shape
    B = np.stack([c0, c1], axis=1).reshape(blocks, BK // blocks, 2, L, n)
    return np.stack([np.asarray(jsenders.ct_dot(jctx, jnp.asarray(A), jnp.asarray(b)))
                     for b in B])


@pytest.mark.parametrize("K,blocks,LA,keys,valid", [
    (4, 2, None, (11, 5), True),      # blocks (HyDia's form)
    (32, 1, None, (3, 0), True),      # one long block (HERS's form)
    (4, 2, 6, (11, 5), True),         # l < L: the counter runs over L
    (4, 2, None, HIGH, True),         # seed and group near 2^32
    (4, 2, None, (11, 5), False),     # a padding group
])
def test_seeded_dot_bit_exact(ctxs, K, blocks, LA, keys, valid):
    jctx, tctx = ctxs
    L, n = tctx.Lq, tctx.n
    LA = LA or L
    seed, group = keys
    rng = np.random.default_rng(K * 100 + LA)
    A = _residues(rng, (K, 2, LA, n), tctx.all_primes[:LA])
    c0 = _residues(rng, (blocks * K, L, n), tctx.all_primes[:L])
    if not valid:
        c0[:] = 0  # a padding group's c0 is zero
    tA, tc0 = tmm.to_tensor(A, "cpu"), tmm.to_tensor(c0, "cpu")
    got = senders.ct_dot_seeded(tctx, tA, tc0, seed, group, blocks, valid)
    assert got.shape == (blocks, 3, min(LA, L), n)

    c1 = tctx.expand_c1(seed, group, blocks * K, L)
    if not valid:
        c1 = torch.zeros_like(c1)
    stack = torch.stack([tc0, c1], dim=1).reshape(blocks, K, 2, L, n)
    assert_same(senders.ct_dot_plain(tctx, tA, stack), got)
    jc1 = np.asarray(jctx.expand_c1(seed, jnp.uint32(group), blocks * K, L)) * np.uint32(valid)
    assert_same(_jax_dot(jctx, A, c0, jc1, blocks), got)
    assert not valid or got.any()


def test_seeded_dot_rejects_mismatched_blocks(ctxs):
    _, tctx = ctxs
    A = torch.zeros((4, 2, 3, tctx.n), dtype=torch.int32)
    c0 = torch.zeros((12, 3, tctx.n), dtype=torch.int32)
    with pytest.raises(ValueError, match="ct_dot_seeded"):
        senders.ct_dot_seeded(tctx, A, c0, 1, 2, 2)


def test_stream_groups_in_order():
    """Resident, host-tier and padding ids, in the order asked, the same
    group twice included: each resident or host-tier id yields its group's
    c0 (a resident one in place), each id past the store a zero c0 that
    holds no memory and valid=False, each with a release the consumer may
    call; no kernel counter moves on the CPU."""
    cfg = port_cfg(MatchConfig(vector_dim=64, chunk_len=16, comp_depth=8))
    ctx = TCtx(TPARAMS, seed=2, device="cpu")
    _, db = dio.gen_dataset(300, 64, seed=3)  # 2 groups of 256 slots
    gbytes = 64 * ctx.Lq * ctx.n * 4
    store = streaming.enroll_diag_streamed(ctx, cfg, db, resident_budget=gbytes)
    assert store.resident == [True, False]
    kernels.reset_counts()
    ids = [1, 0, 2, 1, 5]
    out = list(streaming._stream_groups(store, ctx, ids))
    assert [(g, valid) for g, _, valid, _ in out] == [(1, True), (0, True), (2, False),
                                                     (1, True), (5, False)]
    for g, c0, valid, release in out:
        release()
        assert c0.shape == store.groups[0].shape and c0.dtype == torch.int32
        if valid:
            assert torch.equal(c0, store.groups[g])
        else:
            assert not c0.any() and c0.stride() == (0, 0, 0)
    assert out[1][1].data_ptr() == store.groups[0].data_ptr()  # resident: in place
    default = [g for g, _, _, _ in streaming._stream_groups(store, ctx)]
    assert default == [0, 1]
    assert all(v == 0 for v in kernels.counts().values())

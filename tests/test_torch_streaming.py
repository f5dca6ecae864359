"""Port parity of the streamed, seed-compressed HyDia store at
tests/test_streaming.py scale: ring 512, dim 64, comparison depth 8.

Bit-exact against the JAX package: the Threefry stream and c1 expansion
(K5's plain version), the coefficient split and seeded c0 (K6's plain
version, with the JAX seeded noise injected), the host C++ enroller, the
streamed store's groups, the streamed similarity stack, and the rotation
keys generated after a streamed setup.  The port alone: membership and
index decisions equal to the in-memory sender's, the device-memory
budget, and the engine choice.  The JAX streamed membership is not run:
its compare segments take long to compile, and the compare circuit is held
bit-exact in tests/test_torch_matching.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.ckks.context import CkksContext as JCtx
from image_matching_tpu.ckks.params import SchemeParams, compute_required_depth
from image_matching_tpu.matching import streaming as jstreaming
from image_matching_tpu.matching.config import MatchConfig
from image_matching_tpu.matching.protocol import MatchingProtocol as JProto
from image_matching_tpu.ops import prng as jprng
from image_matching_tpu.utils import io as dio
from image_matching_tpu_torch.ckks.context import CkksContext as TCtx
from image_matching_tpu_torch.ckks.context import seeded_c0_plain, seeded_pre_plain
from image_matching_tpu_torch.ckks.poly_eval import DEPTH_TO_DEGREE
from image_matching_tpu_torch.matching import streaming
from image_matching_tpu_torch.matching.protocol import MatchingProtocol
from image_matching_tpu_torch.ops import kernels
from image_matching_tpu_torch.ops import modmath as tmm
from image_matching_tpu_torch.ops import prng
from image_matching_tpu_torch.utils import carry

import _native_lock
from _torch_parity import (assert_same, carry_context, jax_noise, jax_seeded_noise, port_cfg,
                           port_params, u32)

DIM, NVEC = 64, 300  # 300 vectors span 2 groups of 256 slots
CFG = MatchConfig(vector_dim=DIM, chunk_len=16, comp_depth=8, alpha_depth=2)
PARAMS = SchemeParams.create(
    ring_dim=512, mult_depth=compute_required_depth(5, CFG.comp_depth), security="none")
TCFG, TPARAMS = port_cfg(CFG), port_params(PARAMS)  # the port's own copies
STREAM = dict(resident_budget=0, engine="device")
HIGH = (2 ** 31 + 5, 2 ** 32 - 3)  # seed and group at and above 2^31


def _port_ctx(seed=7):
    return TCtx(TPARAMS, seed=seed, device="cpu", noise=jax_noise(PARAMS.sigma),
                seeded_noise=jax_seeded_noise(PARAMS.sigma))


@pytest.fixture(scope="module")
def ctxs():
    return JCtx(PARAMS, seed=7), _port_ctx()


@pytest.fixture(scope="module")
def pair():
    """The same streamed HyDia protocol in both packages from one seed,
    with both groups in the host tier, and the query encrypted in both."""
    query, db = dio.gen_dataset(NVEC, DIM, seed=1)
    jp = JProto.setup(5, db, CFG, ctx=JCtx(PARAMS, seed=7), streamed=True, **STREAM)
    tp = MatchingProtocol.setup(5, db, TCFG, ctx=_port_ctx(), streamed=True, **STREAM)
    return jp, tp, jp.encrypt_query(query), tp.encrypt_query(query), query, db


@pytest.mark.parametrize("keys", [(7, 3), HIGH])
def test_threefry_bit_exact(keys):
    x = np.arange(4096, dtype=np.uint32) * np.uint32(977)
    with np.errstate(over="ignore"):
        want = jprng.threefry2x32(np.uint32(keys[0]), np.uint32(keys[1]), x, np.zeros_like(x))
    got = prng.threefry2x32(*keys, torch.from_numpy(x.astype(np.int64)),
                            torch.zeros(4096, dtype=torch.int64))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g.numpy().astype(np.uint32))


@pytest.mark.parametrize("seed,group,B,l", [(9, 2, 2, 3), (11, 0, 3, None), (*HIGH, 2, 5)])
def test_expand_c1_bit_exact(ctxs, seed, group, B, l):
    """The c1 stream, over a limb count below Lq (the counter runs over the
    requested l) and at the full Lq, with seed and group >= 2^31."""
    jctx, tctx = ctxs
    l = l or tctx.Lq
    got = tctx.expand_c1(seed, group, B, l)
    assert got.shape == (B, l, tctx.n)
    assert_same(jctx.expand_c1(seed, jnp.uint32(group), B, l), got)
    assert_same(jprng.uniform_residues_np(seed, group, 0, (B, l, tctx.n), jctx.all_primes), got)
    # written into the c1 half of a [B, 2, l, N] stack
    stack = torch.zeros((B, 2, l, tctx.n), dtype=torch.int32)
    tctx.expand_c1(seed, group, B, l, out=stack[:, 1])
    assert_same(got, stack[:, 1])
    assert not stack[:, 0].any()


def test_split_coeffs_bit_exact(ctxs):
    jctx, tctx = ctxs
    coeffs = np.random.default_rng(5).integers(-(2 ** 46), 2 ** 46, size=(3, tctx.n))
    for a, b in zip(jctx.split_coeffs(coeffs), tctx.split_coeffs(coeffs)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="48-bit"):
        tctx.split_coeffs(np.full((1, 4), 2 ** 47))


@pytest.mark.parametrize("limbs,seed,group", [(None, 42, 5), (4, *HIGH)])
def test_seeded_c0_bit_exact(ctxs, limbs, seed, group):
    """c0 = NTT(m + e) - c1 * s with the JAX seeded noise: the port adds m
    and e before one NTT, the JAX package transforms each; the residues
    agree all the same."""
    jctx, tctx = ctxs
    jctx._rng = np.random.default_rng(99)
    tctx._rng = np.random.default_rng(99)
    vals = np.random.default_rng(6).uniform(-1, 1, (3, tctx.slots))
    if seed < 2 ** 32:
        want = jctx.encrypt_seeded_batch(vals, seed, group, limbs)
    else:  # the JAX jit takes a uint32 seed: reproduce it from its parts
        hi, lo = jctx.encode_split(vals)
        want = jctx.encrypt_seeded_from_split(hi, lo, seed & 0xFFFFFFFF, group, limbs)
        jctx._rng = np.random.default_rng(99)
    got = tctx.encrypt_seeded_batch(vals, seed, group, limbs)
    assert_same(want, got)
    assert jctx._rng.integers(0, 2 ** 63) == tctx._rng.integers(0, 2 ** 63)


def test_seeded_passes_against_separate_transforms(ctxs):
    """The pre pass (m + e in Montgomery form) and one NTT equal NTT(m) +
    NTT(e), the JAX package's order; the c0 pass then equals
    x - expand_c1 * s."""
    _, tctx = ctxs
    l, lim = 5, tctx.q_limbs(5)
    rng = np.random.default_rng(8)
    hi, lo = (tmm.to_tensor(a, "cpu") for a in tctx.split_coeffs(
        rng.integers(-(2 ** 40), 2 ** 40, size=(2, tctx.n))))
    e = torch.from_numpy(rng.integers(-20, 21, size=(2, tctx.n)).astype(np.int32))
    q, rinv = tctx._qrow(lim)
    r2 = tctx.r2_64[:l, None]
    ev = e.long()[:, None, :]
    m = tctx.plan.fwd(tmm.mont_mul(tctx._coeffs_from_split(hi, lo, l), r2, q, rinv), lim)
    ee = tctx.plan.fwd(tmm.mont_mul(torch.where(ev < 0, q + ev, ev), r2, q, rinv), lim)
    x = tctx.plan.fwd(seeded_pre_plain(tctx, hi, lo, e, l), lim)
    assert_same(x, tmm.mod_add(m, ee, q))
    c1 = tctx.expand_c1(3, 1, 2, l)
    want = tmm.mod_sub(x, tmm.mont_mul(c1, tctx.s_eval[:l], q, rinv), q)
    assert_same(seeded_c0_plain(tctx, x, 3, 1), want)


def test_seeded_host_enroller_bit_exact(ctxs):
    if not _native_lock.available():
        pytest.skip("native library not built")
    jctx, tctx = ctxs
    jctx._rng = np.random.default_rng(12)
    tctx._rng = np.random.default_rng(12)
    vals = np.random.default_rng(7).uniform(-1, 1, (2, tctx.slots))
    got = tctx.encrypt_seeded_batch_host(vals, seed=42, group=5)
    assert got.dtype == torch.int32 and not got.is_cuda
    assert_same(jctx.encrypt_seeded_batch_host(vals, seed=42, group=5), got)
    # decrypts with the c1 the device expands
    ct = carry.ciphertext(np.stack([u32(got[0]), u32(tctx.expand_c1(42, 5, 1, tctx.Lq)[0])]),
                          tctx.fresh_scale, device="cpu")
    np.testing.assert_allclose(tctx.decrypt(ct), vals[0], atol=1e-6)


def test_streamed_store_bit_exact(pair):
    jp, tp, *_ = pair
    js, ts = jp.sender.store, tp.sender.store
    assert ts.num_groups == js.num_groups == 2
    assert ts.resident_count() == 0 and ts.host_count() == 2
    assert (ts.seed, ts.bsgs, ts.n1, ts.num_vectors, ts.scale) == \
        (js.seed, js.bsgs, js.n1, js.num_vectors, js.scale)
    for a, b in zip(js.groups, ts.groups):
        assert_same(a, b)


def test_rotation_keys_after_streamed_setup(pair):
    """The seeded enrollment draws from the context's generator in the JAX
    order, so the keys generated after it agree."""
    jp, tp, *_ = pair
    assert tp.ctx.rot_keys == jp.ctx.rot_keys
    assert len(tp.ctx._rot_sets) == len(jp.ctx._rot_sets) == 2
    for (jperm, jk), (tperm, tk) in zip(jp.ctx._rot_sets, tp.ctx._rot_sets):
        np.testing.assert_array_equal(np.asarray(jperm), tperm.numpy())
        assert_same(jk, tk)


def test_streamed_similarity_bit_exact(pair):
    jp, tp, jq, tq, *_ = pair
    assert_same(jq[0].data, tq[0].data)
    jsim, jscale = jp.sender._similarity_stream(jq)
    scores = tp.sender.compute_similarity(tq)
    assert_same(jsim, torch.stack([s.data for s in scores]))
    assert scores[0].scale == jscale


def test_carried_store_serves_jax_similarity(pair):
    """A JAX DiagStore and keys carried into a port context of another
    seed give the JAX similarity residues."""
    jp, _, jq, *_ = pair
    js = jp.sender.store
    ctx = TCtx(TPARAMS, seed=3, device="cpu")
    carry_context(jp.ctx, ctx)
    store = carry.diag_store(ctx, [u32(g) for g in js.groups], js.num_vectors, js.scale,
                             js.bsgs, js.n1, js.seed)
    assert store.resident_count() == 2
    sender = streaming.StreamedDiagonalSender(ctx, TCFG, store)
    scores = sender.compute_similarity([carry.ciphertext(u32(jq[0].data), jq[0].scale,
                                                         device="cpu")])
    jsim, _ = jp.sender._similarity_stream(jq)
    assert_same(jsim, torch.stack([s.data for s in scores]))


def test_streamed_decisions_match_in_memory(pair):
    """Membership True and index [0] from the streamed sender, equal to the
    port's in-memory sender on the same DB and query."""
    _, tp, _, tq, query, db = pair
    mem = tp.membership(tq)
    assert tp.decrypt_membership(mem) is True
    idx = tp.decrypt_index(tp.index(tq))
    ref = MatchingProtocol.setup(5, db, TCFG, ctx=TCtx(TPARAMS, seed=5, device="cpu"))
    rq = ref.encrypt_query(query)
    assert ref.decrypt_membership(ref.membership(rq)) is True
    assert idx == ref.decrypt_index(ref.index(rq)) == [0]


def test_resident_and_host_tiers_serve_equal_residues(pair):
    """Promoting every group to the resident tier changes no residue of the
    membership ciphertext, and no kernel counter moves on the CPU."""
    _, tp, _, tq, *_ = pair
    kernels.reset_counts()
    host = tp.membership(tq)
    store = tp.sender.store
    saved = (list(store.groups), list(store.resident))
    try:
        streaming._promote_resident(store, 10 * store.group_bytes())
        assert store.resident_count() == 2
        assert_same(host.data, tp.membership(tq).data)
    finally:
        store.groups, store.resident = saved
    assert all(v == 0 for v in kernels.counts().values())


def test_resident_budget(monkeypatch):
    """Budget 0 keeps no group resident, 1.5 groups' bytes exactly one,
    IMTPU_HBM_BUDGET_GB is honoured, and promotion stops at the budget."""
    _, db = dio.gen_dataset(NVEC, DIM, seed=3)
    ctx = TCtx(TPARAMS, seed=2, device="cpu")
    gbytes = DIM * ctx.Lq * ctx.n * 4
    assert streaming._hbm_budget_bytes(ctx, 0) == 0  # CPU: no device tier
    counts = []
    for budget in (0, int(1.5 * gbytes), None):
        if budget is None:
            monkeypatch.setenv("IMTPU_HBM_BUDGET_GB", str(1.5 * gbytes / 2 ** 30))
        store = streaming.enroll_diag_streamed(ctx, TCFG, db, resident_budget=budget)
        counts.append((store.resident_count(), store.host_count()))
    assert counts == [(0, 2), (1, 1), (1, 1)]
    assert store.group_bytes() == gbytes
    store.groups[0], store.resident[0] = store.groups[0].clone(), False
    streaming._promote_resident(store, gbytes + gbytes // 2)
    assert store.resident == [True, False]
    reserve = streaming._reserve_bytes(ctx, TCFG, 14, 0)
    # 2 x 8 power-of-two keys (256 slots) + 7 baby + 7 giant steps, and one
    # compare stack's Chebyshev basis: 16 scores of deg/2 ciphertexts
    basis = 16 * (DEPTH_TO_DEGREE[TCFG.comp_depth] // 2) * 2 * ctx.Lq * ctx.n * 4
    assert reserve == 30 * ctx.dnum * 2 * ctx.Ltot * ctx.n * 4 + 6 * gbytes + basis


def test_engine_choice(monkeypatch):
    """On the CPU, "auto" is the device engine and never the host C++
    engine; the pinned tier needs CUDA; an unknown engine raises."""
    _, db = dio.gen_dataset(40, DIM, seed=3)
    ctx = TCtx(TPARAMS, seed=2, device="cpu")

    def no_native(*a, **k):
        raise AssertionError("auto picked the host C++ engine")

    monkeypatch.setattr(ctx, "encrypt_seeded_batch_host", no_native)
    store = streaming.enroll_diag_streamed(ctx, TCFG, db)
    assert store.num_groups == 1 and store.resident_count() == 0
    with pytest.raises(ValueError, match="CUDA"):
        streaming.enroll_diag_streamed(ctx, TCFG, db, engine="pinned")
    with pytest.raises(ValueError, match="engine"):
        streaming.enroll_diag_streamed(ctx, TCFG, db, engine="disk")


def test_native_engine_store_bit_exact():
    """The host C++ engine, asked for by name, enrolls the JAX native
    engine's groups."""
    if not _native_lock.available():
        pytest.skip("native library not built")
    _, db = dio.gen_dataset(NVEC, DIM, seed=4)
    js = jstreaming.enroll_diag_streamed(JCtx(PARAMS, seed=9), CFG, db, resident_budget=0,
                                         engine="native")
    ts = streaming.enroll_diag_streamed(TCtx(TPARAMS, seed=9, device="cpu"), TCFG, db,
                                        resident_budget=0,
                                        engine="native")
    assert ts.num_groups == js.num_groups == 2
    for a, b in zip(js.groups, ts.groups):
        assert_same(a, b)

"""The arithmetic of the port's base-conversion kernels (K3
``csrc/basis_convert.cu``, K8 ``csrc/decompose.cu``, their core
``csrc/fbc.cuh``) emulated with Python integers, and the rotation-row
cache of ``CkksContext._rot_rows``.

No GPU is needed: the emulation reads the kernels' packed constants as the
context builds them and repeats the kernels' per-target reduction step by
step (the 64-bit partials of at most four products plus the v * Q term,
one Montgomery step each, a second step on their sum, one conditional
subtraction), asserting each step's bound, and the launchers' split of
the targets over blocks.  It is held bit-exact against ``fbc_plain`` and
the JAX package's ``_fbc`` on the real primes of HyDia (14 q limbs, 6
special) and GROTE (21, 8) at ring 32768, for every source width g in
1..8, on random residues and on the extremes (all q - 1, all 0, and y_i =
q_i - 1, where v is largest); the emulated decomposition against
``decompose_coeff_plain`` and the JAX ``_decompose_extended``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.ckks.context import CkksContext as JCtx
from image_matching_tpu.ckks.params import SchemeParams, compute_required_depth
from image_matching_tpu_torch.ckks import context as tc
from image_matching_tpu_torch.ckks.context import CkksContext as TCtx
from image_matching_tpu_torch.ops import modmath as tmm

from _torch_parity import assert_same, jax_noise, port_params, u32

M32 = (1 << 32) - 1
THREADS, MIN_BLOCKS = 128, 528  # csrc/fbc.cuh FBC_THREADS, passgrid.cuh PASS_MIN_BLOCKS
RNG = np.random.default_rng(20)


def _mont(a, b, q, qneg):
    """modmath.cuh mont_mul on Python integers (object arrays)."""
    t = a * b
    m = (t & M32) * qneg & M32
    r = (t + m * q) >> 32
    return np.where(r >= q, r - q, r)


def _redc_step(s, p, qneg):
    """fbc.cuh redc_step: (s + m p) / 2^32 without the 65-bit sum."""
    assert (s < 1 << 64).all() and (s >= 0).all()
    lo = s & M32
    m = lo * qneg & M32
    out = (s >> 32) + ((m * p) >> 32) + (lo != 0)
    full = s + m * p
    assert ((full & M32) == 0).all() and (out == full >> 32).all()
    assert (out < (1 << 32) + p).all()
    return out


def emulate_targets(packed, g, t, x, pre=None, post=None, targets=None):
    """The kernel's outputs for targets ``targets`` (default all) of one
    conversion: x [g, ...] Python-int object array of source residues;
    packed the context's int32 constants.  Returns ({target: object
    array}, v)."""
    w = u32(packed).astype(np.int64)
    tw = tc.FBC_TW
    tb, src = w[: tw * t].reshape(t, tw), w[tw * t:]
    assert src.size == 4 * g
    q, qn, ts = (src[k * g:(k + 1) * g] for k in range(3))
    inv = src[3 * g:].astype(np.uint32).view(np.float32)
    y, acc = [], None
    for i in range(g):
        xi = x[i]
        if pre is not None:
            xi = (xi + int(pre[i])) % int(q[i])
        yi = _mont(xi, int(ts[i]), int(q[i]), int(qn[i]))
        y.append(yi)
        f = np.asarray(yi, dtype=np.uint32).astype(np.float32) * inv[i]  # float32 product
        acc = f if i == 0 else (acc + f).astype(np.float32)
    v = np.rint(acc).astype(np.int64).astype(object)
    assert (v <= g).all()
    out = {}
    for p in (range(t) if targets is None else targets):
        c = [int(a) for a in tb[p]]
        cv, P, qnp = c[8], c[9], c[10]
        assert c[11] == 0 and all(a == 0 for a in c[g:8]) and 0 < cv < P < 1 << 31
        s0 = v * cv
        for i in range(min(g, 4)):
            s0 = s0 + y[i] * c[i]
        a = _redc_step(s0, P, qnp)
        if g > 4:
            s1 = y[4] * c[4]
            for i in range(5, g):
                s1 = s1 + y[i] * c[i]
            a = a + _redc_step(s1, P, qnp)
        assert (a < 3 << 32).all()
        m = (a & M32) * qnp & M32
        full = a + m * P
        assert (full < 1 << 64).all() and ((full & M32) == 0).all()
        r = full >> 32
        assert (r < 2 * P).all()
        r = np.where(r >= P, r - P, r)
        if post is not None:
            r = np.where(r >= int(post[p]), r - int(post[p]), r + P - int(post[p]))
        out[p] = r
    return out, v


def split(blocks, t):
    """fbc.cuh fbc_split: (targets per block, chunks)."""
    s = min(max(1, -(-MIN_BLOCKS // blocks)), t)
    per = -(-t // s)
    return per, -(-t // per)


def emulate_fbc(ctx, x, src, dst, shift=None):
    """K3's launch on x [B, g, n] (int32 tensor), chunk by chunk as the
    grid splits it; every output row written exactly once."""
    B, g, n = x.shape
    t = len(dst)
    c = ctx._fbc_consts(tuple(src), tuple(dst))
    pre = post = None
    if shift is not None:
        pre, post = (u32(s[1]).astype(np.int64) for s in shift)
    xo = u32(x).astype(np.int64).astype(object)
    out = np.empty((B, t, n), dtype=object)
    written = np.zeros((B, t), dtype=int)
    per, chunks = split(-(-n // (THREADS * 4)) * B, t)
    for b in range(B):
        for h in range(chunks):
            rows = range(h * per, min(t, h * per + per))
            for p, r in emulate_targets(c.packed, g, t, xo[b], pre, post, rows)[0].items():
                out[b, p] = r
                written[b, p] += 1
    assert (written == 1).all()
    return out.astype(np.uint32)


def emulate_decompose(ctx, coeff, l):
    """K8's launch on coefficient rows [B, l, n]: the blocks of each digit
    and target chunk (fbc_split over E - 1 targets), the first chunk
    writing the digit's own rows; every output row written exactly once."""
    consts, info = ctx._decompose_consts(l)
    info = u32(info).astype(np.int64).reshape(-1, 3)
    words = u32(consts)
    B, _, n = coeff.shape
    E = l + ctx.S
    ndig = info.shape[0]
    x = u32(coeff).astype(np.int64).astype(object)
    out = np.empty((B, ndig, E, n), dtype=object)
    written = np.zeros((B, ndig, E), dtype=int)
    per, chunks = split(-(-n // (THREADS * 4)) * ndig * B, E - 1)
    for b in range(B):
        for j, (a, g, off) in enumerate(info):
            t = E - g
            packed = torch.from_numpy(words[off:off + tc.FBC_TW * t + 4 * g].view(np.int32))
            for h in range(chunks):
                p0 = h * per
                if p0 >= t:
                    continue
                if p0 == 0:
                    for i in range(g):
                        out[b, j, a + i] = x[b, a + i]
                        written[b, j, a + i] += 1
                rows = range(p0, min(t, p0 + per))
                for p, r in emulate_targets(packed, g, t, x[b, a:a + g], targets=rows)[0].items():
                    e = p if p < a else p + g
                    out[b, j, e] = r
                    written[b, j, e] += 1
    assert (written == 1).all()
    return out.astype(np.uint32)


def _pair(approach, ring_dim=None):
    depth = compute_required_depth(approach, 10, 2)
    p = (SchemeParams.create(mult_depth=depth) if ring_dim is None else
         SchemeParams.create(ring_dim=ring_dim, mult_depth=depth, security="none"))
    return JCtx(p, seed=3), TCtx(port_params(p), seed=3, device="cpu")


@pytest.fixture(scope="module")
def real():
    """HyDia's and GROTE's contexts at ring 32768 (their real primes)."""
    return {"HyDia": _pair(5), "GROTE": _pair(2)}


@pytest.fixture(scope="module")
def small():
    """HyDia's and GROTE's limb structures at ring 512."""
    return {"HyDia": _pair(5, 512), "GROTE": _pair(2, 512)}


def _inputs(ctx, src, m):
    """Source residues [g, m + 3]: random, then all q - 1, all 0, and the
    x whose y_i = x_i t_i is q_i - 1 for every i (v = g)."""
    c = ctx._fbc_consts(tuple(src), tuple(i for i in range(ctx.Ltot) if i not in src)[:1])
    cols = []
    for k, i in enumerate(src):
        q = ctx.all_primes[i]
        t = int(u32(c.t_std)[k, 0])
        ymax = (q - 1) * pow(t, -1, q) * (1 << 32) % q  # Montgomery x with y = q - 1
        cols.append(np.concatenate([RNG.integers(0, q, size=m), [q - 1, 0, ymax]]))
    return np.stack(cols).astype(np.uint32)


@pytest.mark.parametrize("chain", ["HyDia", "GROTE"])
@pytest.mark.parametrize("g", range(1, 9))
def test_reduction_matches_plain_and_jax(real, chain, g):
    """Every target of a g-limb conversion into the rest of the extended
    basis (at most 32 targets), on the chain's real primes."""
    jctx, tctx = real[chain]
    ext = tctx.ext_limbs(tctx.Lq)
    src = tuple(ext[-g:]) if g == tctx.S else tuple(ext[:g])
    dst = tuple(i for i in ext if i not in src)[:32]
    x = _inputs(tctx, src, 509)
    xt = tmm.to_tensor(x, "cpu")
    got = emulate_fbc(tctx, xt[None], src, dst)[0]
    assert_same(got, tc.fbc_plain(xt, tctx._fbc_consts(src, dst)))
    assert_same(got, jctx._fbc(jnp.asarray(x), src, dst))
    _, v = emulate_targets(tctx._fbc_consts(src, dst).packed, g, len(dst),
                           x.astype(np.int64).astype(object), targets=())
    assert v[-1] == g and v[-2] == 0  # y_i = q_i - 1 gives the largest v; x = 0 gives 0


@pytest.mark.parametrize("chain", ["HyDia", "GROTE"])
def test_centred_moddown_reduction_matches_plain(real, chain):
    """The mod-down's centred conversion (special limbs -> Q_l, +P/2 before
    and -P/2 after) at the top level and two lower ones."""
    _, tctx = real[chain]
    sp = tctx.sp_limbs()
    x = _inputs(tctx, sp, 253)
    xt = tmm.to_tensor(x, "cpu")
    for l in (tctx.Lq, 7, 2):
        lim = tctx.q_limbs(l)
        shift = tctx._centre_shift(l)
        got = emulate_fbc(tctx, xt[None], sp, lim, shift)[0]
        want = tc.fbc_plain(xt, tctx._fbc_consts(sp, lim), shift[0][0], shift[1][0])
        assert_same(got, want)


@pytest.mark.parametrize("chain", ["HyDia", "GROTE"])
@pytest.mark.parametrize("B", [1, 16])
def test_split_launches_cover_every_row(small, chain, B):
    """K3 at the mod-down's and the digits' shapes and K8 at four levels,
    emulated block by block as their launchers split the targets: every
    row written once, equal to the plain versions and, for K8 through the
    forward NTT, to the JAX decomposition."""
    jctx, tctx = small[chain]
    n = tctx.n
    for l in (tctx.Lq, 9, 4, 2):
        coeff = torch.stack([tmm.to_tensor(np.stack([
            RNG.integers(0, tctx.all_primes[i], size=n) for i in range(l)]).astype(np.uint32),
            "cpu") for _ in range(B)])
        got = emulate_decompose(tctx, coeff, l)
        assert_same(got, tc.decompose_coeff_plain(tctx, coeff, l))
        ev = tctx.plan.fwd_plain(coeff[0], tctx.q_limbs(l))
        assert_same(tctx.plan.fwd_plain(torch.from_numpy(got[0].view(np.int32)), tctx.ext_limbs(l)),
                    jctx._decompose_extended(jnp.asarray(u32(ev)), l))
    sp, lim = tctx.sp_limbs(), tctx.q_limbs(tctx.Lq)
    x = torch.stack([tmm.to_tensor(np.stack([
        RNG.integers(0, tctx.all_primes[i], size=n) for i in sp]).astype(np.uint32), "cpu")
        for _ in range(B)])
    got = emulate_fbc(tctx, x, sp, lim, tctx._centre_shift(tctx.Lq))
    pre, post = tctx._centre_shift(tctx.Lq)
    assert_same(got, tc.fbc_plain(x, tctx._fbc_consts(sp, lim), pre[0], post[0]))


# ---------------------------------------------------------------------------
# _rot_rows: no pageable host-to-device copy per call
# ---------------------------------------------------------------------------

PARAMS = SchemeParams.create(ring_dim=512, mult_depth=6, security="none")
ROTS = [1, 2, 3, 5, 7]  # a forced set after the power-of-two one


@pytest.fixture(scope="module")
def rot_ctxs():
    jctx = JCtx(PARAMS, seed=42)
    tctx = TCtx(port_params(PARAMS), seed=42, device="cpu", noise=jax_noise(PARAMS.sigma))
    for c in (jctx, tctx):
        c.gen_power_of_two_rotation_keys()
        c.gen_rotation_keys(ROTS, force=True)
    rng = np.random.default_rng(4)
    data = np.stack([np.stack([rng.integers(0, q, size=PARAMS.ring_dim) for q in PARAMS.q_primes])
                     for _ in range(6)]).reshape(3, 2, PARAMS.num_limbs, -1).astype(np.uint32)
    return jctx, tctx, data


def test_rot_rows_index_built_once(rot_ctxs, monkeypatch):
    """A non-consecutive list ([5, 2, 7]: rows 3, 1, 4 of the forced set)
    rotates bit-equal to the JAX package on two calls; the second builds
    no index (no torch.tensor at all); consecutive rows ([2, 3]) are a
    view of the set and cache nothing."""
    jctx, tctx, data = rot_ctxs
    rots, scale = [5, 2, 7], 2.0 ** 30
    want = jctx.rotate_stack(jnp.asarray(data), rots, scale)
    td = tmm.to_tensor(data, "cpu")
    assert_same(tctx.rotate_stack(td, rots, scale), want)
    sid, rows = tctx._rot_locate(rots)
    assert rows == [3, 1, 4] and set(tctx._rot_cache) == {(sid, (3, 1, 4))}
    idx, perms = tctx._rot_cache[(sid, (3, 1, 4))]
    assert tctx._index(rows) is idx

    built = []
    real_tensor = torch.tensor

    def counting(*a, **k):
        built.append(a)
        return real_tensor(*a, **k)

    monkeypatch.setattr(torch, "tensor", counting)
    assert_same(tctx.rotate_stack(td, rots, scale), want)
    p, _ = tctx._rot_rows(rots)
    monkeypatch.undo()
    assert built == [] and p is perms and tctx._rot_cache[(sid, (3, 1, 4))][0] is idx

    set_perms, set_keys = tctx._rot_sets[sid]
    p2, k2 = tctx._rot_rows([2, 3])
    assert p2.data_ptr() == set_perms[1].data_ptr() and k2.data_ptr() == set_keys[1].data_ptr()
    assert len(tctx._rot_cache) == 1
    assert_same(tctx.rotate_stack(td[:2], [2, 3], scale),
                jctx.rotate_stack(jnp.asarray(data[:2]), [2, 3], scale))


def test_rot_rows_cache_per_replica_and_key_set(rot_ctxs):
    """A replica starts with empty caches and builds its own index; a
    regenerated key set drops every gathered entry, and the rotation
    afterwards still equals the JAX package's after the same regeneration."""
    jctx, tctx, data = rot_ctxs
    rots, scale = [7, 3, 5], 2.0 ** 30
    td = tmm.to_tensor(data, "cpu")
    first = tctx.rotate_stack(td, rots, scale)
    assert tctx._rot_cache
    rep = tctx._copied_to(torch.device("cpu"))
    assert rep._rot_cache == {} and rep._idx_cache == {}
    assert torch.equal(rep.rotate_stack(td, rots, scale), first)
    sid, rows = tctx._rot_locate(rots)
    key = (sid, tuple(rows))
    assert rep._rot_cache[key][0] is not tctx._rot_cache[key][0]

    for c in (jctx, tctx):
        c.gen_rotation_keys([3, 5, 7, 9], force=True)
    assert tctx._rot_cache == {}
    rots2 = [9, 7, 3]
    assert_same(tctx.rotate_stack(td, rots2, scale),
                jctx.rotate_stack(jnp.asarray(data), rots2, scale))
    sid, rows = tctx._rot_locate(rots2)
    assert sid == len(tctx._rot_sets) - 1 and (sid, tuple(rows)) in tctx._rot_cache
    assert_same(tctx.rotate_stack(td, rots, scale), jctx.rotate_stack(jnp.asarray(data), rots,
                                                                       scale))

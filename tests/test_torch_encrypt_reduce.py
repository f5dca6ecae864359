"""The arithmetic and index maps of the port's encryption kernels (K6
``csrc/seeded_encrypt.cu``: the pre and c0 passes of the streamed store's
seeded encryption; K10 ``csrc/pk_encrypt.cu``: the pre and MAC passes of
public-key encryption) emulated in numpy uint64.

No GPU is needed: the emulation repeats each kernel's arithmetic step by
step (K6's signed 64-bit a = hi 2^24 + lo + e - 2^47 reduced per limb as
mont(al, R^2) + mont(ah, R^3) and negated; its keyed Threefry draws with
the key schedule built once; K10's int32 noise, its select for the
ternary v) and its launcher's index maps (``csrc/passgrid.cuh``: V = 4
coefficients a thread, or V = 1 where an operand is not 16-byte aligned;
the limbs split over grid z for few rows, the rows over grid y with its
loop past the grid's limit; the row stretches over grid z of K6's c0 pass,
which holds one limb's s_eval words; K10's MAC pass one thread a
coefficient, the ciphertexts over grid z with its loop past the limit),
reading the operands from their storage through the offsets the wrappers
give the kernels; every output element is written exactly once.  It is
held bit-exact against the plain versions (``seeded_pre_plain``,
``seeded_c0_plain``, ``pk_pre_plain``, ``pk_mac_plain``,
``pk_encrypt_plain``) and the JAX package's ``_coeffs_from_split``,
``_small_signed_to_rns``, ``uniform_residues`` (through ``uniform_mont``),
``_encrypt_seeded_dev`` and ``_encrypt_impl``, each JAX encryption with
the noise of the same key handed to the port, on the real primes of HyDia
(14 q limbs, 6 special) and GROTE (21, 8) at ring 32768 (and at ring 512
with HyDia's primes, for the chunk boundary at B = 130)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.ckks.context import CkksContext as JCtx
from image_matching_tpu.ckks.params import SchemeParams, compute_required_depth
from image_matching_tpu.ops import modmath as jmm
from image_matching_tpu_torch.ckks import context as tc
from image_matching_tpu_torch.ckks.context import CkksContext as TCtx
from image_matching_tpu_torch.ops import modmath as tmm
from image_matching_tpu_torch.ops import prng as tprng

from _torch_parity import (_jax_noise, _jax_seeded_noise, assert_same, carry_context,
                           port_params, u32)
from test_torch_resid_reduce import (MAX_GRID_Y, PASS_THREADS, Out, aligned, limb_split_grid,
                                     mod_add, mod_sub, mont, storage, thread_coeffs)

M32 = np.uint64(0xFFFFFFFF)
TARGET_BLOCKS = 8448  # csrc/passgrid.cuh PASS_TARGET_BLOCKS
MAC_THREADS = 256     # csrc/pk_encrypt.cu imtpu_pk_mac
RNG = np.random.default_rng(31)
SIGMA = 3.19


# ---------------------------------------------------------------------------
# launch geometry (csrc/passgrid.cuh; limb_split_grid and thread_coeffs
# from the K7 emulation, which takes the same grid)
# ---------------------------------------------------------------------------


def row_stretch_grid(B, l, n, V, target=TARGET_BLOCKS):
    """(blocks x, y, z, rows per z stretch) of a pass walking the rows."""
    bx = -(-(n // V) // PASS_THREADS)
    bz = max(1, min(-(-target // (bx * l)), B))
    stretch = -(-B // bz)
    return bx, l, -(-B // stretch), stretch


def signed(x):
    """int32 values from their uint32 storage (uint64 holding 32 bits)."""
    return np.asarray(x, np.uint64).astype(np.uint32).view(np.int32).astype(np.int64)


def small_residue(s, q):
    """pk_encrypt.cu small_residue: s mod q for |s| < q."""
    s = np.asarray(s, np.int64)
    return np.where(s < 0, q + s, s).astype(np.uint64)


def consts(ctx, i):
    return (int(ctx.q_np[i]), int(ctx.qneg_np[i]), int(u32(ctx.r1_32)[i]),
            int(ctx.r2_np[i]), int(u32(ctx.r3_32)[i]))


# ---------------------------------------------------------------------------
# Threefry with the key schedule built once (csrc/threefry.cuh)
# ---------------------------------------------------------------------------

ROT = (13, 15, 26, 6, 17, 29, 16, 24)


def rotl(x, r):
    x = np.asarray(x, np.uint64)
    return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & M32


def threefry_key(k0, k1):
    """threefry_key: (k0 + k1, rotl(k1, 13), the five injections)."""
    ks = (k1, k0 ^ k1 ^ 0x1BD11BDA, k0)
    inj0 = [ks[i % 3] for i in range(5)]
    inj1 = [(ks[(i + 1) % 3] + i + 1) & 0xFFFFFFFF for i in range(5)]
    return (k0 + k1) & 0xFFFFFFFF, int(rotl(k1, 13)), inj0, inj1


def threefry_keyed(key, idx):
    """threefry2x32_keyed(key, idx) -> (hi, lo), idx uint64 below 2^32."""
    k01, rk1, inj0, inj1 = key
    x0 = (np.asarray(idx, np.uint64) + np.uint64(k01)) & M32
    x1 = np.uint64(rk1) ^ x0
    for r in ROT[1:4]:
        x0 = (x0 + x1) & M32
        x1 = rotl(x1, r) ^ x0
    x0 = (x0 + np.uint64(inj0[0])) & M32
    x1 = (x1 + np.uint64(inj1[0])) & M32
    for i in range(1, 5):
        for r in ROT[4 * (i % 2): 4 * (i % 2) + 4]:
            x0 = (x0 + x1) & M32
            x1 = rotl(x1, r) ^ x0
        x0 = (x0 + np.uint64(inj0[i])) & M32
        x1 = (x1 + np.uint64(inj1[i])) & M32
    return x0, x1


def uniform_keyed(key, idx, q, qn, r1, r2):
    """uniform_residue_keyed: mont(hi, R^2) + mont(lo, R)."""
    hi, lo = threefry_keyed(key, idx)
    return mod_add(mont(hi, r2, q, qn), mont(lo, r1, q, qn), q)


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------


def seeded_pre_residue(hi, lo, e, q, qn, r2, r3):
    """One limb of the pre pass: (hi 2^24 + lo + e - 2^47) R mod q."""
    a = (np.asarray(hi, np.int64) << 24) + np.asarray(lo, np.int64) + np.asarray(e, np.int64) \
        - (1 << 47)
    neg = a < 0
    u = np.abs(a).astype(np.uint64)
    ah, al = u >> np.uint64(32), u & M32
    x = mod_add(mont(al, r2, q, qn), mont(ah, r3, q, qn), q)
    return np.where(neg & (x != 0), np.uint64(q) - x, x)


def emulate_seeded_pre(ctx, hi, lo, e, l, max_y=MAX_GRID_Y):
    """imtpu_seeded_pre with the arguments ``_seeded_pre`` gives it: out
    [B, l, N]."""
    hi, lo, e = hi.contiguous(), lo.contiguous(), e.contiguous()
    B, n = hi.shape
    (hs, ho), (ls, lo_), (es, eo) = storage(hi), storage(lo), storage(e)
    V = 4 if n % 4 == 0 and all(aligned(o) for o in (ho, lo_, eo)) else 1
    bx, by, bz, per = limb_split_grid(B, l, n, V, max_y)
    out = Out(B, l, n)
    k = thread_coeffs(bx, n, V)
    for z in range(bz):
        for y in range(by):
            for b in range(y, B, by):
                for v in range(V):
                    src = b * n + k + v
                    h, w, ev = hs[ho + src], ls[lo_ + src], signed(es[eo + src])
                    for i in range(z * per, min(l, z * per + per)):
                        q, qn, _, r2, r3 = consts(ctx, i)
                        out.put((b * l + i) * n + k + v,
                                seeded_pre_residue(h, w, ev, q, qn, r2, r3))
    return out.done((B, l, n)), V


def emulate_seeded_c0(ctx, x, seed, group, target=TARGET_BLOCKS):
    """imtpu_seeded_c0 with the arguments ``_seeded_c0`` gives it (c0
    written over x; each element read by the thread that writes it)."""
    B, l, n = x.shape
    xs, xo = storage(x)
    V = 4 if n % 4 == 0 and aligned(xo) else 1
    bx, _, bz, stretch = row_stretch_grid(B, l, n, V, target)
    key = threefry_key(seed & 0xFFFFFFFF, group & 0xFFFFFFFF)
    s = u32(ctx.s_eval).astype(np.uint64)
    out = Out(B, l, n)
    k = thread_coeffs(bx, n, V)
    step = np.uint64(l * n) & M32
    for z in range(bz):
        b0 = z * stretch
        for i in range(l):
            q, qn, r1, r2, _ = consts(ctx, i)
            idx = np.uint64(((b0 * l + i) * n) & 0xFFFFFFFF) + k.astype(np.uint64)
            idx &= M32
            for b in range(b0, min(B, b0 + stretch)):
                for v in range(V):
                    off = (b * l + i) * n + k + v
                    c1 = uniform_keyed(key, (idx + np.uint64(v)) & M32, q, qn, r1, r2)
                    out.put(off, mod_sub(xs[xo + off], mont(c1, s[i, k + v], q, qn), q))
                idx = (idx + step) & M32
    return out.done((B, l, n)), V


# ---------------------------------------------------------------------------
# K10
# ---------------------------------------------------------------------------


def ternary_mont(v, q, qn, r1, r2):
    """pk_encrypt.cu ternary_mont: a select for v in {-1, 0, 1}, else a
    product with R^2."""
    v = np.asarray(v, np.int64)
    prod = mont(small_residue(v, q), r2, q, qn)
    sel = np.where(v == 0, 0, np.where(v > 0, r1, q - r1)).astype(np.uint64)
    return np.where((v >= -1) & (v <= 1), sel, prod)


def emulate_pk_pre(ctx, m, v, e0, e1, l, max_y=MAX_GRID_Y):
    """imtpu_pk_pre with the arguments ``_pk_pre`` gives it: out [3, B, l,
    N] = (X, V, E1)."""
    m, v, e0, e1 = (t.contiguous() for t in (m, v, e0, e1))
    B, n = m.shape[0], ctx.n
    (ms, mo), (vs, vo), (as0, ao0), (as1, ao1) = (storage(t) for t in (m, v, e0, e1))
    V = 4 if n % 4 == 0 and all(aligned(o) for o in (mo, vo, ao0, ao1)) else 1
    bx, by, bz, per = limb_split_grid(B, l, n, V, max_y)
    plane = B * l * n
    out = Out(3 * B, l, n)
    k = thread_coeffs(bx, n, V)
    for z in range(bz):
        for y in range(by):
            for b in range(y, B, by):
                for j in range(V):
                    src = b * n + k + j
                    vv, a0, a1 = signed(vs[vo + src]), signed(as0[ao0 + src]), signed(as1[ao1 + src])
                    for i in range(z * per, min(l, z * per + per)):
                        q, qn, r1, r2, _ = consts(ctx, i)
                        o = (b * l + i) * n + k + j
                        x = mont(mod_add(ms[mo + o], small_residue(a0, q), q), r2, q, qn)
                        out.put(o, x)
                        out.put(plane + o, ternary_mont(vv, q, qn, r1, r2))
                        out.put(2 * plane + o, mont(small_residue(a1, q), r2, q, qn))
    return out.done((3, B, l, n)), V


def emulate_pk_mac(ctx, x, l, max_z=MAX_GRID_Y):
    """imtpu_pk_mac with the arguments ``_pk_mac`` gives it: out [B, 2, l,
    N] = (pk_b V + X, pk_a V + E1), one thread a coefficient of limb y,
    ciphertexts z, z + gridDim.z, ..."""
    x = x.contiguous()
    B, n = x.shape[1], ctx.n
    xs, xo = storage(x)
    bx, bz = -(-n // MAC_THREADS), min(B, max_z)
    pkb, pka = u32(ctx.pk_b).astype(np.uint64), u32(ctx.pk_a).astype(np.uint64)
    plane = B * l * n
    out = Out(2 * B, l, n)
    c = np.arange(bx * MAC_THREADS)
    c = c[c < n]
    for z in range(bz):
        for i in range(l):
            q, qn = consts(ctx, i)[:2]
            for b in range(z, B, bz):
                o = (b * l + i) * n + c
                X, Vv, E = xs[xo + o], xs[xo + plane + o], xs[xo + 2 * plane + o]
                dst = (b * 2 * l + i) * n + c
                out.put(dst, mod_add(mont(pkb[i, c], Vv, q, qn), X, q))
                out.put(dst + l * n, mod_add(mont(pka[i, c], Vv, q, qn), E, q))
    return out.done((B, 2, l, n))


def emulate_encrypt(ctx, m, v, e0, e1, l):
    """``_encrypt_impl`` on the card: chunks of ``_PK_CHUNK`` ciphertexts,
    each the emulated pre pass, the plain forward NTT and the emulated MAC
    pass.  Returns the ciphertexts and the number of chunks."""
    B, out = m.shape[0], []
    for i in range(0, B, ctx._PK_CHUNK):
        j = min(B, i + ctx._PK_CHUNK)
        x, V = emulate_pk_pre(ctx, m[i:j], v[i:j], e0[i:j], e1[i:j], l)
        assert V == 4
        x = ctx.plan.fwd_plain(x, ctx.q_limbs(l))
        out.append(emulate_pk_mac(ctx, x, l))
    return torch.cat(out), len(out)


# ---------------------------------------------------------------------------
# fixtures and inputs
# ---------------------------------------------------------------------------


def _pair(params):
    jctx = JCtx(params, seed=3)
    tctx = TCtx(port_params(params), seed=3, device="cpu")
    carry_context(jctx, tctx)
    return jctx, tctx


def _params(approach):
    return SchemeParams.create(mult_depth=compute_required_depth(approach, 10, 2))


@pytest.fixture(scope="module")
def real():
    """HyDia's and GROTE's contexts at ring 32768 (their real primes),
    the port's carrying the JAX keys."""
    return {"HyDia": _pair(_params(5)), "GROTE": _pair(_params(2))}


@pytest.fixture(scope="module")
def small():
    """HyDia's ring-32768 primes at ring 512 (they are 1 mod 1024 too),
    for launches of many ciphertexts."""
    return _pair(dataclasses.replace(_params(5), ring_dim=512))


def _misaligned(t):
    """A contiguous copy of t starting one element (4 bytes) past a
    16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)[1:]
    out = flat.view(t.shape)
    out.copy_(t)
    assert out.storage_offset() == 1
    return out


def _split(ctx, B):
    """(hi, lo) of random coefficients below 2^46 in magnitude, the first
    at the split's extremes."""
    c = RNG.integers(-(2 ** 46), 2 ** 46, size=(B, ctx.n))
    c.reshape(-1)[:4] = [-(2 ** 47) + 1, -1, 0, 2 ** 47 - 1]
    return (torch.from_numpy(a.view(np.int32)) for a in ctx.split_coeffs(c))


def _noise(B, n, sigma=SIGMA):
    return torch.from_numpy(np.rint(RNG.normal(0, sigma, size=(B, n))).astype(np.int32))


def _std(ctx, B, l):
    """Standard-form residues [B, l, N], the first of each limb q - 1."""
    m = np.stack([RNG.integers(0, ctx.all_primes[i], size=(B, ctx.n)) for i in range(l)], axis=1)
    m[:, :, 0] = [ctx.all_primes[i] - 1 for i in range(l)]
    return tmm.to_tensor(m.astype(np.uint32), "cpu")


def _pk_noise(B, n):
    v = torch.from_numpy(RNG.integers(-1, 2, size=(B, n)).astype(np.int32))
    return v, _noise(B, n), _noise(B, n)


# ---------------------------------------------------------------------------
# K6 pre pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chain", ["HyDia", "GROTE"])
def test_seeded_pre_arithmetic_extremes(real, chain):
    """mont(al, R^2) + mont(ah, R^3), negated for a < 0, equals (hi 2^24 +
    lo + e - 2^47) R mod q at the extremes of every operand (hi over all
    of uint32, lo below 2^24, |e| < q) on every q limb, and the JAX
    package's _coeffs_from_split with _small_signed_to_rns added."""
    jctx, tctx = real[chain]
    for i in range(tctx.Lq):
        q, qn, _, r2, r3 = consts(tctx, i)
        his = [0, 1, 2 ** 23, 2 ** 23 - 1, 2 ** 24 - 1, 2 ** 32 - 1]
        los = [0, 1, 2 ** 23, 2 ** 24 - 1]
        es = [-(q - 1), -4, -1, 0, 1, 4, q - 1]
        h, w, e = (a.reshape(-1) for a in np.meshgrid(his, los, es, indexing="ij"))
        got = seeded_pre_residue(h, w, e, q, qn, r2, r3)
        want = [(int(a) * (1 << 24) + int(b) + int(c) - (1 << 47)) % q * (1 << 32) % q
                for a, b, c in zip(h, w, e)]
        assert got.tolist() == want, i
    # the JAX split and noise conversion on the same operands, all limbs
    hi = np.array(his * 4, np.uint32)[None, :24]
    lo = np.array(los * 6, np.uint32)[None, :24]
    e = np.array(([-5, -1, 0, 1, 5, 7] * 4), np.int32)[None, :24]
    pad = tctx.n - 24
    hi, lo, e = (np.pad(a, ((0, 0), (0, pad))) for a in (hi, lo, e))
    l = tctx.Lq
    jq, jqn = jctx._qrow(tuple(range(l)))
    jm = jmm.mod_add(jctx._coeffs_from_split(jnp.asarray(hi), jnp.asarray(lo), l),
                     jctx._small_signed_to_rns(jnp.asarray(e), l), jq)
    want = jmm.mont_mul(jm, jnp.asarray(jctx.r2[:l])[:, None], jq, jqn)
    got, _ = emulate_seeded_pre(tctx, *(torch.from_numpy(a.view(np.int32)) for a in (hi, lo, e)),
                                l)
    assert_same(got, want)


@pytest.mark.parametrize("chain", ["HyDia", "GROTE"])
@pytest.mark.parametrize("form", ["one row", "three rows", "l < Lq", "misaligned hi",
                                  "misaligned e", "grid y loop"])
def test_seeded_pre_launch_matches_plain(real, chain, form):
    """The pre pass's launch: one row (a query-sized batch: the limbs split
    over grid z), three rows, fewer limbs than the chain, a misaligned
    operand (V = 1), rows looping past a grid y limit."""
    _, tctx = real[chain]
    B, l, max_y = (1 if form == "one row" else 3), tctx.Lq, MAX_GRID_Y
    hi, lo = _split(tctx, B)
    e = _noise(B, tctx.n)
    if form == "l < Lq":
        l = 5
    elif form == "misaligned hi":
        hi = _misaligned(hi)
    elif form == "misaligned e":
        e = _misaligned(e)
    elif form == "grid y loop":
        max_y = 2
    got, V = emulate_seeded_pre(tctx, hi, lo, e, l, max_y)
    assert V == (1 if form.startswith("misaligned") else 4)
    assert_same(got, tc.seeded_pre_plain(tctx, hi, lo, e, l))


def test_grids_at_the_main_path_shapes():
    """passgrid.cuh at the main path's shapes: a streamed group [512, 14,
    N] and the in-memory chunks of 64 and 128 take one z chunk of all
    limbs in the pre passes; one ciphertext splits its 14 limbs over 7 z
    chunks of 2; the c0 pass's row stretches bring a launch of 512, 128 or
    64 rows to about 8448 blocks."""
    n = 32768
    assert limb_split_grid(512, 14, n, 4) == (64, 512, 1, 14)
    assert limb_split_grid(64, 21, n, 4) == (64, 64, 1, 21)
    assert limb_split_grid(1, 14, n, 4) == (64, 1, 7, 2)
    assert limb_split_grid(1, 14, n, 1) == (256, 1, 3, 5)
    assert limb_split_grid(70000, 2, 512, 4)[1] == MAX_GRID_Y
    assert row_stretch_grid(512, 14, n, 4) == (64, 14, 10, 52)
    assert row_stretch_grid(128, 14, n, 4) == (64, 14, 10, 13)
    assert row_stretch_grid(64, 21, n, 4) == (64, 21, 7, 10)
    assert row_stretch_grid(1, 14, n, 4) == (64, 14, 1, 1)


# ---------------------------------------------------------------------------
# K6 c0 pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,group", [(0, 0), (1234, 63), (2 ** 31 + 5, 2 ** 32 - 3),
                                        (2 ** 32 - 1, 2 ** 31)])
def test_keyed_draws_match_jax_stream(real, seed, group):
    """Threefry with the key schedule built once (on the host) draws the
    JAX uniform_residues stream, counters idx = (b l + limb) N + k, for
    seeds and groups at and above 2^31."""
    jctx, tctx = real["HyDia"]
    B, l, n = 2, 3, tctx.n
    key = threefry_key(seed & 0xFFFFFFFF, group & 0xFFFFFFFF)
    idx = np.arange(B * l * n, dtype=np.uint64).reshape(B, l, n)
    got = np.stack([uniform_keyed(key, idx[:, i], *consts(tctx, i)[:2], *consts(tctx, i)[2:4])
                    for i in range(l)], axis=1)
    assert_same(got, jctx.uniform_mont(seed, group, (B,), l))
    assert_same(got, tprng.uniform_residues_plain(seed, group, (B, l, n), tctx.q32, tctx.r1_32))


@pytest.mark.parametrize("chain", ["HyDia", "GROTE"])
@pytest.mark.parametrize("form", ["two rows", "stretch walk", "l < Lq", "misaligned x"])
def test_seeded_c0_launch_matches_plain(real, chain, form):
    """The c0 pass's launch with seed and group above 2^31: two rows (one
    stretch of two), a walk of 4-row stretches over 7 rows (a small
    target), fewer limbs than the chain, a misaligned x (V = 1)."""
    _, tctx = real[chain]
    B, l, target = 2, tctx.Lq, TARGET_BLOCKS
    seed, group = 2 ** 31 + 5, 2 ** 32 - 3
    if form == "stretch walk":
        B, l, target = 7, 3, 64 * 3 * 2
    elif form == "l < Lq":
        l = 5
    x = tmm.to_tensor(np.stack([RNG.integers(0, tctx.all_primes[i], size=(B, tctx.n))
                                for i in range(l)], axis=1).astype(np.uint32), "cpu")
    if form == "misaligned x":
        x = _misaligned(x)
    bz, stretch = row_stretch_grid(B, l, tctx.n, 4, target)[2:]
    if form == "stretch walk":
        assert (bz, stretch) == (2, 4)
    got, V = emulate_seeded_c0(tctx, x, seed, group, target)
    assert V == (1 if form == "misaligned x" else 4)
    assert_same(got, tc.seeded_c0_plain(tctx, x, seed, group))


@pytest.mark.parametrize("chain", ["HyDia", "GROTE"])
def test_emulated_seeded_encryption_matches_jax(real, chain):
    """Both emulated passes around the plain forward NTT give the JAX
    _encrypt_seeded_dev's c0 for the noise of the same key, and the port's
    encrypt_seeded on the CPU."""
    jctx, tctx = real[chain]
    B, l, seed, group = 2, tctx.Lq, 2 ** 31 + 7, 2 ** 31 + 1
    hi, lo = _split(tctx, B)
    ekey = jax.random.key(17)
    e = torch.from_numpy(np.array(_jax_seeded_noise(ekey, B, tctx.n, SIGMA)))
    x, _ = emulate_seeded_pre(tctx, hi, lo, e, l)
    got, _ = emulate_seeded_c0(tctx, tctx.plan.fwd_plain(x, tctx.q_limbs(l)), seed, group)
    want = jctx._encrypt_seeded_dev(jctx.device_state(), jnp.asarray(u32(hi)),
                                    jnp.asarray(u32(lo)), jnp.uint32(group), ekey, l, seed)
    assert_same(got, want)
    assert_same(got, tctx.encrypt_seeded(hi, lo, e, seed, group, l))


# ---------------------------------------------------------------------------
# K10 pre pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chain", ["HyDia", "GROTE"])
def test_pk_pre_arithmetic_extremes(real, chain):
    """The select for the ternary v (and the product for any other |v| <
    q), (m + e0) R and e1 R at the extremes of m, v, e0 and e1, on every
    q limb: equal to pk_pre_plain and to the JAX _small_signed_to_rns in
    Montgomery form."""
    jctx, tctx = real[chain]
    l, n = tctx.Lq, tctx.n
    qmin = min(tctx.all_primes[:l])
    vals = [-(qmin - 1), -2, -1, 0, 1, 2, qmin - 1]
    v, e0, e1 = (np.array(a, np.int32).reshape(-1) for a in np.meshgrid(vals, vals, vals))
    pad = n - v.size
    v, e0, e1 = (torch.from_numpy(np.pad(a, (0, pad))[None]) for a in (v, e0, e1))
    m = _std(tctx, 1, l)
    m[0, :, 1] = 0
    got, V = emulate_pk_pre(tctx, m, v, e0, e1, l)
    assert V == 4
    assert_same(got, tc.pk_pre_plain(tctx, m, v, e0, e1, l))
    jq, jqn = jctx._qrow(tuple(range(l)))
    r2 = jnp.asarray(jctx.r2[:l])[:, None]
    small = [jmm.mont_mul(jctx._small_signed_to_rns(jnp.asarray(t.numpy()), l), r2, jq, jqn)
             for t in (v, e1)]
    jx = jmm.mont_mul(jmm.mod_add(jnp.asarray(u32(m)),
                                  jctx._small_signed_to_rns(jnp.asarray(e0.numpy()), l), jq),
                      r2, jq, jqn)
    assert_same(got[0], jx)
    assert_same(got[1], small[0])
    assert_same(got[2], small[1])


@pytest.mark.parametrize("chain", ["HyDia", "GROTE"])
@pytest.mark.parametrize("form", ["one ciphertext", "three", "l < Lq", "misaligned m",
                                  "misaligned noise", "grid y loop"])
def test_pk_pre_launch_matches_plain(real, chain, form):
    """The pre pass's launch: one ciphertext (a HyDia query: the limbs
    split over grid z), three, fewer limbs than the chain, a misaligned
    message or noise operand (V = 1), rows looping past a grid y limit."""
    _, tctx = real[chain]
    B, l, max_y = (1 if form == "one ciphertext" else 3), tctx.Lq, MAX_GRID_Y
    if form == "l < Lq":
        l = 5
    m = _std(tctx, B, l)
    v, e0, e1 = _pk_noise(B, tctx.n)
    if form == "misaligned m":
        m = _misaligned(m)
    elif form == "misaligned noise":
        e1 = _misaligned(e1)
    elif form == "grid y loop":
        max_y = 2
    got, V = emulate_pk_pre(tctx, m, v, e0, e1, l, max_y)
    assert V == (1 if form.startswith("misaligned") else 4)
    assert_same(got, tc.pk_pre_plain(tctx, m, v, e0, e1, l))


# ---------------------------------------------------------------------------
# K10 MAC pass and the whole encryption
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chain", ["HyDia", "GROTE"])
@pytest.mark.parametrize("form", ["one ciphertext", "grid z loop", "l < Lq", "misaligned x"])
def test_pk_mac_launch_matches_plain(real, chain, form):
    """The MAC pass's launch: one ciphertext, five ciphertexts looping past
    a grid z limit of two, fewer limbs than the chain, a misaligned x (one
    4-byte access a thread either way)."""
    _, tctx = real[chain]
    B, l, max_z = (1 if form == "one ciphertext" else 2), tctx.Lq, MAX_GRID_Y
    if form == "grid z loop":
        B, l, max_z = 5, 3, 2
    elif form == "l < Lq":
        l = 5
    x = torch.stack([tc.pk_pre_plain(tctx, _std(tctx, B, l), *_pk_noise(B, tctx.n), l)[0]
                     for _ in range(3)])
    if form == "misaligned x":
        x = _misaligned(x)
    assert_same(emulate_pk_mac(tctx, x, l, max_z), tc.pk_mac_plain(tctx, x, l))


@pytest.mark.parametrize("chain", ["HyDia", "GROTE"])
def test_emulated_encryption_matches_jax(real, chain):
    """The emulated passes around the plain forward NTT give the JAX
    _encrypt_impl's ciphertexts for the noise of the same key, and
    pk_encrypt_plain, at the top level and below."""
    jctx, tctx = real[chain]
    B = 2
    for l in (tctx.Lq, 4):
        m = _std(tctx, B, l)
        key = jax.random.key(40 + l)
        v, e0, e1 = (torch.from_numpy(np.array(a)) for a in _jax_noise(key, B, tctx.n, SIGMA))
        assert v.dtype == e0.dtype == torch.int32
        got, chunks = emulate_encrypt(tctx, m, v, e0, e1, l)
        assert chunks == 1
        assert_same(got, jctx._encrypt_impl(jnp.asarray(u32(m)), key, l))
        assert_same(got, tc.pk_encrypt_plain(tctx, m, v, e0, e1, l))


def test_encryption_across_a_chunk_boundary(small):
    """B = 130 in chunks of 128 (two pre and MAC launches, the second
    reading its operands 128 rows into them) equals pk_encrypt_plain and
    the JAX _encrypt_impl on HyDia's primes; the port's _encrypt_impl on
    the CPU and its fresh noise are int32."""
    jctx, tctx = small
    assert tctx._PK_CHUNK == 128
    B, l = 130, tctx.Lq
    m = _std(tctx, B, l)
    key = jax.random.key(77)
    v, e0, e1 = (torch.from_numpy(np.array(a)) for a in _jax_noise(key, B, tctx.n, SIGMA))
    got, chunks = emulate_encrypt(tctx, m, v, e0, e1, l)
    assert chunks == 2
    assert_same(got, tc.pk_encrypt_plain(tctx, m, v, e0, e1, l))
    assert_same(got, jctx._encrypt_impl(jnp.asarray(u32(m)), key, l))
    assert_same(got, tctx._encrypt_impl(m, v, e0, e1, l))
    assert all(t.dtype == torch.int32 for t in tctx._fresh_noise(5, 2))

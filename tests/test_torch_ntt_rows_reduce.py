"""K1 (``csrc/ntt.cu``: ``ntt_cols_kernel``, ``ntt_rows_batch_kernel``,
``ntt_rows_kernel``, the launchers and ``ops/ntt.py``
``rows_per_block``) emulated in numpy uint64.

No GPU is needed.  Every butterfly runs the kernel's lazy arithmetic
(``red``, ``shoup_lazy``, ``ct`` / ``gs`` and their two-factor forms) and
asserts that every value it reads or writes lies below 2q; a pass's
outputs are canonical where the kernel's ``finish`` makes them so.  The
batched row pass is walked block by block (block (row group, limb; tile)
over batch rows b0 .. b0 + R' of one limb), stages each block's twiddles
by ``stage_twiddles``' index map (all 255 of each sub-block), runs every
stage with the staged twiddle the kernel reads, moves the registers
through the warp's swizzled shared memory between layouts A, B and C
(asserting every access conflict-free), and loads and stores each row in
the kernel's edge layouts (forward: A in, C out; inverse: C in, through
the permutation's indices in C, A out).  The column pass runs stage by
stage as its threads' two register layouts pair the elements; the row
pass a block a row (R' = 1) with the products c_v psis[g] of table blocks
5-7.  The round trip between the passes is held below 2q.  It is held
bit-exact against ``ntt_fwd_plain`` / ``ntt_inv_plain``, the JAX plan and,
on its first and last batch rows, ``host_ntt_fwd`` / ``host_ntt_inv``, on
HyDia's 20 primes at N = 2^15 (and at N = 2^8, where the row pass is the
forward's first and the inverse's last, with 1/N), for 1, 2, 15 and 45
batch rows, with and without a per-row permutation, with a shared one and
on a slice of limbs a batch stride apart."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.ckks.params import SchemeParams, compute_required_depth, root_of_unity
from image_matching_tpu.ops import ntt as jntt
from image_matching_tpu_torch.ops import modmath as tmm
from image_matching_tpu_torch.ops import ntt as tntt

M32 = (1 << 32) - 1
BITS = 8  # ntt.cu kMaxRowBits: a warp holds a sub-block of 256
RNG = np.random.default_rng(18)
_PLANS = {}


def _plans(n):
    """(jax plan, port plan, primes) over HyDia's chain (14 q limbs, 6
    special) at ring n."""
    if n not in _PLANS:
        p = SchemeParams.create(mult_depth=compute_required_depth(5, 10))
        primes = p.q_primes + p.sp_primes
        assert len(primes) == 20
        roots = [root_of_unity(q, 2 * n) for q in primes]
        _PLANS[n] = (jntt.NttPlan(n, primes, roots), tntt.NttPlan(n, primes, roots, device="cpu"),
                     primes)
    return _PLANS[n]


# --- ntt.cu's device helpers on numpy uint64: the lazy residues, every value
# a butterfly reads or writes below 2q, canonical only where a pass ends ---

def _lazy(q, *xs):
    """Assert the lazy invariant: every value below 2q."""
    for x in xs:
        assert (x < 2 * q).all(), "a residue reached 2q"


def _red(x, q):
    """red: x mod q for x < 2q (x - q wraps above x in 32 bits when x < q)."""
    _lazy(q, x)
    return np.minimum(x, (x - q) & np.uint64(M32))


def _shoup_lazy(a, w, wsh, q):
    """shoup_lazy: a w mod q or that plus q, for any a < 2^32; the bound is
    asserted on the exact value, which the kernel's 32-bit words wrap to."""
    assert (a <= M32).all()
    r = a * w - ((a * wsh) >> np.uint64(32)) * q
    _lazy(q, r)
    return r


def _shoup(a, w, wsh, q):
    """modmath.cuh shoup_mul: the full product, canonical (the 1/N)."""
    return _red(_shoup_lazy(a, w, wsh, q), q)


def _ct_t(u, t, q):
    t, u = _red(t, q), _red(u, q)
    return u + t, u - t + q


def _ct(u, v, w, q):
    _lazy(q, v)
    return _ct_t(u, _shoup_lazy(v, w[0], w[1], q), q)


def _ct2(u, v, t, c, q):
    """ct2: the twiddle as two factors, the inner product below 2q."""
    _lazy(q, v)
    return _ct_t(u, _shoup_lazy(_shoup_lazy(v, t[0], t[1], q), c[0], c[1], q), q)


def _gs_d(u, v, q):
    u, v = _red(u, q), _red(v, q)
    return u + v, u - v + q


def _gs(u, v, w, q):
    s, d = _gs_d(u, v, q)
    return s, _shoup_lazy(d, w[0], w[1], q)


def _gs2(u, v, t, c, q):
    s, d = _gs_d(u, v, q)
    return s, _shoup_lazy(_shoup_lazy(d, t[0], t[1], q), c[0], c[1], q)


def _finish(x, q, div=None, canon=False):
    """finish: x / N where the inverse ends (div: (ninv, ninv_sh)),
    canonical where ``canon``, else left below 2q."""
    if div is not None:
        return _shoup(x, np.uint64(div[0]), np.uint64(div[1]), q)
    _lazy(q, x)
    return _red(x, q) if canon else x


def swz(i):
    h = (i >> 5) & 7
    return i ^ (h << 2) ^ (h & 3)


LANE = np.arange(32)[:, None]  # [lane, register]
REG = np.arange(8)[None, :]
LAY = {"A": (REG << 5) | LANE,
       "B": ((LANE >> 2) << 5) | (REG << 2) | (LANE & 3),
       "C": ((REG >> 2) << 7) | (LANE << 2) | (REG & 3)}


def relayout(x, frm, to):
    """x [..., 32 lanes, 8 registers] through the warp's 256 words of
    shared memory at swz: every layout's access (one register, 32 lanes) on
    32 distinct banks, every word written once."""
    for lay in (frm, to):
        assert all(len(set(swz(LAY[lay][:, e]) % 32)) == 32 for e in range(8))
    assert len(set(swz(LAY[frm]).ravel())) == 256
    s = np.zeros(x.shape[:-2] + (256,), dtype=np.uint64)
    s[..., swz(LAY[frm])] = x
    return s[..., swz(LAY[to])]


def staged(P, K, lsb, blk0):
    """stage_twiddles' table index of each shared entry e."""
    e = np.arange(((1 << K) - 1) << lsb)
    v = np.array([int(t).bit_length() - 1 for t in (e >> lsb) + 1])  # 31 - __clz
    return (1 << (P + v)) + (blk0 << v) + e - (((1 << v) - 1) << lsb)


# --- the launcher and the kernel ---------------------------------------------

def emulate_rows_batch(mem, in_off, in_bstride, perm, perm_bstride, out, first, last,
                       limb_idx, L, batch, rb, logn, tw, tw_sh, qs, ninv, ninv_sh, inverse):
    """rows_batch_pass and ntt_rows_batch_kernel over flat uint64 buffers:
    mem (``in`` at in_off), perm (int, or None), out [rows * n] (read too
    when not first); tw / tw_sh [Ltot, n] the tables, qs, ninv, ninv_sh
    [Ltot].  The grid's blocks are walked one by one for the rows each
    takes; the rows of one limb (whose blocks stage the same twiddles) then
    run side by side."""
    n, a = 1 << logn, logn - BITS
    sub = logn - BITS
    lsb = min(sub, 2)
    groups = -(-batch // rb)
    grid_x, grid_y, warps = groups * L, 1 << (sub - lsb), 1 << lsb
    walked = [[] for _ in range(L)]  # the batch rows of each limb, by the blocks that walk them
    for bx in range(grid_x):
        li, b0 = bx % L, (bx // L) * rb
        walked[li] += range(b0, min(b0 + rb, batch))
    assert all(sorted(w) == list(range(batch)) for w in walked), "a row walked twice or never"
    tile = np.arange(grid_y)[:, None, None, None]  # [tile, warp, lane, register]
    warp = np.arange(warps)[None, :, None, None]
    lane = LANE[None, None, :, 0]                  # [tile, warp, lane]
    base = ((tile << lsb) + warp) << BITS
    gidx = np.stack([staged(a, BITS, lsb, t << lsb) for t in range(grid_y)])

    for li in range(L):
        rows = np.array(walked[li])[:, None, None, None, None]  # [row, tile, warp, lane, reg]
        limb = int(limb_idx[li])
        q = np.uint64(qs[limb])
        stw = (tw[limb][gidx].astype(np.uint64), tw_sh[limb][gidx].astype(np.uint64))

        def twb(v, idx):
            """The staged twiddle (w, w_sh) at TWB(v)[idx] of each warp."""
            off = (((1 << v) - 1) << lsb) + (warp[..., 0] << v) + idx
            t = np.arange(grid_y)[:, None, None]
            return stw[0][t, off], stw[1][t, off]

        lay = LAY["C" if inverse else "A"]
        if not first:
            x = out[(rows * L + li) * n + base + lay]
        elif perm is None:
            x = mem[in_off + rows * in_bstride + li * n + base + lay]
        else:
            x = mem[in_off + rows * in_bstride + li * n + perm[rows * perm_bstride + base + lay]]
        dst = (rows * L + li) * n + base
        if not inverse:
            for v in range(3):  # bits 7..5, layout A
                h = 4 >> v
                for k in range(8):
                    if not k & h:
                        w = twb(v, k >> (3 - v))
                        x[..., k], x[..., k + h] = _ct(x[..., k], x[..., k + h], w, q)
            x = relayout(x, "A", "B")
            for u in range(3):  # bits 4..2, layout B: blocks 3..5
                h = 4 >> u
                for k in range(8):
                    if not k & h:
                        w = twb(3 + u, ((lane >> 2) << u) + (k >> (3 - u)))
                        x[..., k], x[..., k + h] = _ct(x[..., k], x[..., k + h], w, q)
            x = relayout(x, "B", "C")
            for u in range(2):  # bits 1..0, layout C: blocks 6, 7
                h = 2 >> u
                for e in range(8):
                    if not e & h:
                        w = twb(6 + u, (lane << u) + (((e >> 2) << (5 + u)) | ((e & 3) >> (2 - u))))
                        x[..., e], x[..., e + h] = _ct(x[..., e], x[..., e + h], w, q)
            out[dst + LAY["C"]] = _finish(x, q, canon=True)
        else:
            for ul in range(2):  # bits 0..1, layout C: blocks 7, 6
                h = 1 << ul
                for e in range(8):
                    if not e & h:
                        w = twb(7 - ul, (lane << (1 - ul))
                                + (((e >> 2) << (6 - ul)) | ((e & 3) >> (ul + 1))))
                        x[..., e], x[..., e + h] = _gs(x[..., e], x[..., e + h], w, q)
            x = relayout(x, "C", "B")
            for ul in range(2, 5):  # bits 2..4, layout B: blocks 5..3
                h = 1 << (ul - 2)
                for k in range(8):
                    if not k & h:
                        w = twb(7 - ul, ((lane >> 2) << (4 - ul)) + (k >> (ul - 1)))
                        x[..., k], x[..., k + h] = _gs(x[..., k], x[..., k + h], w, q)
            x = relayout(x, "B", "A")
            for ul in range(5, 8):  # bits 5..7, layout A: blocks 2..0
                h = 1 << (ul - 5)
                for k in range(8):
                    if not k & h:
                        w = twb(7 - ul, k >> (ul - 4))
                        x[..., k], x[..., k + h] = _gs(x[..., k], x[..., k + h], w, q)
            out[dst + LAY["A"]] = _finish(x, q, (ninv[limb], ninv_sh[limb]) if last else None)


def cols_stages(A, inverse):
    """ntt_cols_kernel's butterflies over the 2^A elements of a column,
    stage by stage as its loops and two register layouts run them: for
    each stage, the element pairs (i_u, i_v) of every thread's registers
    and the staged twiddle each reads (its index into ``stage_twiddles``'
    entries).  Thread tc < 2^R2 holds x[k] = element (k << R2) | tc in
    layout A and x[g K2 + k2] = ((tc G + g) << R2) | k2 in layout B
    (cols_dispatch: R1 = ceil(A / 2), R2 = floor(A / 2))."""
    R1, R2 = (A + 1) // 2, A // 2
    E, K2, G = 1 << R1, 1 << R2, 1 << (R1 - R2)
    lay_a = lambda tc, k: (k << R2) | tc  # noqa: E731
    lay_b = lambda tc, r: ((tc * G + r // K2) << R2) | (r % K2)  # noqa: E731

    def stage(pairs):
        iu, iv, t = (np.array(c) for c in zip(*pairs))
        assert sorted(np.concatenate([iu, iv])) == list(range(1 << A)), "a pair missed"
        return iu, iv, t

    def in_a(h, tw):  # a stage in layout A: registers k, k + h
        return stage([(lay_a(tc, k), lay_a(tc, k + h), tw(tc, k))
                      for tc in range(K2) for k in range(E) if not k & h])

    def in_b(h, tw):  # layout B: registers g K2 + k2, g K2 + k2 + h
        return stage([(lay_b(tc, g * K2 + k2), lay_b(tc, g * K2 + k2 + h), tw(tc, g, k2))
                      for tc in range(K2) for g in range(G) for k2 in range(K2) if not k2 & h])

    if not inverse:  # global stage u pairs bit A-1-u; its twiddle group is i >> (A-u)
        return ([in_a(E >> (u + 1), lambda tc, k, u=u: (1 << u) - 1 + (k >> (R1 - u)))
                 for u in range(R1)]
                + [in_b(K2 >> (u + 1), lambda tc, g, k2, u=u: (1 << (R1 + u)) - 1
                        + (((tc * G + g) << u) | (k2 >> (R2 - u)))) for u in range(R2)])
    # local stage u pairs bit u; its twiddle group is i >> (u+1), table block A-1-u
    return ([in_b(1 << u, lambda tc, g, k2, u=u: (1 << (A - 1 - u)) - 1
                  + (((tc * G + g) << (R2 - u - 1)) | (k2 >> (u + 1)))) for u in range(R2)]
            + [in_a(1 << u, lambda tc, k, u=u: (1 << (R1 - 1 - u)) - 1 + (k >> (u + 1)))
               for u in range(R1)])


def emulate_cols(x, tw, tw_sh, q, inverse, div=None, canon=False):
    """ntt_cols_kernel over rows x [B, 2^A, C] of one limb (element i of
    column j at j + i C, as the kernel loads and stores them): its staged
    twiddles (stage_twiddles at P = 0: tw[1 .. 2^A)), its stages, then
    ``_finish``."""
    x = x.copy()
    A = x.shape[1].bit_length() - 1
    st = staged(0, A, 0, 0)
    for iu, iv, t in cols_stages(A, inverse):
        w = (tw[st[t]][:, None], tw_sh[st[t]][:, None])
        x[:, iu], x[:, iv] = (_gs if inverse else _ct)(x[:, iu], x[:, iv], w, q)
    return _finish(x, q, div, canon)


def emulate_rows_alone(x, tw, tw_sh, q, a, inverse, blk_off=0, div=None, canon=False):
    """ntt_rows_kernel's arithmetic (a block a row) over rows x [B, w] of
    one limb, stage by stage on each sub-block of 256 (global sub-block
    blk_off + s): table blocks v < 5 from the staged twiddles, blocks 5-7
    as the product of the sub-block's factor c_v = tw[2^(a+v) + (blk <<
    v)] and tw[g] (ct2 / gs2), then ``_finish``."""
    B, w = x.shape
    nsub = w >> BITS
    blk = blk_off + np.arange(nsub)
    for v in (range(BITS - 1, -1, -1) if inverse else range(BITS)):
        y = x.reshape(B, nsub, 1 << v, 2, (1 << (BITS - 1)) >> v)
        g = np.arange(1 << v)
        base = (1 << (a + v)) + (blk << v)
        if v < 5:
            idx = base[:, None] + g[None, :]
            r = (_gs if inverse else _ct)(y[..., 0, :], y[..., 1, :],
                                          (tw[idx][..., None], tw_sh[idx][..., None]), q)
        else:
            t = (tw[g][:, None], tw_sh[g][:, None])
            c = (tw[base][:, None, None], tw_sh[base][:, None, None])
            r = (_gs2 if inverse else _ct2)(y[..., 0, :], y[..., 1, :], t, c, q)
        x = np.stack(r, axis=-2).reshape(B, w)
    return _finish(x, q, div, canon)


def emulate_k1(plan, x, limbs, inverse, perm=None, lfull=None, loff=0, rb=None, seen=None):
    """K1 (imtpu_ntt) on x [B, L, N] of limbs ``limbs``, read as limbs loff
    .. loff + L of a [B, lfull, N] buffer (a batch stride of lfull * N),
    both passes emulated: the column pass stage by stage
    (``emulate_cols``) and the row pass at R' = ``rb`` (default the
    launcher's): ``emulate_rows_batch`` above 1, ``emulate_rows_alone`` at
    1.  The rows' round trip through ``out`` between the passes is held
    below 2q, its largest value over q of each limb appended to ``seen``.
    Returns int32 [B, L, N]."""
    B, L, n = x.shape
    logn, a = n.bit_length() - 1, n.bit_length() - 1 - BITS
    lfull = L if lfull is None else lfull
    buf = np.zeros((B, lfull, n), dtype=np.uint64)
    buf[:, loff:loff + L] = x
    mem = buf.ravel()
    rb = tntt.rows_per_block(B, L, logn) if rb is None else rb
    pflat, pb = None, 0
    if perm is not None:
        pflat, pb = perm.astype(np.int64).ravel(), n if perm.shape[0] > 1 else 0
    idx = np.array(limbs)
    psis, ipsis = plan.psis.numpy().view(np.uint32), plan.ipsis.numpy().view(np.uint32)
    psh, ipsh = plan.psis_sh.numpy().view(np.uint32), plan.ipsis_sh.numpy().view(np.uint32)
    qs, ninv = plan.q.numpy().view(np.uint32), plan.ninv.numpy().view(np.uint32)
    ninv_sh = plan.ninv_sh.numpy().view(np.uint32)
    tw, tw_sh = (ipsis, ipsh) if inverse else (psis, psh)
    out = np.zeros((B, L, n), dtype=np.uint64)
    rows = np.arange(B)[:, None]

    def loaded(li):  # the first pass's rows of limb li, through perm
        r = buf[:, loff + li]
        if perm is None:
            return r
        return r[rows, perm] if perm.shape[0] > 1 else r[:, perm[0]]

    def limb(li):
        k = int(idx[li])
        return (k, np.uint64(qs[k]), tw[k].astype(np.uint64), tw_sh[k].astype(np.uint64),
                (ninv[k], ninv_sh[k]))

    def boundary():  # the round trip through out, between the passes
        for li in range(L):
            q = np.uint64(qs[idx[li]])
            _lazy(q, out[:, li])
            if seen is not None:
                seen.append((int(out[:, li].max()), int(q)))

    def row_pass(first, last):
        if rb > 1:
            emulate_rows_batch(mem, loff * n, lfull * n, pflat, pb, out.reshape(-1), first,
                               last, idx, L, B, rb, logn, tw, tw_sh, qs, ninv, ninv_sh, inverse)
            return
        for li in range(L):
            _, q, t, tsh, div = limb(li)
            src = loaded(li) if first else out[:, li]
            out[:, li] = emulate_rows_alone(src, t, tsh, q, a, inverse,
                                            div=div if inverse and last else None,
                                            canon=not inverse)

    if not inverse:
        if a:
            for li in range(L):
                _, q, t, tsh, _ = limb(li)
                out[:, li] = emulate_cols(loaded(li).reshape(B, 1 << a, 1 << BITS), t, tsh, q,
                                          False).reshape(B, n)
            boundary()
        row_pass(a == 0, 1)
    else:
        row_pass(1, a == 0)
        if a:
            boundary()
            for li in range(L):
                _, q, t, tsh, div = limb(li)
                out[:, li] = emulate_cols(out[:, li].reshape(B, 1 << a, 1 << BITS), t, tsh, q,
                                          True, div=div).reshape(B, n)
    for li in range(L):
        assert (out[:, li] < qs[idx[li]]).all(), "an output is not canonical"
    return out.astype(np.int32)


def _residues(B, primes, n):
    return np.stack([RNG.integers(0, q, size=(B, n)) for q in primes], axis=1).astype(np.uint32)


def _perms(plan, B, n):
    return np.stack([plan.auto_perm(pow(5, r, 2 * n)) for r in range(1, B + 1)])


def _check(jp, tp, primes, x, limbs, inverse, perm, got):
    """got against the plain transform and JAX's, and its first and last
    batch rows (the last in the last row group) against the host
    transform (which takes seconds a limb at 45 rows of 2^15)."""
    n = x.shape[-1]
    xt = tntt.permute_rows(tmm.to_tensor(x, "cpu"), None if perm is None
                           else torch.from_numpy(perm))
    want = (tp.inv if inverse else tp.fwd)(xt, limbs).numpy()
    np.testing.assert_array_equal(got, want)
    ends = [0, x.shape[0] - 1]
    xp = xt.numpy()[ends].view(np.uint32).astype(np.uint64)
    for i, li in enumerate(limbs):
        q = primes[li]
        h = (tntt.host_ntt_inv(xp[:, i], q, tp.ipsis_np[li], pow(n, -1, q)) if inverse
             else tntt.host_ntt_fwd(xp[:, i], q, tp.psis_np[li]))
        np.testing.assert_array_equal(got[ends, i].view(np.uint32), h.astype(np.uint32))
    jx = jnp.asarray(xt.numpy().view(np.uint32))
    jw = np.asarray((jp.inv if inverse else jp.fwd)(jx, limbs))
    np.testing.assert_array_equal(got.view(np.uint32), jw.view(np.uint32))


@pytest.mark.parametrize("batch", [1, 2, 15, 45])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("permuted", [False, True])
def test_batched_row_pass_emulated_bit_exact(batch, inverse, permuted):
    """The batched row pass at HyDia's 20 limbs, N = 2^15, batch rows 1, 2,
    15 and 45 (the giant steps' ModUp), R' the launcher's or, where that
    keeps a block a row, 2 (a short last group at B = 15 and 45)."""
    n = 1 << 15
    jp, tp, primes = _plans(n)
    limbs = tuple(range(20))
    x = _residues(batch, primes, n)
    perm = _perms(tp, batch, n) if permuted else None
    rb = max(tntt.rows_per_block(batch, 20, 15), 2)
    got = emulate_k1(tp, x, limbs, inverse, perm, rb=rb)
    _check(jp, tp, primes, x, limbs, inverse, perm, got)


@pytest.mark.parametrize("inverse", [False, True])
def test_batched_row_pass_shared_perm_and_limb_slice(inverse):
    """A mod-down's special limbs (14..19) read in place from [B, 20, N]
    rows (a batch stride of 20 N), through one permutation every row
    shares, at R' 3 (a short last group of 15 rows)."""
    n = 1 << 15
    jp, tp, primes = _plans(n)
    limbs = tuple(range(14, 20))
    x = _residues(15, [primes[i] for i in limbs], n)
    perm = _perms(tp, 2, n)[1:]
    got = emulate_k1(tp, x, limbs, inverse, perm, lfull=20, loff=14, rb=3)
    _check(jp, tp, primes, x, limbs, inverse, perm, got)


@pytest.mark.parametrize("inverse", [False, True])
def test_batched_row_pass_alone_at_n256(inverse):
    """N = 2^8: one pass, the row pass, is the forward's first (reading
    through a per-row permutation) and the inverse's last (with 1/N)."""
    n = 1 << 8
    jp, tp, primes = _plans(n)
    limbs = (0, 5, 19)
    x = _residues(5, [primes[i] for i in limbs], n)
    perm = _perms(tp, 5, n)
    got = emulate_k1(tp, x, limbs, inverse, perm, rb=2)
    _check(jp, tp, primes, x, limbs, inverse, perm, got)


def test_rows_per_block_fills_the_card():
    """The launcher takes the first R' of ROWS_PER_BLOCK whose grid, L x
    ceil(B / R') row groups of 2^(logn - 10) tiles, holds that R''s least
    number of blocks, and keeps a block a row (R' = 1) for one batch row
    or where none does; at the main path's shapes (N = 2^15) as the H100
    sweep chose."""
    for B, L in ((1, 20), (1, 1), (2, 1), (2, 14), (3, 20), (45, 20), (48, 20), (30, 14),
                 (30, 6), (32, 14), (8, 20), (32, 6), (32, 4), (16, 8), (32, 2), (16, 4),
                 (32, 1), (16, 3)):
        rb = tntt.rows_per_block(B, L, 15)
        blocks = lambda r: L * -(-B // r) * 32  # noqa: E731
        fits = [r for r, least in tntt.ROWS_PER_BLOCK if B >= r and blocks(r) >= least]
        assert rb == (fits[0] if fits else 1), (B, L)
    want = {(1, 20): 1, (2, 14): 1, (45, 20): 8, (48, 20): 8, (30, 14): 8, (32, 14): 8,
            (8, 20): 8, (30, 6): 8, (32, 6): 8, (32, 4): 4, (16, 8): 4, (32, 2): 4, (16, 4): 4,
            (32, 1): 1}
    assert {k: tntt.rows_per_block(*k, 15) for k in want} == want
    # N = 2^8: a row is one tile of one sub-block
    assert tntt.rows_per_block(64, 20, 8) == 1 and tntt.rows_per_block(512, 20, 8) == 8

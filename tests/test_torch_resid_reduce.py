"""The arithmetic and index maps of the port's residue kernels (K7
``csrc/rescale.cu``: the lift and sub-scale passes; K11
``csrc/modarith.cu``: the elementwise and row-sum passes) emulated in numpy
uint64.

No GPU is needed: the emulation repeats each kernel's arithmetic step by
step (the lift's REDC, centring and ``mont_mul(s, R^2)`` in place of
``reduce_small``; the row sum's 64-bit sum reduced by ``mont(hi, R^2) +
mont(lo, R)``) and its launcher's index maps (V = 4 coefficients a thread
or V = 1 where an operand is not 16-byte aligned, the limb from a shift,
the rows over grid y with its loop past the grid's limit, K7's limb split
over grid z, K11's head and pass-through components and its plane and
per-limb operands), reading the operands from their storage through the
offsets and strides the wrappers give the kernels; every output element
is written exactly once.  It is held bit-exact against the plain versions
(``rescale_lift_plain``, ``sub_scale_plain``, ``residue_op_plain``,
``row_sum_plain``) and the JAX package's ``CkksContext.rescale`` and
``senders._mod_sum_rows`` on the real primes of HyDia (14 q limbs, 6
special) and GROTE (21, 8) at ring 32768, with the lift's boundary values
t in {0, qt/2, qt/2 + 1, qt - 1} and rows of q - 1 at R = 128."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.ckks.context import Ciphertext as JCt
from image_matching_tpu.ckks.context import CkksContext as JCtx
from image_matching_tpu.ckks.params import SchemeParams, compute_required_depth
from image_matching_tpu.matching.senders import _mod_sum_rows
from image_matching_tpu_torch.ckks import context as tc
from image_matching_tpu_torch.ckks.context import CkksContext as TCtx
from image_matching_tpu_torch.ops import kernels
from image_matching_tpu_torch.ops import modmath as tmm

from _torch_parity import assert_same, port_params, u32

M32 = np.uint64(0xFFFFFFFF)
S32 = np.uint64(32)
K7_THREADS, K7_MIN_BLOCKS = 128, 528  # csrc/rescale.cu
K11_THREADS = 128                     # csrc/modarith.cu
MAX_GRID_Y = 65535                    # both
RNG = np.random.default_rng(21)


def mont(a, b, q, qneg):
    """modmath.cuh mont_mul on uint64 (a < 2^32, b < q < 2^31; q and qneg
    scalars or arrays)."""
    a, b = np.asarray(a, np.uint64), np.asarray(b, np.uint64)
    q, qneg = np.uint64(q), np.uint64(qneg)
    assert (a <= M32).all() and (b < q).all()
    t = a * b
    m = ((t & M32) * qneg) & M32
    r = (t + m * q) >> S32
    assert (r < 2 * q).all()
    return np.where(r >= q, r - q, r)


def mod_add(a, b, q):
    s = np.asarray(a, np.uint64) + np.asarray(b, np.uint64)
    return np.where(s >= np.uint64(q), s - np.uint64(q), s)


def mod_sub(a, b, q):
    a, b, q = np.asarray(a, np.uint64), np.asarray(b, np.uint64), np.uint64(q)
    return np.where(a >= b, a - b, a + (q - b))


def storage(t: torch.Tensor):
    """(the whole storage under t as uint64, t's element offset in it)."""
    flat = torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())
    return u32(flat).astype(np.uint64), t.storage_offset()


def aligned(off: int) -> bool:
    """A pointer at element ``off`` of a fresh allocation: 16-byte aligned
    exactly when off is a multiple of four."""
    return off % 4 == 0


class Out:
    """A kernel's output buffer [B, l, n] with a count of writes."""

    def __init__(self, B, l, n):
        self.v = np.zeros(B * l * n, np.uint64)
        self.hits = np.zeros(B * l * n, np.int64)

    def put(self, idx, val):
        np.add.at(self.hits, idx, 1)
        self.v[idx] = val

    def done(self, shape):
        assert (self.hits == 1).all(), "an output element was written twice or never"
        return torch.from_numpy(self.v.astype(np.uint32).view(np.int32).reshape(shape))


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------


def k7_grid(B, l, n, V, max_y=MAX_GRID_Y):
    """rescale.cu k7_grid: (blocks x, y, z, limbs per z chunk)."""
    bx = -(-(n // V) // K7_THREADS)
    by = min(B, max_y)
    chunks = min(max(1, -(-K7_MIN_BLOCKS // (bx * by))), l)
    per = -(-l // chunks)
    return bx, by, -(-l // per), per


def thread_coeffs(bx, n, V):
    """The first coefficient of every live thread of a row."""
    k = np.arange(bx * K7_THREADS) * V
    return k[k < n]


def emulate_lift(ctx, top: torch.Tensor, l: int, max_y=MAX_GRID_Y):
    """imtpu_rescale_lift on top [..., 1, N] (any storage offset): out
    [..., l - 1, N]."""
    lead, n, lo = top.shape[:-2], ctx.n, l - 1
    B = int(np.prod(lead)) if lead else 1
    store, off = storage(top)
    V = 4 if n % 4 == 0 and aligned(off) else 1
    qt, qtn = int(ctx.all_primes[l - 1]), int(ctx.qneg_np[l - 1])
    bx, by, bz, per = k7_grid(B, lo, n, V, max_y)
    out = Out(B, lo, n)
    k = thread_coeffs(bx, n, V)
    for z in range(bz):
        for y in range(by):
            for b in range(y, B, by):
                for v in range(V):
                    ts = mont(store[off + b * n + k + v], 1, qt, qtn)
                    assert (ts < qt).all()
                    neg = ts > np.uint64(qt >> 1)
                    s = np.where(neg, np.uint64(qt) - ts, ts)
                    for i in range(z * per, min(lo, z * per + per)):
                        q = int(ctx.q_np[i])
                        u = mont(s, int(ctx.r2_np[i]), q, int(ctx.qneg_np[i]))
                        w = np.where(u == 0, np.uint64(0), np.uint64(q) - u)
                        out.put((b * lo + i) * n + k + v, np.where(neg, w, u))
    return out.done((*lead, lo, n)), V


def emulate_sub_scale(ctx, x, t, cinv32, add=None, perms=None, max_y=MAX_GRID_Y):
    """imtpu_sub_scale with the arguments ``CkksContext._sub_scale`` gives
    it (x read in place through its block stride)."""
    n, l = ctx.n, t.shape[-2]
    xs, B, x_bstride = kernels.row_blocks(x)
    t = t.contiguous()
    xst, xo = storage(xs)
    tst, to = storage(t)
    add_k = add_r = add_c = perm_r = 0
    ast = pst = None
    ao = po = 0
    if add is not None:
        if add.stride(-1) != 1 or add.stride(-2) != n:
            add = add.contiguous()
        add_k, add_c = add.shape[1], add.stride(1)
        add_r = add.stride(0) if add.shape[0] > 1 else 0
        ast, ao = storage(add)
        if perms is not None:
            perms = perms.contiguous()
            perm_r = n if perms.shape[0] > 1 else 0
            pst, po = storage(perms)
    vec = (n % 4 == 0 and aligned(xo) and aligned(to) and x_bstride % 4 == 0
           and (add_k == 0 or perms is not None
                or (aligned(ao) and add_r % 4 == 0 and add_c % 4 == 0))
           and (perms is None or (aligned(po) and perm_r % 4 == 0)))
    V = 4 if vec else 1
    bx, by, bz, per = k7_grid(B, l, n, V, max_y)
    c = u32(cinv32).astype(np.uint64)
    out = Out(B, l, n)
    k = thread_coeffs(bx, n, V)
    for z in range(bz):
        for y in range(by):
            for b in range(y, B, by):
                r, comp = b >> 1, b & 1
                for v in range(V):
                    kv = k + v
                    if comp < add_k:
                        base = ao + r * add_r + comp * add_c
                        src = (pst[po + r * perm_r + kv].astype(np.int64) if perms is not None
                               else kv)
                    for i in range(z * per, min(l, z * per + per)):
                        q, qn = int(ctx.q_np[i]), int(ctx.qneg_np[i])
                        d = mod_sub(xst[xo + b * x_bstride + i * n + kv],
                                    tst[to + (b * l + i) * n + kv], q)
                        val = mont(d, c[i], q, qn)
                        if comp < add_k:
                            val = mod_add(ast[base + i * n + src], val, q)
                        out.put((b * l + i) * n + kv, val)
    return out.done(t.shape), V


# ---------------------------------------------------------------------------
# K11
# ---------------------------------------------------------------------------


def emulate_modarith(ctx, op, a, b, head=None, max_y=MAX_GRID_Y):
    """imtpu_modarith with the arguments ``residue_op`` gives it
    (``modarith_args``)."""
    src, a_bstride, bt, b_bstride, b_mode, kcomp, headk, B, l, n = tmm.modarith_args(
        op, a, b, head)
    ast, ao = storage(src)
    bst, bo = storage(bt) if bt is not None else (None, 0)
    vec = (n % 4 == 0 and aligned(ao) and a_bstride % 4 == 0
           and (op == "neg" or b_mode == 2
                or (aligned(bo) and (b_mode == 1 or b_bstride % 4 == 0))))
    V = 4 if vec else 1
    plane_v = l * n // V
    lg = (n // V).bit_length() - 1
    assert 1 << lg == n // V
    j = np.arange(-(-plane_v // K11_THREADS) * K11_THREADS)
    j = j[j < plane_v]
    e, limb = j * V, j >> lg
    q = ctx.q_np.astype(np.uint64)[limb]
    qn = ctx.qneg_np.astype(np.uint64)[limb]
    out = Out(B, l, n)
    for y in range(min(B, max_y)):
        for blk in range(y, B, min(B, max_y)):
            ct = blk // kcomp
            comp = blk - ct * kcomp
            for v in range(V):
                x = ast[ao + blk * a_bstride + e + v]
                dst = blk * l * n + e + v
                if comp >= headk:
                    out.put(dst, x)
                    continue
                if b_mode == 0 and op != "neg":
                    yv = bst[bo + (ct * headk + comp) * b_bstride + e + v]
                elif b_mode == 1:
                    yv = bst[bo + e + v]
                elif b_mode == 2:
                    yv = bst[bo + limb]
                if op == "add":
                    r = mod_add(x, yv, q)
                elif op == "sub":
                    r = mod_sub(x, yv, q)
                elif op == "neg":
                    r = np.where(x == 0, x, q - x)
                else:
                    r = mont(x, yv, q, qn)
                out.put(dst, r)
    return out.done(a.shape), V


def sum_reduce(s, q, qneg, r1, r2):
    """modarith.cu's reduction of a 64-bit sum: mont(hi, R^2) + mont(lo, R)
    = hi 2^32 + lo mod q."""
    s = np.asarray(s, np.uint64)
    return mod_add(mont(s >> S32, r2, q, qneg), mont(s & M32, r1, q, qneg), q)


def emulate_row_sum(ctx, rows, max_y=MAX_GRID_Y):
    """imtpu_mod_sum with the arguments ``row_sum`` gives it: a block of
    K11_THREADS // 32 warps per 32 vectors of one [l, N] block, warp w
    summing rows w, w + warps, ..., warp 0 adding the partials."""
    l, n = rows.shape[-2], rows.shape[-1]
    if not rows[0].is_contiguous():
        rows = rows.contiguous()
    R, B, rstride = rows.shape[0], rows[0].numel() // (l * n), rows.stride(0)
    st, off = storage(rows)
    V = 4 if n % 4 == 0 and aligned(off) and rstride % 4 == 0 else 1
    W = K11_THREADS // 32
    plane_v = l * n // V
    lg = (n // V).bit_length() - 1
    # block bx, lane t: vector bx * 32 + t (every block alike, so all at once)
    j = np.arange(-(-plane_v // 32) * 32)
    j = j[j < plane_v]
    e, limb = j * V, j >> lg
    out = Out(B, l, n)
    for y in range(min(B, max_y)):
        for blk in range(y, B, min(B, max_y)):
            for v in range(V):
                part = []
                for w in range(W):
                    s = np.zeros(e.shape, np.uint64)
                    for r in range(w, R, W):
                        s = s + st[off + blk * l * n + e + v + r * rstride]
                    part.append(s)
                s = sum(part[1:], part[0])
                val = np.empty(e.shape, np.uint64)
                for i in np.unique(limb):
                    sel = limb == i
                    val[sel] = sum_reduce(s[sel], int(ctx.q_np[i]), int(ctx.qneg_np[i]),
                                          int(u32(ctx.r1_32)[i]), int(ctx.r2_np[i]))
                out.put(blk * l * n + e + v, val)
    return out.done(rows.shape[1:]), V


# ---------------------------------------------------------------------------
# fixtures and inputs
# ---------------------------------------------------------------------------


def _pair(approach):
    p = SchemeParams.create(mult_depth=compute_required_depth(approach, 10, 2))
    return JCtx(p, seed=3), TCtx(port_params(p), seed=3, device="cpu")


@pytest.fixture(scope="module")
def real():
    """HyDia's and GROTE's contexts at ring 32768 (their real primes)."""
    return {"HyDia": _pair(5), "GROTE": _pair(2)}


def _rows(ctx, shape, limbs):
    return tmm.to_tensor(np.stack([RNG.integers(0, ctx.all_primes[i], size=shape + (ctx.n,))
                                   for i in limbs], axis=-2).astype(np.uint32), "cpu")


def _misaligned(t):
    """A contiguous copy of t starting one element (4 bytes) past a
    16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)[1:]
    out = flat.view(t.shape)
    out.copy_(t)
    assert out.storage_offset() == 1
    return out


def _top(ctx, shape, l):
    """Coefficient-domain Montgomery residues of the top prime q_{l-1}
    whose standard values hit 0, qt/2, qt/2 + 1 and qt - 1 first, then
    random ones."""
    qt = int(ctx.all_primes[l - 1])
    ts = RNG.integers(0, qt, size=shape + (ctx.n,))
    flat = ts.reshape(-1)
    flat[:4] = [0, qt // 2, qt // 2 + 1, qt - 1]
    return tmm.to_tensor((ts * (1 << 32) % qt).astype(np.uint32), "cpu")[..., None, :]


# ---------------------------------------------------------------------------
# K7 lift
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chain", ["HyDia", "GROTE"])
def test_lift_arithmetic_every_boundary(real, chain):
    """mont_mul(s, R^2 mod q) == reduce_small(s, q) * R mod q and the
    branch-free select equal the JAX lift for every boundary t of every
    level's top prime into every lower limb."""
    _, tctx = real[chain]
    for l in range(2, tctx.Lq + 1):
        qt = int(tctx.all_primes[l - 1])
        ts = np.array([0, 1, qt // 2 - 1, qt // 2, qt // 2 + 1, qt - 2, qt - 1], np.uint64)
        neg = ts > np.uint64(qt >> 1)
        s = np.where(neg, np.uint64(qt) - ts, ts)
        for i in range(l - 1):
            q, R = int(tctx.q_np[i]), 1 << 32
            u = mont(s, int(tctx.r2_np[i]), q, int(tctx.qneg_np[i]))
            got = np.where(neg, np.where(u == 0, 0, q - u), u)
            want = [(int(t) if t <= qt // 2 else -(qt - int(t))) % q * R % q for t in ts]
            assert got.tolist() == want, (l, i)


@pytest.mark.parametrize("chain", ["HyDia", "GROTE"])
@pytest.mark.parametrize("B,l", [(32, 14), (32, 10), (2, 14), (32, 3), (1, 2)])
def test_lift_launch_matches_plain(real, chain, B, l):
    """The lift's launch at the main path's shapes (the compare stack of
    16 x 2 rows, one ciphertext, the lowest level with one limb out; grid
    z splits the limbs of the small launches), aligned and misaligned."""
    _, tctx = real[chain]
    top = _top(tctx, (B,), l)
    want = tc.rescale_lift_plain(tctx, top, l)
    got, V = emulate_lift(tctx, top, l)
    assert V == 4
    assert_same(got, want)
    got1, V1 = emulate_lift(tctx, _misaligned(top), l)
    assert V1 == 1
    assert_same(got1, want)


def test_lift_grid_splits_and_loops():
    """k7_grid: a launch of few rows splits its limbs over z until it has
    528 blocks; past the grid's y limit the rows loop."""
    assert k7_grid(32, 13, 32768, 4) == (64, 32, 1, 13)
    assert k7_grid(2, 13, 32768, 4) == (64, 2, 5, 3)
    assert k7_grid(1, 1, 32768, 4) == (64, 1, 1, 1)
    assert k7_grid(2, 13, 512, 1) == (4, 2, 13, 1)
    assert k7_grid(70000, 3, 512, 4)[1] == MAX_GRID_Y


@pytest.mark.parametrize("chain", ["HyDia", "GROTE"])
def test_emulated_rescale_matches_jax(real, chain):
    """The whole rescale of [2, l, N] with the emulated lift and sub-scale
    around the plain NTTs, with the boundary t at four coefficients, equals
    the JAX CkksContext.rescale at the top level and a low one."""
    jctx, tctx = real[chain]
    for l in (tctx.Lq, 3):
        x = _rows(tctx, (2,), range(l))
        top_c = _top(tctx, (2,), l)
        x[:, l - 1] = tctx.plan.fwd_plain(top_c, (l - 1,))[:, 0]
        assert torch.equal(tctx.plan.inv_plain(x[:, l - 1:l], (l - 1,)), top_c)
        lift, _ = emulate_lift(tctx, top_c, l)
        t = tctx.plan.fwd_plain(lift, tctx.q_limbs(l - 1))
        got, _ = emulate_sub_scale(tctx, x, t, tctx._qtinv(l)[1])
        want = jctx.rescale(JCt(jnp.asarray(u32(x)), 2.0 ** 40)).data
        assert_same(got, want)
        assert_same(got, tc.rescale_plain(tctx, x))


# ---------------------------------------------------------------------------
# K7 sub-scale
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chain", ["HyDia", "GROTE"])
@pytest.mark.parametrize("form", ["giant steps", "relinearization", "shared perm",
                                  "broadcast addend", "rescale stack", "one ciphertext",
                                  "misaligned addend"])
def test_sub_scale_launch_matches_plain(real, chain, form):
    """The sub-scale pass of a mod-down (x the first l of l + S limbs, read
    in place) with a rotation's c0 gathered per row or through one shared
    permutation, a relinearization's two components, a broadcast addend,
    and of a rescale (x one limb more than t); a misaligned addend takes
    V = 1 without a permutation and keeps V = 4 with one."""
    _, tctx = real[chain]
    n, l = tctx.n, 5
    ext = tctx.ext_limbs(l)
    perms = torch.from_numpy(np.stack([tctx.plan.auto_perm(tctx.rotation_galois(r))
                                       for r in (1, 2, 3)]))
    pinv = tctx._pinv(l)
    R = 3
    add = p = None
    x = _rows(tctx, (R, 2), ext)
    cinv = pinv
    if form == "giant steps":
        add, p = _rows(tctx, (R, 1), range(l)), perms
    elif form == "relinearization":
        add = _rows(tctx, (R, 2), range(l))
    elif form == "shared perm":
        add, p = _rows(tctx, (1, 1), range(l)), perms[1:2]
    elif form == "broadcast addend":
        add = _rows(tctx, (1, 2), range(l))
    elif form == "misaligned addend":
        add = _misaligned(_rows(tctx, (R, 1), range(l)))
    elif form == "rescale stack":
        x, cinv = _rows(tctx, (R, 2), range(l + 1)), tctx._qtinv(l + 1)
    else:
        x, cinv, R = _rows(tctx, (2,), range(l + 1)), tctx._qtinv(l + 1), None
    t = _rows(tctx, (R, 2) if R else (2,), range(l))
    want = tc.sub_scale_plain(tctx, x, t, cinv[0], add, p)
    got, V = emulate_sub_scale(tctx, x, t, cinv[1], add, p)
    assert V == (1 if form == "misaligned addend" else 4)
    assert_same(got, want)
    if form == "misaligned addend":
        got, V = emulate_sub_scale(tctx, x, t, cinv[1], add, perms)
        assert V == 4
        assert_same(got, tc.sub_scale_plain(tctx, x, t, cinv[0], add, perms))
    # rows 1.. alone (their blocks start past row 0), one row per grid y
    a1 = None if add is None or add.shape[0] == 1 else add[1:]
    p1 = None if p is None or p.shape[0] == 1 else p[1:]
    got, _ = emulate_sub_scale(tctx, x[1:], t[1:], cinv[1], a1, p1, max_y=1)
    assert_same(got, tc.sub_scale_plain(tctx, x[1:], t[1:], cinv[0], a1, p1))


# ---------------------------------------------------------------------------
# K11 elementwise
# ---------------------------------------------------------------------------

FORMS = ["add same", "sub same", "neg", "mul same", "mul plane", "mul limb", "add_scalar head",
         "add unequal components", "dropped-limb view", "misaligned a", "misaligned b",
         "grid y loop"]


@pytest.mark.parametrize("chain", ["HyDia", "GROTE"])
@pytest.mark.parametrize("form", FORMS)
def test_modarith_launch_matches_plain(real, chain, form):
    """K11's elementwise pass over a compare stack [4, 2, l, N] (the main
    path's is 16 x 2): same-shape, plane and per-limb operands, the head
    with pass-through components, a dropped-limb view read in place, a
    misaligned operand (V = 1), and rows looping past a grid y limit."""
    _, tctx = real[chain]
    l = 6
    m = tctx._mod(l)
    big = _rows(tctx, (4, 2), range(l + 2))
    a = big[..., :l, :].contiguous()
    b = _rows(tctx, (4, 2), range(l))
    const = tctx._mont_const(987654321, tctx.q_limbs(l))
    op, y, head, want_v, max_y = "add", b, None, 4, MAX_GRID_Y
    if form == "sub same":
        op = "sub"
    elif form == "neg":
        op, y = "neg", None
    elif form == "mul same":
        op = "mul"
    elif form == "mul plane":
        op, y = "mul", _rows(tctx, (), range(l))
    elif form == "mul limb":
        op, y = "mul", const
    elif form == "add_scalar head":
        y, head = const, 1
    elif form == "add unequal components":
        y, head = b[:, :1], 1
    elif form == "dropped-limb view":
        a = big[..., :l, :]
    elif form == "misaligned a":
        a, want_v = _misaligned(a), 1
    elif form == "misaligned b":
        y, want_v = _misaligned(b), 1
    elif form == "grid y loop":
        op, y, max_y = "mul", const, 3
    got, V = emulate_modarith(tctx, op, a, y, head, max_y)
    assert V == want_v
    assert_same(got, tmm.residue_op_plain(op, a, y, m.q, m.rinv, head))


def test_modarith_matches_jax_ops(real):
    """The emulated elementwise pass against the JAX package's mod_add,
    mod_sub, mod_neg and mont_mul on HyDia's primes at the top level."""
    from image_matching_tpu.ops import modmath as jmm

    jctx, tctx = real["HyDia"]
    l = tctx.Lq
    a, b = _rows(tctx, (2,), range(l)), _rows(tctx, (2,), range(l))
    jq, jqneg = jctx._qrow(tuple(range(l)))
    ja, jb = jnp.asarray(u32(a)), jnp.asarray(u32(b))
    for op, want in [("add", jmm.mod_add(ja, jb, jq)), ("sub", jmm.mod_sub(ja, jb, jq)),
                     ("neg", jmm.mod_neg(ja, jq)), ("mul", jmm.mont_mul(ja, jb, jq, jqneg))]:
        assert_same(emulate_modarith(tctx, op, a, None if op == "neg" else b)[0], want)


# ---------------------------------------------------------------------------
# K11 row sum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chain", ["HyDia", "GROTE"])
def test_row_sum_reduction_exact_for_any_sum(real, chain):
    """mont(hi, R^2) + mont(lo, R) == s mod q for every 64-bit sum the
    pass can form (R < 2^32 rows of residues below 2^31): the extremes
    and random sums, every prime of the chain."""
    _, tctx = real[chain]
    r1 = u32(tctx.r1_32)
    for i in range(tctx.Ltot):
        q = int(tctx.q_np[i])
        top = ((1 << 32) - 1) * (q - 1)  # 2^32 - 1 rows of q - 1
        s = [0, 1, q - 1, q, (1 << 32) - 1, 1 << 32, 128 * (q - 1), top, top - 1]
        s += [int(v) for v in RNG.integers(0, top, size=64, dtype=np.uint64)]
        got = sum_reduce(np.array(s, np.uint64), q, int(tctx.qneg_np[i]), int(r1[i]),
                         int(tctx.r2_np[i]))
        assert got.tolist() == [v % q for v in s], i


@pytest.mark.parametrize("chain", ["HyDia", "GROTE"])
@pytest.mark.parametrize("R,form", [(1, "plain"), (15, "plain"), (64, "plain"),
                                    (128, "q - 1"), (15, "strided"), (15, "misaligned")])
def test_row_sum_launch_matches_plain_and_jax(real, chain, R, form):
    """The row sum's launch over R rows of [2, l, N] (HyDia's giant steps
    R = 15, the flags' R = 64 at l = 2, R = 128 of all q - 1): rows read
    through a stride, a misaligned stack (V = 1), equal to row_sum_plain
    and to the JAX _mod_sum_rows."""
    jctx, tctx = real[chain]
    l = 2 if R == 64 else 4
    m = tctx._mod(l)
    rows = _rows(tctx, (R, 2), range(l))
    if form == "q - 1":
        rows = (m.q - 1).int().expand(R, 2, l, tctx.n).contiguous()
    elif form == "strided":
        rows = _rows(tctx, (R, 2, 2), range(l))[:, 1]
    elif form == "misaligned":
        rows = _misaligned(rows)
    got, V = emulate_row_sum(tctx, rows)
    assert V == (1 if form == "misaligned" else 4)
    want = tmm.row_sum_plain(rows, m.q)
    assert_same(got, want)
    jq, _ = jctx._qrow(tuple(range(l)))
    assert_same(got, _mod_sum_rows(jnp.asarray(u32(rows)), jq))

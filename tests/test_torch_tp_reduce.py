"""The index maps of tensor parallelism's kernel variants (parallel/tensor.py)
emulated in numpy uint64, in the style of the other ``*_reduce`` tests.

No GPU is needed:
  * K1's passes alone (``imtpu_ntt_pass``, ``csrc/ntt.cu``) run behind the
    port's own wrappers, ``NttPlan.launch_pass`` and a slot shard's
    ``ShardPlan._kernel`` (its two all-to-alls on a CPU mesh), with
    ``kernels.launch`` replaced by an emulation that reads every operand
    through its address as the kernel does: the launcher's checks and
    grids (32 columns a column-pass block, 2^lsb sub-blocks a row-pass
    block), the column pass over a shard's [2^a, 256/D] column block at
    column stride 2^(logw - a), the row pass over the shard's sub-blocks
    with the staged twiddles of ``stage_twiddles`` at the global sub-block
    (local + blk_off) and the products c_v * psis[g] of table blocks 5-7,
    the source read at its batch and limb strides (a full-width source
    through the permutation's global indices); every output element is
    written exactly once.  Each pass is held against the plain split
    stages (``ntt_fwd_stages`` / ``ntt_inv_stages``), and the sharded
    transforms against the whole plan, with and without a rotation's
    gather;
  * K4's digit loads (``csrc/keyswitch.cu``) and K7's gathered sub-scale
    addend (``csrc/rescale.cu``) from a full-width source, with the
    arguments their wrappers give (K7 behind ``CkksContext._sub_scale``
    itself), against the plain versions and the single-device result.
Ring 32768 at D = 4 and 8 (HyDia's primes) and a small ring."""

import copy
import ctypes
import math

import numpy as np
import pytest
import torch

from image_matching_tpu.ckks.params import SchemeParams, compute_required_depth, root_of_unity
from image_matching_tpu_torch.ckks import context as tc
from image_matching_tpu_torch.ckks.context import CkksContext as TCtx
from image_matching_tpu_torch.ops import kernels
from image_matching_tpu_torch.ops import modmath as tmm
from image_matching_tpu_torch.ops import ntt as tntt
from image_matching_tpu_torch.parallel import sharded, tensor

from _torch_parity import assert_same, port_params
from test_torch_resid_reduce import (Out, aligned, limb_split_grid, mod_add, mod_sub, mont,
                                     thread_coeffs)

RNG = np.random.default_rng(31)
KS, NT = 5, 128  # ntt.cu: staged twiddle blocks of the row pass, psis[0..NT)
PRIMES = SchemeParams.create(mult_depth=compute_required_depth(5, 10, 2)).q_primes


def at(addr, count, ctype=ctypes.c_uint32):
    """``count`` elements at a CPU tensor's address, as uint64 (int64 for
    the signed types)."""
    a = np.ctypeslib.as_array((ctype * count).from_address(addr))
    return a.astype(np.int64 if ctype is ctypes.c_int32 else np.uint64)


class Mem:
    """A writable uint32 buffer at an address, with a count of writes."""

    def __init__(self, addr, count):
        self.v = np.ctypeslib.as_array((ctypes.c_uint32 * count).from_address(addr))
        self.hits = np.zeros(count, np.int64)

    def put(self, idx, val):
        np.add.at(self.hits, idx, 1)
        self.v[idx] = val.astype(np.uint32)

    def check(self):
        assert (self.hits == 1).all(), "an output element was written twice or never"


def _ct(x, v, w, q):
    t = v * w % q
    return np.where(x + t >= q, x + t - q, x + t), np.where(x >= t, x - t, x + q - t)


def _gs(x, v, w, q):
    s, d = x + v, np.where(x >= v, x - v, x + q - v)
    return np.where(s >= q, s - q, s), d * w % q


def emulate_ntt_pass(passes):
    """A stand-in for ``kernels.launch`` running ``imtpu_ntt_pass`` on CPU
    tensors; appends (counter, cols, blk_off, grid y) of each launch."""

    def launch(entry, counter, out, src, in_bstride, in_lstride, perm, perm_bstride, limb_idx,
               rows, L, logn, logw, cols, blk_off, tw, tw_sh, qs, ninv, ninv_sh, inverse):
        assert entry == "imtpu_ntt_pass"
        a = logn - 8
        # the launcher's checks
        assert a >= 1 and logn <= 16 and 8 <= logw <= logn and rows > 0 and L >= 1
        assert blk_off >= 0 and blk_off + (1 << (logw - 8)) <= 1 << a
        assert not cols or (logw - a >= 5 and perm == 0)
        n, w = 1 << logn, 1 << logw
        batch = rows // L
        limbs = at(limb_idx, L, ctypes.c_int32)
        nlimb = int(limbs.max()) + 1
        table = at(tw, nlimb * n).reshape(nlimb, n)
        q_all, ni_all = at(qs, nlimb), at(ninv, nlimb)
        src_m = at(src, (batch - 1) * in_bstride + L * in_lstride)
        pr = at(perm, (batch - 1) * perm_bstride + w, ctypes.c_int32) if perm else None
        dst = Mem(out.data_ptr(), rows * w)
        now = dst.v.astype(np.uint64)  # the inverse column pass reads out
        if cols:
            b, gy, E = logw - a, 1 << (logw - a - 5), 1 << a
            for row in range(rows):
                li, bi = row % L, row // L
                limb = int(limbs[li])
                q, tr = q_all[limb], table[limb]
                stw = np.array([tr[(1 << v) + e - ((1 << v) - 1)]  # stage_twiddles, P = 0
                                for e in range(E - 1) for v in [int(math.log2(e + 1))]])
                i = np.arange(E)
                for by in range(gy):
                    j = (by << 5) + np.arange(32)
                    idx = j[None, :] + (i[:, None] << b)
                    x = (now[row * w + idx] if inverse
                         else src_m[bi * in_bstride + li * in_lstride + idx])
                    for u in range(a):  # forward: bit a-1-u, block u; inverse: bit u, block a-1-u
                        h, blk = (1 << u, a - 1 - u) if inverse else (E >> (u + 1), u)
                        y = x.reshape(-1, 2, h, 32)
                        wv = stw[(1 << blk) - 1 + np.arange(y.shape[0])][:, None, None]
                        f = _gs if inverse else _ct
                        y0, y1 = f(y[:, 0], y[:, 1], wv, q)
                        x = np.stack([y0, y1], 1).reshape(E, 32)
                    if inverse:
                        x = x * ni_all[limb] % q
                    dst.put(row * w + idx, x)
            gy_out = gy
        else:
            sub = logw - 8
            lsb = min(sub, 2)
            gy_out = 1 << (sub - lsb)
            for row in range(rows):
                li, bi = row % L, row // L
                limb = int(limbs[li])
                q, tr = q_all[limb], table[limb]
                tt = tr[:NT]
                for by in range(gy_out):
                    blk0 = by << lsb
                    gblk0 = blk0 + blk_off
                    stw = []
                    for e in range(((1 << KS) - 1) << lsb):  # stage_twiddles(P = a, K = KS)
                        v = int(math.log2((e >> lsb) + 1))
                        stw.append(tr[(1 << (a + v)) + (gblk0 << v) + e - (((1 << v) - 1) << lsb)])
                    stw = np.array(stw)
                    for warp in range(1 << lsb):
                        base = (blk0 + warp) << 8
                        pos = base + np.arange(256)
                        sidx = pr[bi * perm_bstride + pos] if pr is not None else pos
                        x = src_m[bi * in_bstride + li * in_lstride + sidx]
                        c = [tr[(1 << (a + v)) + ((gblk0 + warp) << v)] for v in range(KS, 8)]
                        for st in range(8):
                            # forward stage st: bit 7-st, table block st;
                            # inverse stage st: bit st, table block 7-st
                            v = 7 - st if inverse else st
                            h = 1 << st if inverse else 128 >> st
                            y = x.reshape(-1, 2, h)
                            g = np.arange(y.shape[0])
                            if v < KS:
                                wv = stw[(((1 << v) - 1) << lsb) + (warp << v) + g][:, None]
                                y0, y1 = (_gs if inverse else _ct)(y[:, 0], y[:, 1], wv, q)
                            else:  # the product of c_v and psis[g]: two Shoup steps
                                if inverse:
                                    y0, d = _gs(y[:, 0], y[:, 1], np.uint64(1), q)
                                    y1 = d * tt[g][:, None] % q * c[v - KS] % q
                                else:
                                    t = y[:, 1] * tt[g][:, None] % q * c[v - KS] % q
                                    y0, y1 = _ct(y[:, 0], t, np.uint64(1), q)
                            x = np.stack([y0, y1], 1).reshape(256)
                        dst.put(row * w + pos, x)
        dst.check()
        passes.append((counter, bool(cols), blk_off, gy_out))
        kernels.count(counter)

    return launch


@pytest.fixture
def emulated(monkeypatch):
    passes = []
    monkeypatch.setattr(kernels, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "launch", emulate_ntt_pass(passes))
    return passes


def _plan(n, nlimbs=2):
    primes = PRIMES[:nlimbs]
    return tntt.NttPlan(n, primes, [root_of_unity(q, 2 * n) for q in primes], device="cpu")


def _data(plan, lead):
    return torch.tensor(np.stack([RNG.integers(0, q, lead + (plan.n,)) for q in plan.primes],
                                 axis=-2).astype(np.int64)).int()


CASES = [(32768, 4), (32768, 8), (2048, 2), (512, 2)]


@pytest.mark.parametrize("n,D", CASES)
def test_ntt_passes_match_split_stages(emulated, n, D):
    """Each pass alone, at every shard s: the column pass (forward and
    inverse, in place) on a [2^a, 256/D] column block, the row pass at
    blk_off = s 2^a / D (forward; inverse from the shard's own rows and
    from a full-width source through a rotation's global indices)."""
    plan = _plan(n)
    limbs, L = (0, 1), 2
    a = plan.logn - 8
    E, w = 1 << a, n // D
    psis, ipsis, q = plan.psis, plan.ipsis, plan.q.long()
    ninv = plan.ninv.long().view(L, 1)
    full = _data(plan, (2,))
    perm_full = torch.from_numpy(np.stack([plan.auto_perm(pow(5, r, 2 * n)) for r in (1, 7)]))
    for s in (0, D - 1):
        cols = _data(plan, (2,))[..., :w]  # a [2, L, 2^a x 256/D] column block
        got = plan.launch_pass(torch.empty_like(cols), cols, limbs, False, True)
        want = tntt.ntt_fwd_stages(cols.long(), psis, q, 1, E, inner=w // E)
        assert_same(got, want.int())
        inv = cols.clone()
        plan.launch_pass(inv, inv, limbs, True, True)
        want = tntt.ntt_inv_stages(cols.long(), ipsis, q, 1, E, inner=w // E) * ninv % q.view(L, 1)
        assert_same(inv, want.int())
        rows = full[..., s * w:(s + 1) * w]
        off = s * E // D
        got = plan.launch_pass(torch.empty_like(cols), rows.contiguous(), limbs, False, False, off)
        assert_same(got, tntt.ntt_fwd_stages(rows.long(), psis, q, E, n, nblk=D, blk=s).int())
        got = plan.launch_pass(torch.empty_like(cols), rows.contiguous(), limbs, True, False, off)
        assert_same(got, tntt.ntt_inv_stages(rows.long(), ipsis, q, E, n, nblk=D, blk=s).int())
        own = perm_full[:, s * w:(s + 1) * w]
        got = plan.launch_pass(torch.empty_like(cols), full, limbs, True, False, off, own)
        src = tntt.permute_rows(full, perm_full)[..., s * w:(s + 1) * w]
        assert_same(got, tntt.ntt_inv_stages(src.long(), ipsis, q, E, n, nblk=D, blk=s).int())
    assert {(p[0], p[1]) for p in emulated} == {("ntt_fwd_cols", True), ("ntt_inv_cols", True),
                                                 ("ntt_fwd_rows", False), ("ntt_inv_rows", False)}


@pytest.mark.parametrize("n,D", CASES)
def test_sharded_kernel_route_matches_whole_transform(emulated, n, D):
    """``ShardPlan._kernel`` on a CPU mesh of D shards (its all-to-alls
    and pass arguments, the passes emulated) equals the whole plain
    transform: forward, inverse, and the inverse of a rotation gathered
    from the all-gathered source, one permutation per batch row."""
    plan = _plan(n)
    limbs = (0, 1)
    w = n // D
    mesh = sharded.make_mesh(devices=["cpu"] * D)
    ex = tensor.Exchange(D)
    plans = [tensor.ShardPlan(plan, s, ex) for s in range(D)]
    x = _data(plan, (2,))
    perm_full = torch.from_numpy(np.stack([plan.auto_perm(pow(5, r, 2 * n)) for r in (3, 1)]))

    def each(fn):
        return torch.cat(tensor.run_shards(mesh, ex, fn), dim=-1)

    part = lambda t, s: t[..., s * w:(s + 1) * w]  # noqa: E731
    fwd = each(lambda s: plans[s]._kernel(part(x, s), limbs, False))
    assert_same(fwd, plan.fwd(x, limbs))
    inv = each(lambda s: plans[s]._kernel(part(x, s), limbs, True))
    assert_same(inv, plan.inv(x, limbs))
    # a strided view in (the top limb of a rescale, read in place)
    top = each(lambda s: plans[s]._kernel(part(x, s)[:, 1:], (1,), True))
    assert_same(top, plan.inv(x[:, 1:].contiguous(), (1,)))
    rot = each(lambda s: plans[s]._kernel(x, limbs, True, part(perm_full, s)))
    assert_same(rot, plan.inv(tntt.permute_rows(x, perm_full), limbs))
    assert ex.bytes["all_to_all"] == 2 * 4 * (2 * 2 + 2 * 2 + 2 + 2 * 2) * (D - 1) * w
    offs = sorted({p[2] for p in emulated if not p[1]})
    assert offs == [s * (1 << (plan.logn - 8)) // D for s in range(D)]


def test_ntt_pass_checks(emulated):
    """Layouts the launcher refuses never reach the kernel."""
    plan = _plan(2048)
    x = _data(plan, ())
    with pytest.raises(ValueError):  # a full-width source without a permutation
        plan.launch_pass(torch.empty_like(x[..., :1024]), x, (0, 1), False, False)
    with pytest.raises(ValueError):  # limbs that do not match the rows
        plan.launch_pass(torch.empty_like(x[..., :1024]), x[..., :1024], (0,), False, False)
    assert not emulated


@pytest.fixture(scope="module")
def hydia():
    """HyDia's context at ring 32768 (its real primes)."""
    p = SchemeParams.create(mult_depth=compute_required_depth(5, 10, 2))
    return TCtx(port_params(p), seed=3, device="cpu")


def _rows(ctx, shape, limbs, n):
    return tmm.to_tensor(np.stack([RNG.integers(0, ctx.all_primes[i], size=shape + (n,))
                                   for i in limbs], axis=-2).astype(np.uint32), "cpu")


def emulate_ks_mac_wide(ctx, digs, ksk, l, perms, n):
    """imtpu_ks_mac with the arguments ``CkksContext._ks_mac`` gives it for
    a shard's n slots: digits [R or 1, ndig, E, src_n] (full width), keys
    [R, dnum, 2, Ltot, n], perms [R, n] of global indices."""
    E, src_n = l + ctx.S, digs.shape[-1]
    ndig = digs.shape[-3]
    d_shared, k_shared = digs.dim() == 3, ksk.dim() == 4
    Rn = perms.shape[0]
    d_rs = 0 if d_shared else ndig * E * src_n
    k_rs = 0 if k_shared else ksk[0].numel()
    dm = at(digs.data_ptr(), digs.numel())
    km = at(ksk.data_ptr(), ksk.numel())
    pm = at(perms.data_ptr(), perms.numel(), ctypes.c_int32)
    out = np.zeros((Rn, 2, E, n), np.uint64)
    x = np.arange(n)
    for r in range(Rn):
        src = pm[r * n + x]
        assert (src < src_n).all()
        for i in range(E):
            limb = i if i < l else ctx.Lq + (i - l)
            q, qn = int(ctx.q_np[limb]), int(ctx.qneg_np[limb])
            acc = [np.zeros(n, np.uint64), np.zeros(n, np.uint64)]
            for j in range(ndig):
                dv = dm[r * d_rs + i * src_n + src + j * E * src_n]
                for c in range(2):
                    kv = km[r * k_rs + limb * n + x + (2 * j + c) * ctx.Ltot * n]
                    acc[c] = mod_add(acc[c], mont(dv, kv, q, qn), q)
            out[r, 0, i], out[r, 1, i] = acc
    return torch.from_numpy(out.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("D", [4, 8])
def test_ks_mac_full_width_digits(hydia, D):
    """K4 gathering a shard's slots from the all-gathered digit stack
    equals the plain version on the same operands and the single-device
    MAC's slice, hoisted (shared digits) and per-row digits."""
    ctx, l = hydia, 3
    n, E = ctx.n, l + ctx.S
    w, s = n // D, D - 2
    ext = ctx.ext_limbs(l)
    q, rinv = ctx._qrow(ext)
    perms = torch.from_numpy(np.stack([ctx.plan.auto_perm(ctx.rotation_galois(r))
                                       for r in (1, 5)]))
    keys = _rows(ctx, (2, 2, 2), range(ctx.Ltot), n)  # [R, dnum=2, 2, Ltot, N]
    for digs in (_rows(ctx, (2,), ext, n), _rows(ctx, (2, 2), ext, n)):
        own_p, own_k = perms[:, s * w:(s + 1) * w].contiguous(), keys[..., s * w:(s + 1) * w].contiguous()
        got = emulate_ks_mac_wide(ctx, digs, own_k, l, own_p, w)
        assert_same(got, tc.ks_mac_plain(digs, own_k, l, ctx.Lq, q, rinv, own_p))
        whole = tc.ks_mac_plain(digs, keys, l, ctx.Lq, q, rinv, perms)
        assert_same(got, whole[..., s * w:(s + 1) * w])


def emulate_sub_scale_launch(calls):
    """A stand-in for ``kernels.launch`` running ``imtpu_sub_scale`` on CPU
    tensors, the addend's rows ``add_lstride`` apart."""

    def launch(entry, counter, out, x, x_bstride, t, cinv, qs, qneg, add, add_r, add_c,
               add_lstride, add_k, perms, perm_r, B, l, n):
        assert entry == "imtpu_sub_scale" and 0 < add_k <= 2 and B % 2 == 0
        assert add_lstride >= n and (perms or add_lstride == n)
        vec = (n % 4 == 0 and aligned(out.data_ptr() // 4) and aligned(t // 4)
               and aligned(x // 4) and x_bstride % 4 == 0
               and (not perms or (aligned(perms // 4) and perm_r % 4 == 0)))
        V = 4 if vec else 1
        R = B // 2
        xm = at(x, (B - 1) * x_bstride + l * n)
        tm = at(t, B * l * n)
        am = at(add, (R - 1) * add_r + (add_k - 1) * add_c + l * add_lstride)
        pm = at(perms, (R - 1) * perm_r + n, ctypes.c_int32) if perms else None
        cm = at(cinv, l)
        qv, qn = at(qs, l), at(qneg, l)
        res = Out(B, l, n)
        bx, by, bz, per = limb_split_grid(B, l, n, V)
        k = thread_coeffs(bx, n, V)
        for z in range(bz):
            for b in range(B):
                r, comp = b >> 1, b & 1
                for v in range(V):
                    kv = k + v
                    src = pm[r * perm_r + kv] if pm is not None else kv
                    for i in range(z * per, min(l, z * per + per)):
                        q, qq = int(qv[i]), int(qn[i])
                        val = mont(mod_sub(xm[b * x_bstride + i * n + kv],
                                           tm[(b * l + i) * n + kv], q), cm[i], q, qq)
                        if comp < add_k:
                            a = am[r * add_r + comp * add_c + i * add_lstride + src]
                            val = mod_add(a, val, q)
                        res.put((b * l + i) * n + kv, val)
        out.copy_(res.done(tuple(out.shape)))
        calls.append((counter, V))
        kernels.count(counter)

    return launch


@pytest.mark.parametrize("D", [4, 8])
def test_sub_scale_full_width_addend(hydia, monkeypatch, D):
    """K7's sub-scale behind ``CkksContext._sub_scale`` of a shard's
    context (n = N / D): a rotation's c0 gathered from the all-gathered
    full-width addend through the shard's permutation rows equals the plain
    version and the single-device pass's slice."""
    calls = []
    monkeypatch.setattr(kernels, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "launch", emulate_sub_scale_launch(calls))
    ctx, l = hydia, 3
    n = ctx.n
    w, s = n // D, 1
    shard = copy.copy(ctx)
    shard.n = w
    ext = ctx.ext_limbs(l)
    pinv = ctx._pinv(l)
    perms = torch.from_numpy(np.stack([ctx.plan.auto_perm(ctx.rotation_galois(r))
                                       for r in (2, 9)]))
    x = _rows(ctx, (2, 2), ext, n)
    t = _rows(ctx, (2, 2), range(l), n)
    add = _rows(ctx, (2, 1), range(l), n)
    mine = lambda v: v[..., s * w:(s + 1) * w].contiguous()  # noqa: E731
    got = shard._sub_scale(mine(x), mine(t), pinv[1], add, mine(perms))
    assert calls == [("sub_scale_wide", 4)]
    assert_same(got, tc.sub_scale_plain(shard, mine(x), mine(t), pinv[0], add, mine(perms)))
    whole = tc.sub_scale_plain(ctx, x, t, pinv[0], add, perms)
    assert_same(got, whole[..., s * w:(s + 1) * w])

"""The port's CUDA kernels on the card: each kernel bit-exact against its
plain torch version on the same inputs, launch errors raised, and the
whole HyDia, HERS, Baseline, GROTE and Blind-Match slices on the card
bit-exact with the same slices on the CPU; the sharded scenarios over a
one-card mesh bit-equal to one device, and, where the machine has two or
more cards, a context on another card than the current one, the sharded
scenarios over real cards and psum_mod across two processes over NCCL.

Every test here needs an NVIDIA GPU and nvcc, and skips elsewhere.  This
file imports only the port: neither jax, nor the JAX package, nor
tests/conftest.py's jax setup, so on the machine with the card (which has
no jax) it runs as

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from image_matching_tpu_torch.ckks import context as tc
from image_matching_tpu_torch.ckks import poly_eval
from image_matching_tpu_torch.ckks.context import (CkksContext, fbc_plain, ks_mac_plain,
                                                   seeded_c0_plain, seeded_pre_plain)
from image_matching_tpu_torch.ckks.params import (SchemeParams, compute_required_depth,
                                                  root_of_unity)
from image_matching_tpu_torch.matching import senders, streaming
from image_matching_tpu_torch.matching.config import MatchConfig
from image_matching_tpu_torch.matching.protocol import MatchingProtocol
from image_matching_tpu_torch.ops import kernels
from image_matching_tpu_torch.ops import modmath as mm
from image_matching_tpu_torch.ops import ntt, prng
from image_matching_tpu_torch.parallel import sharded
from image_matching_tpu_torch.utils import io as dio

pytestmark = pytest.mark.cuda

PARAMS = SchemeParams.create(ring_dim=512, mult_depth=11, security="none")
# every kernel but K12, which only a sharded membership launches, and K5,
# whose c1 the streamed senders draw inside the seeded contraction
UNSHARDED = tuple(k for k in kernels.KERNELS if k not in ("psum_mod", "expand_c1"))
# the streamed store's path: the seeded contraction in place of K2
STREAMED = tuple(k for k in UNSHARDED if k != "ct_dot")
# the in-memory paths: neither the seeded contraction nor seeded encryption
IN_MEMORY = tuple(k for k in UNSHARDED if k not in ("ct_dot_seeded", "seeded_pre", "seeded_c0"))


def _device():
    # decided when a test runs, never at import: every xdist worker must
    # collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (the kernels build there)")
    return torch.device("cuda:0")


def _residues(gen, shape, q):
    """Uniform residues; q int64 broadcastable against shape."""
    return (torch.randint(0, 1 << 62, shape, generator=gen, device=q.device) % q).int()


def _launched(name, fn):
    before = kernels.counts()[name]
    out = fn()
    assert kernels.counts()[name] == before + 1, f"{name} was not launched"
    return out


@pytest.mark.parametrize("n,limbs,batch", [(512, (0, 5, 19), 4), (32768, (2, 0, 3), 5)])
def test_ntt_kernel_matches_plain(n, limbs, batch):
    dev = _device()
    p = SchemeParams.create(ring_dim=n, mult_depth=11, security="none")
    primes = (p.q_primes + p.sp_primes)[: max(limbs) + 1]
    plan = ntt.NttPlan(n, primes, [root_of_unity(q, 2 * n) for q in primes], device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    idx = plan.limb_index(limbs).long()
    a = _residues(gen, (batch, len(limbs), n), plan.q[idx].long()[:, None])
    fwd = _launched("ntt_fwd", lambda: plan.fwd(a, limbs))
    assert torch.equal(fwd, ntt.ntt_fwd_plain(a, plan.psis[idx], plan.q[idx]))
    inv = _launched("ntt_inv", lambda: plan.inv(a, limbs))
    assert torch.equal(inv, ntt.ntt_inv_plain(a, plan.ipsis[idx], plan.q[idx], plan.ninv[idx]))
    assert torch.equal(plan.inv(fwd, limbs), a)


@pytest.mark.parametrize("n", [512, 8192, 32768])
def test_ntt_kernel_row_counts(n):
    """K1's two passes at the row counts the main path gives it (1, 2,
    28, 160 and 448 rows), plain, through a per-batch and a shared
    permutation, and written in place over its input (the C entry point's
    out aliasing in), each bit-exact with the plain transforms."""
    dev = _device()
    ctx = _ctx(dev, n)
    gen = torch.Generator(device=dev).manual_seed(21)
    limbs = (0, 3)
    for rows in (1, 2, 28, 160, 448):
        shape = (rows, 1) if rows == 1 else (rows // 2, 2)
        lim = limbs[: shape[1]]
        a = _rows(ctx, gen, shape[:1], lim)
        perms = torch.from_numpy(np.stack([ctx.plan.auto_perm(ctx.rotation_galois(r))
                                           for r in range(1, shape[0] + 1)])).to(dev)
        for perm in (None, perms, perms[:1]):
            for inverse in (False, True):
                fn = ctx.plan.inv if inverse else ctx.plan.fwd
                plain = ctx.plan.inv_plain if inverse else ctx.plan.fwd_plain
                got = _launched("ntt_inv" if inverse else "ntt_fwd", lambda: fn(a, lim, perm))
                assert torch.equal(got, plain(ntt.permute_rows(a, perm), lim)), (rows, inverse)
        for inverse in (False, True):
            tw, tw_sh = ((ctx.plan.ipsis, ctx.plan.ipsis_sh) if inverse
                         else (ctx.plan.psis, ctx.plan.psis_sh))
            x = a.clone()
            kernels.launch("imtpu_ntt", "ntt_inv" if inverse else "ntt_fwd", x,
                           kernels.ptr(x), len(lim) * n, 0, 0,
                           kernels.ptr(ctx.plan.limb_index(lim)), x.numel() // n, len(lim),
                           ctx.plan.logn, kernels.ptr(tw), kernels.ptr(tw_sh),
                           kernels.ptr(ctx.plan.q), kernels.ptr(ctx.plan.ninv),
                           kernels.ptr(ctx.plan.ninv_sh), int(inverse))
            plain = ctx.plan.inv_plain if inverse else ctx.plan.fwd_plain
            assert torch.equal(x, plain(a, lim)), (rows, inverse, "in place")


def test_batched_compare_on_card_matches_cpu():
    """The compare circuit over a stack of 3 scores on the card (K9's
    batched tensor product, K11's batched add_scalar) equals the same
    stack on the CPU and the circuit run on each score alone."""
    dev = _device()
    params = SchemeParams.create(ring_dim=512, mult_depth=10, security="none")
    cfg = MatchConfig(vector_dim=64, comp_depth=10)
    noise = _numpy_noise(params)
    cpu_ctx = CkksContext(params, seed=4, device="cpu", **noise)
    card_ctx = CkksContext(params, seed=4, device=dev, **noise)
    rng = np.random.default_rng(8)
    cts = [cpu_ctx.encrypt(rng.uniform(-1, 1, cpu_ctx.slots), scale=params.scale)
           for _ in range(3)]
    want = senders.Sender(cpu_ctx, cfg, 0)._compare_many(cts)
    on_card = [tc.Ciphertext(c.data.to(dev), c.scale) for c in cts]
    got = senders.Sender(card_ctx, cfg, 0)._compare_many(on_card)
    single = [poly_eval.chebyshev_compare(card_ctx, c, 0.44, 10) for c in on_card]
    for w, g, o in zip(want, got, single):
        assert torch.equal(w.data, g.data.cpu()) and w.scale == g.scale
        assert torch.equal(o.data, g.data)


def test_per_device_error_propagates_from_a_card_worker():
    """A worker's error on the card's thread is raised in the caller once
    the other worker has ended."""
    dev = _device()
    done = []

    def work(d):
        if d.type == "cuda":
            with torch.cuda.device(d):
                torch.zeros(4, device=d).sum().item()
            raise RuntimeError("card worker failed")
        done.append(d)

    with pytest.raises(RuntimeError, match="card worker failed"):
        sharded.per_device([dev, torch.device("cpu")], work)
    assert done == [torch.device("cpu")]


def _misaligned(t):
    """A contiguous copy of t whose data starts 4 bytes past a 16-byte
    boundary (K2 then takes its one-coefficient loads)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return flat.view(t.shape).copy_(t)


def test_ct_dot_kernel_matches_plain():
    """Blocked and not, a long contraction (K=512), unequal limb counts,
    every K held in registers (1, 2, 4, 8, 16, 32; HyDia's K = 32 x 16
    blocks), K not a power of two over several blocks, misaligned
    operands, and Blind-Match's K = 4 x 128 blocks at its 15 limbs."""
    dev = _device()
    ctx = CkksContext(PARAMS, seed=1, device=dev)
    L = PARAMS.num_limbs
    q, _ = ctx._qrow(ctx.q_limbs(L))
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = [
        (_residues(gen, (512, 2, L, 512), q), _residues(gen, (512, 2, L, 512), q)),
        (_residues(gen, (8, 2, L, 512), q), _residues(gen, (3, 8, 2, L, 512), q)[..., :5, :]),
        (_residues(gen, (8, 2, L, 512), q)[..., :4, :], _residues(gen, (8, 2, L, 512), q)),
        (_residues(gen, (32, 2, L, 512), q), _residues(gen, (16, 32, 2, L, 512), q)),
        (_residues(gen, (5, 2, L, 512), q), _residues(gen, (3, 5, 2, L, 512), q)),
    ] + [(_residues(gen, (K, 2, L, 512), q), _residues(gen, (2, K, 2, L, 512), q))
         for K in (1, 2, 4, 16)]
    A, B = cases[-1]
    cases.append((_misaligned(A), _misaligned(B)))
    for A, B in cases:
        got = _launched("ct_dot", lambda: senders.ct_dot(ctx, A, B))
        assert torch.equal(got, senders.ct_dot_plain(ctx, A, B)), (tuple(A.shape), tuple(B.shape))
    blind = CkksContext(SchemeParams.create(ring_dim=512, mult_depth=12, security="none"),
                        seed=1, device=dev)
    assert blind.Lq == 15
    qb, _ = blind._qrow(blind.q_limbs(15))
    A, B = _residues(gen, (4, 2, 15, 512), qb), _residues(gen, (128, 4, 2, 15, 512), qb)
    got = _launched("ct_dot", lambda: senders.ct_dot(blind, A, B))
    assert torch.equal(got, senders.ct_dot_plain(blind, A, B))


@pytest.mark.parametrize("n", [512, 32768])
def test_ct_dot_seeded_kernel_matches_plain(n):
    """The seeded contraction against its plain version and against K5's
    c1 stacked with c0 and contracted by K2: HyDia's blocks (K = 32 x 16),
    HERS's single block (K = 64 here), K not a power of two, A at fewer
    limbs than the group (the counter runs over the group's L), seed and
    group >= 2^31, and a padding group (valid=False: zero, no launch)."""
    dev = _device()
    ctx = _ctx(dev, n)
    L = ctx.Lq
    q, _ = ctx._qrow(ctx.q_limbs(L))
    gen = torch.Generator(device=dev).manual_seed(9)
    seed, group = 2 ** 31 + 5, 2 ** 32 - 3
    for K, nb, LA in [(32, 16, L), (64, 1, L), (3, 2, L), (32, 2, 5)]:
        A = _residues(gen, (K, 2, LA, n), q[:LA])
        c0 = _residues(gen, (nb * K, L, n), q)
        got = _launched("ct_dot_seeded", lambda: senders.ct_dot_seeded(ctx, A, c0, seed, group, nb))
        assert got.shape == (nb, 3, min(LA, L), n)
        assert torch.equal(got, senders.ct_dot_seeded_plain(ctx, A, c0, seed, group, nb))
        stack = torch.stack([c0, ctx.expand_c1(seed, group, nb * K, L)], dim=1)
        assert torch.equal(got, senders.ct_dot(ctx, A, stack.view(nb, K, 2, L, n))), (K, nb, LA)
    before = kernels.counts()["ct_dot_seeded"]
    pad = senders.ct_dot_seeded(ctx, A, c0, seed, group, nb, valid=False)
    assert kernels.counts()["ct_dot_seeded"] == before and not pad.any()
    assert torch.equal(pad, senders.ct_dot_seeded_plain(ctx, A, c0, seed, group, nb, valid=False))


def test_fbc_kernel_matches_plain():
    dev = _device()
    ctx = CkksContext(PARAMS, seed=1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    l = ctx.Lq
    grp = tuple(ctx.groups[1])
    for src, dst in [(grp, tuple(i for i in ctx.ext_limbs(l) if i not in grp)),
                     (ctx.sp_limbs(), ctx.q_limbs(l)), (ctx.sp_limbs(), ctx.q_limbs(3))]:
        qs, _ = ctx._qrow(src)
        x = _residues(gen, (2, 7, len(src), ctx.n), qs)
        got = _launched("fbc", lambda: ctx._fbc(x, src, dst))
        assert torch.equal(got, fbc_plain(x, ctx._fbc_consts(src, dst)))


def test_ks_mac_kernel_matches_plain():
    """Every digs/ksk sharing mode, with and without the fused permutation,
    at the top level and at a level with fewer digits."""
    dev = _device()
    ctx = CkksContext(PARAMS, seed=1, device=dev)
    ctx.gen_rotation_keys([1, 2, 4, 8])
    gen = torch.Generator(device=dev).manual_seed(4)
    perms, keys = ctx._rot_rows([1, 2, 4, 8])
    for l in (ctx.Lq, 4):
        ext = ctx.ext_limbs(l)
        q, rinv = ctx._qrow(ext)
        ndig = len([g for g in ctx.groups if g[0] < l])
        digs = _residues(gen, (4, ndig, len(ext), ctx.n), q)
        for d, k, p in [(digs[0], keys, perms), (digs, keys, None), (digs, ctx.relin_key, None),
                        (digs[0], ctx.relin_key, None), (digs, keys, perms)]:
            got = _launched("ks_mac", lambda: ctx._ks_mac(d, k, l, p))
            assert torch.equal(got, ks_mac_plain(d, k, l, ctx.Lq, q, rinv, p))


@pytest.mark.parametrize("n,B,l", [(512, 3, None), (512, 2, 5), (32768, 4, None), (32768, 2, 3),
                                   (32768, 1, None), (32768, 70, None)])
def test_seeded_kernels_match_plain(n, B, l):
    """K5 (c1 expansion, into a plain and a strided output) and both passes
    of K6 (seeded encryption) against their plain versions, at the full
    limb count and below it, with seed and group >= 2^31 and int32 noise;
    one row (the pre pass splits its limbs over grid z), 70 rows (the c0
    pass walks stretches of 7); from misaligned row views (V = 1)."""
    dev = _device()
    p = SchemeParams.create(ring_dim=n, mult_depth=11, security="none")
    ctx = CkksContext(p, seed=1, device=dev)
    l = l or ctx.Lq
    _check_seeded(ctx, B, l)


def _check_seeded(ctx, B, l):
    dev, n = ctx.device, ctx.n
    seed, group = 2 ** 31 + 5, 2 ** 32 - 3
    c1 = _launched("expand_c1", lambda: ctx.expand_c1(seed, group, B, l))
    assert torch.equal(c1, prng.uniform_residues_plain(seed, group, (B, l, n), ctx.q32, ctx.r1_32))
    stack = torch.zeros((B, 2, l, n), dtype=torch.int32, device=dev)
    _launched("expand_c1", lambda: ctx.expand_c1(seed, group, B, l, out=stack[:, 1]))
    assert torch.equal(stack[:, 1], c1) and not stack[:, 0].any()

    rng = np.random.default_rng(5)
    hi, lo = (torch.from_numpy(a.view(np.int32)).to(dev) for a in ctx.split_coeffs(
        rng.integers(-(2 ** 45), 2 ** 45, size=(B, n))))
    e = torch.from_numpy(rng.integers(-30, 31, size=(B, n)).astype(np.int32)).to(dev)
    assert e.dtype == torch.int32
    x = _launched("seeded_pre", lambda: ctx._seeded_pre(hi, lo, e, l))
    assert torch.equal(x, seeded_pre_plain(ctx, hi, lo, e, l))
    for args in [(_misaligned(hi), lo, e), (hi, _misaligned(lo), _misaligned(e))]:
        assert torch.equal(_launched("seeded_pre", lambda: ctx._seeded_pre(*args, l)), x)
    x = ctx.plan.fwd(x, ctx.q_limbs(l))
    want = seeded_c0_plain(ctx, x, seed, group)
    mis = _misaligned(x)
    assert torch.equal(_launched("seeded_c0", lambda: ctx._seeded_c0(x, seed, group)), want)
    assert torch.equal(_launched("seeded_c0", lambda: ctx._seeded_c0(mis, seed, group)), want)


def _numpy_noise(params):
    def noise(seed, batch, n):
        rng = np.random.default_rng(seed)
        v = rng.integers(-1, 2, size=(batch, n))
        e = np.rint(rng.normal(0.0, params.sigma, size=(2, batch, n))).astype(np.int64)
        return v, e[0], e[1]

    def seeded_noise(seed, batch, n):
        return np.rint(np.random.default_rng(seed).normal(0.0, params.sigma, size=(batch, n)))

    return dict(noise=noise, seeded_noise=seeded_noise)


@pytest.mark.parametrize("tier", ["pinned", "resident", "pinned, chunks of 1"])
def test_streamed_slice_on_card_matches_cpu(tier, monkeypatch):
    """Streamed HyDia (2 groups; 4 in chunks of 1) on the card equals the
    CPU (plain) run bit for bit: the store, membership and index, with
    every group in pinned host memory (prefetch on a side stream; in
    chunks of 1 a compare runs between each group's contraction and the
    next copy into its staging buffer) or all resident.  engine="auto"
    never takes the host C++ engine; every kernel runs on the card and none
    on the CPU."""
    dev = _device()
    cfg = MatchConfig(vector_dim=64, chunk_len=16, comp_depth=8)
    params = SchemeParams.create(ring_dim=512, mult_depth=compute_required_depth(5, 8),
                                 security="none")
    nvec = 300
    if tier == "pinned, chunks of 1":
        monkeypatch.setenv("IMTPU_COMPARE_CHUNK", "1")
        tier, nvec = "pinned", 1000
    query, db = dio.gen_dataset(nvec, 64, seed=1)
    outs = {}
    for d in ("cpu", dev):
        ctx = CkksContext(params, seed=7, device=d, **_numpy_noise(params))
        ctx.encrypt_seeded_batch_host = None  # auto must not reach the C++ engine
        budget = 0 if d == "cpu" or tier == "pinned" else None
        kernels.reset_counts()
        proto = MatchingProtocol.setup(5, db, cfg, ctx=ctx, streamed=True, resident_budget=budget)
        qcts = proto.encrypt_query(query)
        mem = proto.membership(qcts)
        idx = proto.index(qcts)
        proto.decrypt_membership(mem)
        outs[str(d)] = (proto, mem, idx, kernels.counts())
    (pc, mc, ic, cc), (pg, mg, ig, cg) = outs["cpu"], outs[str(dev)]
    store = pg.sender.store
    if tier == "pinned":
        assert store.resident_count() == 0 and all(g.is_pinned() for g in store.groups)
    else:
        assert store.host_count() == 0 and all(g.is_cuda for g in store.groups)
    for a, b in zip(pc.sender.store.groups, store.groups):
        assert torch.equal(a, b.cpu())
    assert all(v == 0 for v in cc.values())
    assert all(cg[k] > 0 for k in STREAMED), cg
    assert torch.equal(mc.data, mg.data.cpu())
    for a, b in zip(ic, ig):
        assert torch.equal(a.data, b.data.cpu())
    assert pg.decrypt_membership(mg) is True
    assert pg.decrypt_index(ig) == [0]


def test_c0_cache_loads_on_card(tmp_path, monkeypatch):
    """A c0 cache written by the native engine on the card loads under a
    budget of two of its four groups: the leading two resident, the rest
    page-locked, the groups equal to the writer's store, no K6 launched,
    and a membership equal to the writer's protocol's on the same query
    ciphertext and the same keys."""
    dev = _device()
    monkeypatch.setenv("IMTPU_STORE_DIR", str(tmp_path))
    cfg = MatchConfig(vector_dim=64, chunk_len=16, comp_depth=8)
    params = SchemeParams.create(ring_dim=512, mult_depth=compute_required_depth(5, 8),
                                 security="none")
    query, db = dio.gen_dataset(1000, 64, seed=1)  # 4 groups of 256
    writer = MatchingProtocol.setup(5, db, cfg, ctx=CkksContext(params, seed=7, device=dev),
                                    streamed=True, resident_budget=0, engine="native")
    [cdir] = list(tmp_path.iterdir())
    assert (cdir / "meta.json").exists() and writer.sender.store.num_groups == 4
    gbytes = writer.sender.store.group_bytes()
    kernels.reset_counts()
    store = streaming.enroll_diag_streamed(writer.ctx, cfg, db, resident_budget=2 * gbytes,
                                           engine="device")
    assert kernels.counts()["seeded_pre"] == kernels.counts()["seeded_c0"] == 0
    assert store.resident == [True, True, False, False]
    assert all(g.is_cuda for g in store.groups[:2])
    assert all(g.is_pinned() for g in store.groups[2:])
    for a, b in zip(writer.sender.store.groups, store.groups):
        assert torch.equal(a.cpu(), b.cpu())
    qcts = writer.encrypt_query(query)
    want = writer.membership(qcts)
    got = streaming.StreamedDiagonalSender(writer.ctx, cfg, store).run_membership(qcts)
    assert torch.equal(want.data, got.data) and got.scale == want.scale
    assert writer.decrypt_membership(got) is True


def test_launch_error_raises():
    """A launch the kernel refuses (more source limbs than it holds)
    raises instead of returning garbage."""
    dev = _device()
    ctx = CkksContext(PARAMS, seed=1, device=dev)
    src, dst = tuple(range(9)), tuple(range(9, 12))
    x = torch.zeros((1, 9, ctx.n), dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="imtpu_fbc"):
        ctx._fbc(x, src, dst)


def test_slice_on_card_matches_cpu():
    """HyDia membership and index on the card equal the CPU (plain) run
    bit for bit, given the same numpy noise, and go through every kernel."""
    dev = _device()
    cfg = MatchConfig(vector_dim=64, chunk_len=16, comp_depth=8)
    params = SchemeParams.create(ring_dim=512, mult_depth=compute_required_depth(5, 8),
                                 security="none")
    query, db = dio.gen_dataset(40, 64, seed=1)

    def noise(seed, batch, n):
        rng = np.random.default_rng(seed)
        v = rng.integers(-1, 2, size=(batch, n))
        e = np.rint(rng.normal(0.0, params.sigma, size=(2, batch, n))).astype(np.int64)
        return v, e[0], e[1]

    outs = {}
    for d in ("cpu", dev):
        ctx = CkksContext(params, seed=7, device=d, noise=noise)
        kernels.reset_counts()
        proto = MatchingProtocol.setup(5, db, cfg, ctx=ctx)
        qcts = proto.encrypt_query(query)
        mem = proto.membership(qcts)
        idx = proto.index(qcts)
        outs[str(d)] = (mem, idx, proto, kernels.counts())
    (mc, ic, _, cc), (mg, ig, pg, cg) = outs["cpu"], outs[str(dev)]
    assert all(v == 0 for v in cc.values())
    # the in-memory DB runs all but the seeded kernels, which belong to the
    # streamed store (decryption is not in the counted run)
    assert all(cg[k] > 0 for k in IN_MEMORY if k != "decrypt_mac"), cg
    assert torch.equal(mc.data, mg.data.cpu())
    for a, b in zip(ic, ig):
        assert torch.equal(a.data, b.data.cpu())
    assert pg.decrypt_membership(mg) is True
    assert pg.decrypt_index(ig) == [0]


def _ctx(dev, n=512):
    return CkksContext(SchemeParams.create(ring_dim=n, mult_depth=11, security="none"),
                       seed=1, device=dev)


def _rows(ctx, gen, shape, limbs):
    q, _ = ctx._qrow(tuple(limbs))
    return _residues(gen, shape + (len(limbs), ctx.n), q)


@pytest.mark.parametrize("n", [512, 32768])
def test_ntt_strided_and_permuted_loads(n):
    """K1 reads a slice of limbs in place and gathers through one shared
    or one per-row automorphism on its way in."""
    dev = _device()
    ctx = _ctx(dev, n)
    gen = torch.Generator(device=dev).manual_seed(6)
    x = _rows(ctx, gen, (3, 2), range(6))
    perms = torch.from_numpy(np.stack([ctx.plan.auto_perm(ctx.rotation_galois(r))
                                       for r in (1, 2, 3)])).to(dev)
    for a, limbs, perm in [(x[:, 1], tuple(range(6)), None), (x[:, 0, 4:6], (4, 5), perms),
                           (x[:, 1, :3], (0, 1, 2), perms[:1]), (x[0, 0], tuple(range(6)), None)]:
        for inverse in (False, True):
            fn = ctx.plan.inv if inverse else ctx.plan.fwd
            plain = ctx.plan.inv_plain if inverse else ctx.plan.fwd_plain
            got = _launched("ntt_inv" if inverse else "ntt_fwd", lambda: fn(a, limbs, perm))
            assert torch.equal(got, plain(ntt.permute_rows(a, perm), limbs))


@pytest.mark.parametrize("n", [512, 32768])
def test_rescale_kernels_match_plain(n):
    """K7's lift and sub-scale passes around K1, at every level from the
    top to 2 limbs, for 2 and 3 components."""
    dev = _device()
    ctx = _ctx(dev, n)
    gen = torch.Generator(device=dev).manual_seed(7)
    for l in (ctx.Lq, 9, 2):
        for k in (2, 3):
            x = _rows(ctx, gen, (k,), range(l))
            before = kernels.counts()
            got = ctx.rescale(tc.Ciphertext(x, 2.0 ** 40)).data
            after = kernels.counts()
            assert after["rescale_lift"] == before["rescale_lift"] + 1
            assert after["sub_scale"] == before["sub_scale"] + 1
            assert torch.equal(got, tc.rescale_plain(ctx, x))


@pytest.mark.parametrize("n", [512, 32768])
def test_moddown_kernels_match_plain(n):
    """Centred K3 and K7 around K1, with no addend, a relinearization's
    addend and a rotation's gathered c0 (shared and per row)."""
    dev = _device()
    ctx = _ctx(dev, n)
    ctx.gen_rotation_keys([1, 2, 4])
    gen = torch.Generator(device=dev).manual_seed(8)
    perms, _ = ctx._rot_rows([1, 2, 4])
    for l in (ctx.Lq, 4):
        ext = ctx.ext_limbs(l)
        comp = _rows(ctx, gen, (3, 2), ext)
        c = _rows(ctx, gen, (3, 3), range(l))
        for cm, add, p in [(comp[0, 1], None, None), (comp, c[:, :2], None),
                           (comp[:1], c[:1, :2], None), (comp, c[:1, :1], perms),
                           (comp, c[:, :1], perms), (comp[:1], c[:1, :1], perms[1:2])]:
            got = _launched("sub_scale", lambda: ctx._moddown(cm, l, add, p))
            assert torch.equal(got, tc.moddown_plain(ctx, cm, l, add, p))


@pytest.mark.parametrize("n", [512, 32768])
def test_decompose_kernel_matches_plain(n):
    """K8 between K1's, at 3, 2 and 1 live digits, from a strided stack
    with per-row automorphisms and from one row with a shared one."""
    dev = _device()
    ctx = _ctx(dev, n)
    gen = torch.Generator(device=dev).manual_seed(9)
    perms = torch.from_numpy(np.stack([ctx.plan.auto_perm(ctx.rotation_galois(r))
                                       for r in (1, 5)])).to(dev)
    for l in (ctx.Lq, 9, 4):
        data = _rows(ctx, gen, (2, 2), range(l))
        for poly, p in [(data[0, 1], None), (data[:, 1], perms), (data[1, 0], perms[1:]),
                        (data[:, 0], None)]:
            got = _launched("decompose", lambda: ctx._decompose_extended(poly, l, p))
            assert torch.equal(got, tc.decompose_plain(ctx, poly, l, p))


def _approach_ctx(dev, approach, n):
    """A context of ``approach``'s own limb structure (its depth at the
    default MatchConfig) at ring n."""
    cfg = MatchConfig()
    depth = compute_required_depth(approach, cfg.comp_depth, cfg.alpha_depth)
    return CkksContext(SchemeParams.create(ring_dim=n, mult_depth=depth, security="none"),
                       seed=approach, device=dev)


def _misaligned(x):
    """A contiguous copy of x whose data starts 4 bytes past a 16-byte
    boundary, which the wrappers of the 16-byte-access kernels refuse."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    out = flat.view(x.shape)
    out.copy_(x)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("approach", [1, 2, 3, 5])
def test_fbc_kernel_every_width(approach):
    """K3 against fbc_plain at every (g, t) the approaches reach (HERS
    shares HyDia's parameters): each live digit into the rest of the
    extended basis and the centred mod-down from the special limbs, at
    every level, batches of 1 and 2 (split over more blocks) and 16; a
    misaligned input raises."""
    dev = _device()
    ctx = _approach_ctx(dev, approach, 512)
    gen = torch.Generator(device=dev).manual_seed(30 + approach)
    sp = ctx.sp_limbs()
    seen = set()
    for l in range(1, ctx.Lq + 1):
        convs = [(g, o, None) for g, o in ctx._digits(l)]
        convs.append((sp, ctx.q_limbs(l), ctx._centre_shift(l)))
        for src, dst, shift in convs:
            seen.add((len(src), len(dst), shift is not None))
            c = ctx._fbc_consts(src, dst)
            pre, post = shift if shift is not None else ((None, None), (None, None))
            for B in (1, 2, 16):
                x = _rows(ctx, gen, (B,), src)
                got = _launched("fbc", lambda: ctx._fbc(x, src, dst, shift))
                assert torch.equal(got, fbc_plain(x, c, pre[0], post[0])), (src, dst, B)
    with pytest.raises(ValueError, match="16-byte"):
        ctx._fbc(_misaligned(x), src, dst, shift)
    assert max(g for g, _, _ in seen) == ctx.S and len(seen) > ctx.Lq


@pytest.mark.parametrize("n", [512, 32768])
@pytest.mark.parametrize("approach", [5, 2])
def test_decompose_kernel_every_level(approach, n):
    """K8 alone against decompose_coeff_plain and with its NTTs against
    decompose_plain at every level l = 2..Lq of HyDia (5) and GROTE (2),
    for B = 1 (targets split over more blocks) and 16, with and without a
    per-row automorphism; a misaligned input raises."""
    dev = _device()
    ctx = _approach_ctx(dev, approach, n)
    gen = torch.Generator(device=dev).manual_seed(40 + approach)
    perms = torch.from_numpy(np.stack([ctx.plan.auto_perm(ctx.rotation_galois(r))
                                       for r in range(1, 17)])).to(dev)
    for l in range(2, ctx.Lq + 1):
        for B in (1, 16):
            coeff = _rows(ctx, gen, (B,), range(l))
            want = tc.decompose_coeff_plain(ctx, coeff, l)
            assert torch.equal(_launched("decompose", lambda: ctx._decompose_coeff(coeff, l)), want)
            if l == ctx.Lq and B == 16:
                with pytest.raises(ValueError, match="16-byte"):
                    ctx._decompose_coeff(_misaligned(coeff), l)
            poly = _rows(ctx, gen, (B,), range(l))
            for p in (None, perms[:B]):
                got = _launched("decompose", lambda: ctx._decompose_extended(poly, l, p))
                assert torch.equal(got, tc.decompose_plain(ctx, poly, l, p)), (l, B, p is None)


def test_k7_passes_alone_match_plain():
    """K7's lift and sub-scale passes, each launched alone, against
    rescale_lift_plain and sub_scale_plain (with a rotation's addend
    gathered per row) at ring 32768."""
    dev = _device()
    ctx = _ctx(dev, 32768)
    gen = torch.Generator(device=dev).manual_seed(50)
    l = ctx.Lq
    top = _rows(ctx, gen, (16, 2), (l - 1,))
    got = _launched("rescale_lift", lambda: ctx._rescale_lift(top, l))
    assert torch.equal(got, tc.rescale_lift_plain(ctx, top, l))
    perms = torch.from_numpy(np.stack([ctx.plan.auto_perm(ctx.rotation_galois(r))
                                       for r in range(1, 16)])).to(dev)
    comp = _rows(ctx, gen, (15, 2), ctx.ext_limbs(l))
    t = _rows(ctx, gen, (15, 2), range(l))
    add = _rows(ctx, gen, (15, 1), range(l))
    pinv = ctx._pinv(l)
    got = _launched("sub_scale", lambda: ctx._sub_scale(comp, t, pinv[1], add, perms))
    assert torch.equal(got, tc.sub_scale_plain(ctx, comp, t, pinv[0], add, perms))


@pytest.mark.parametrize("l", [2, 14])
def test_lift_kernel_levels_and_alignment(l):
    """K7's lift pass alone at one limb out (l = 2) and at l = 14, over the
    compare stack's 16 x 2 rows (limbs in one chunk) and one ciphertext
    (limbs split over grid z), and from a misaligned top (V = 1)."""
    dev = _device()
    ctx = _ctx(dev, 32768)
    assert ctx.Lq == 14
    gen = torch.Generator(device=dev).manual_seed(51)
    for shape in [(16, 2), (2,)]:
        top = _rows(ctx, gen, shape, (l - 1,))
        got = _launched("rescale_lift", lambda: ctx._rescale_lift(top, l))
        assert torch.equal(got, tc.rescale_lift_plain(ctx, top, l)), shape
    mis = _misaligned(top)
    got = _launched("rescale_lift", lambda: ctx._rescale_lift(mis, l))
    assert torch.equal(got, tc.rescale_lift_plain(ctx, mis, l))


def test_sub_scale_kernel_forms():
    """K7's sub-scale pass alone: a shared [1, N] permutation with a
    broadcast [1, 1] addend, a broadcast [1, 2] addend, x a dropped-limb
    view (a rescale's l + 1 of l + 3 limbs), one ciphertext (limbs split
    over grid z), and a misaligned addend without (V = 1) and with a
    permutation."""
    dev = _device()
    ctx = _ctx(dev, 32768)
    gen = torch.Generator(device=dev).manual_seed(52)
    l, R = ctx.Lq - 2, 4
    ext = ctx.ext_limbs(l)
    perms = torch.from_numpy(np.stack([ctx.plan.auto_perm(ctx.rotation_galois(r))
                                       for r in range(1, R + 1)])).to(dev)
    comp = _rows(ctx, gen, (R, 2), ext)
    t = _rows(ctx, gen, (R, 2), range(l))
    pinv, qtinv = ctx._pinv(l), ctx._qtinv(l + 1)
    big = _rows(ctx, gen, (R, 2), range(l + 3))
    add1, add2 = _rows(ctx, gen, (1, 1), range(l)), _rows(ctx, gen, (1, 2), range(l))
    mis = _misaligned(_rows(ctx, gen, (R, 1), range(l)))
    cases = [(comp, pinv, add1, perms[:1]), (comp, pinv, add2, None),
             (big[..., : l + 1, :], qtinv, None, None), (comp, pinv, mis, None),
             (comp, pinv, mis, perms)]
    for x, c, add, p in cases:
        got = _launched("sub_scale", lambda: ctx._sub_scale(x, t, c[1], add, p))
        assert torch.equal(got, tc.sub_scale_plain(ctx, x, t, c[0], add, p))
    one, t1 = big[0, :, : l + 1, :], t[0]
    got = _launched("sub_scale", lambda: ctx._sub_scale(one, t1, qtinv[1]))
    assert torch.equal(got, tc.sub_scale_plain(ctx, one, t1, qtinv[0]))


def test_modarith_kernel_forms_and_alignment():
    """K11's elementwise pass over a [16, 2, l, N] stack: neg, sub,
    add_scalar (head 1, component 1 copied through), a plane and a
    per-limb operand, a dropped-limb view read in place and a transposed
    view (copied), and a misaligned a or b (V = 1)."""
    dev = _device()
    ctx = _ctx(dev, 32768)
    gen = torch.Generator(device=dev).manual_seed(53)
    l = 11
    m = ctx._mod(l)
    big = _rows(ctx, gen, (16, 2), range(l + 2))
    a = big[..., :l, :]
    b = _rows(ctx, gen, (16, 2), range(l))
    plane = _rows(ctx, gen, (), range(l))
    const = ctx._mont_const(123456789, ctx.q_limbs(l))
    cases = [("neg", a, None, None), ("sub", a, b, None), ("add", a, const, 1),
             ("add", a, plane, None), ("mul", a, const, None), ("mul", a, plane, None),
             ("add", a.transpose(0, 1), b.transpose(0, 1), None),
             ("add", _misaligned(a), b, None), ("mul", a, _misaligned(b), None),
             ("add", a, _misaligned(b[:, :1]), 1)]
    for op, x, y, head in cases:
        got = _launched("modarith", lambda: mm.residue_op(op, x, y, m, head=head))
        yp = None if y is None else (tuple(v.cpu() for v in y) if isinstance(y, tuple)
                                     else y.cpu())
        want = mm.residue_op_plain(op, x.cpu(), yp, m.q.cpu(), m.rinv.cpu(), head)
        assert torch.equal(got.cpu(), want), (op, tuple(x.shape), head)


@pytest.mark.parametrize("R", [1, 15, 64, 128])
def test_row_sum_kernel_rows(R):
    """K11's row sum at R = 1, 15 (the giant steps), 64 (the flags, l = 2)
    and 128, of random rows, of rows all q - 1, and of a misaligned stack
    (V = 1)."""
    dev = _device()
    ctx = _ctx(dev, 32768)
    gen = torch.Generator(device=dev).manual_seed(54)
    l = 2 if R == 64 else ctx.Lq
    m = ctx._mod(l)
    rows = _rows(ctx, gen, (R, 2), range(l))
    top = (m.q - 1).int().expand(R, 2, l, ctx.n).contiguous()
    for x in (rows, top, _misaligned(rows)):
        got = _launched("mod_sum", lambda: mm.row_sum(x, m))
        assert torch.equal(got.cpu(), mm.row_sum_plain(x.cpu(), m.q.cpu()))


@pytest.mark.parametrize("n", [512, 32768])
def test_tensor_and_decrypt_kernels_match_plain(n):
    """K9: products of operands at unequal levels (read in place), the
    square, and decryption of 2- and 3-component ciphertexts, one and
    batched."""
    dev = _device()
    ctx = _ctx(dev, n)
    gen = torch.Generator(device=dev).manual_seed(10)
    for l in (ctx.Lq, 5):
        x = _rows(ctx, gen, (2,), range(l))
        y = _rows(ctx, gen, (2,), range(ctx.Lq))
        xb, yb = _rows(ctx, gen, (3, 2), range(l)), _rows(ctx, gen, (3, 2), range(ctx.Lq))
        for a, b in [(x, y), (y, x), (x, None), (y[:, :l], x), (xb, yb), (yb[..., :l, :], xb),
                     (xb, None)]:
            got = _launched("tensor", lambda: ctx._tensor(a, b))
            assert torch.equal(got, tc.tensor_plain(ctx, a, b))
        for data in (y[:, :l], _rows(ctx, gen, (3,), range(l)), _rows(ctx, gen, (4, 3), range(l))):
            got = _launched("decrypt_mac", lambda: ctx._decrypt_impl(data))
            assert torch.equal(got, tc.decrypt_plain(ctx, data))


@pytest.mark.parametrize("n,B", [(512, 3), (512, 130), (32768, 5), (32768, 1), (32768, 64)])
def test_pk_encrypt_kernels_match_plain(n, B):
    """K10's pre and MAC passes around K1, within one chunk and across
    chunks, at the top level and below, with int32 noise (int64 raises);
    each pass alone against its plain version, also from misaligned row
    views (the pre pass takes V = 1) and with a v outside {-1, 0, 1}; one
    ciphertext (a HyDia query: the pre pass splits its limbs over grid
    z)."""
    dev = _device()
    ctx = _ctx(dev, n)
    for l in (ctx.Lq, 5):
        _check_pk(ctx, B, l)


def _check_pk(ctx, B, l):
    dev, n = ctx.device, ctx.n
    rng = np.random.default_rng(11)
    q = np.array(ctx.all_primes[:l], dtype=np.int64)[:, None]
    m = torch.from_numpy((rng.integers(0, 1 << 62, size=(B, l, n)) % q).astype(
        np.uint32).view(np.int32)).to(dev)
    v = torch.from_numpy(rng.integers(-1, 2, size=(B, n)).astype(np.int32)).to(dev)
    e0, e1 = (torch.from_numpy(rng.integers(-20, 21, size=(B, n)).astype(np.int32)).to(dev)
              for _ in range(2))
    before = kernels.counts()
    got = ctx._encrypt_impl(m, v, e0, e1, l)
    chunks = -(-B // ctx._PK_CHUNK)
    after = kernels.counts()
    assert after["pk_pre"] - before["pk_pre"] == after["pk_mac"] - before["pk_mac"] == chunks
    assert torch.equal(got, tc.pk_encrypt_plain(ctx, m, v, e0, e1, l))
    with pytest.raises(ValueError, match="int32"):
        ctx._encrypt_impl(m, v.long(), e0, e1, l)
    b = min(B, ctx._PK_CHUNK)
    args = (m[:b], v[:b], e0[:b], e1[:b])
    x = _launched("pk_pre", lambda: ctx._pk_pre(*args, l))
    assert torch.equal(x, tc.pk_pre_plain(ctx, *args, l))
    mis = (_misaligned(args[0]), args[1], _misaligned(args[2]), args[3])
    assert torch.equal(_launched("pk_pre", lambda: ctx._pk_pre(*mis, l)), x)
    wide = args[1].clone()
    wide[:, :3] = torch.tensor([2, -7, int(min(ctx.all_primes[:l])) - 1], dtype=torch.int32)
    assert torch.equal(_launched("pk_pre", lambda: ctx._pk_pre(args[0], wide, *args[2:], l)),
                       tc.pk_pre_plain(ctx, args[0], wide, *args[2:], l))
    x = ctx.plan.fwd(x, ctx.q_limbs(l))
    want = tc.pk_mac_plain(ctx, x, l)
    assert torch.equal(_launched("pk_mac", lambda: ctx._pk_mac(x, l)), want)
    assert torch.equal(_launched("pk_mac", lambda: ctx._pk_mac(_misaligned(x), l)), want)
    assert torch.equal(want, got[:b])


@pytest.mark.parametrize("B", [1, 64])
def test_encryption_kernels_at_grote_width(B):
    """K6's and K10's passes at GROTE's widest chain (l = 21 of 29 limbs),
    ring 32768, against their plain versions: one ciphertext and an
    in-memory enrollment chunk of 64."""
    dev = _device()
    ctx = _approach_ctx(dev, 2, 32768)
    assert ctx.Lq == 21
    _check_seeded(ctx, B, ctx.Lq)
    _check_pk(ctx, B, ctx.Lq)


@pytest.mark.parametrize("streamed", [False, True])
def test_hers_on_card_matches_cpu(streamed):
    """HERS membership and index on the card equal the CPU (plain) run bit
    for bit, given the same numpy noise, in memory and streamed (2
    groups, all resident on the card), through every kernel of the path."""
    dev = _device()
    cfg = MatchConfig(vector_dim=64, chunk_len=16, comp_depth=8)
    params = SchemeParams.create(ring_dim=512, mult_depth=compute_required_depth(4, 8),
                                 security="none")
    query, db = dio.gen_dataset(300 if streamed else 40, 64, seed=1)
    kw = {"streamed": True} if streamed else {}
    outs = {}
    for d in ("cpu", dev):
        ctx = CkksContext(params, seed=7, device=d, **_numpy_noise(params))
        kernels.reset_counts()
        proto = MatchingProtocol.setup(4, db, cfg, ctx=ctx, **kw)
        qcts = proto.encrypt_query(query)
        mem = proto.membership(qcts)
        idx = proto.index(qcts)
        member = proto.decrypt_membership(mem)
        outs[str(d)] = (proto, mem, idx, member, kernels.counts())
    (_, mc, ic, _, cc), (pg, mg, ig, member, cg) = outs["cpu"], outs[str(dev)]
    assert all(v == 0 for v in cc.values())
    # in memory: one matrix, one score, one flag, so no row sum of flags
    path = STREAMED if streamed else tuple(k for k in IN_MEMORY if k != "mod_sum")
    assert all(cg[k] > 0 for k in path), cg
    assert torch.equal(mc.data, mg.data.cpu())
    for a, b in zip(ic, ig):
        assert torch.equal(a.data, b.data.cpu())
    assert member is True
    assert pg.decrypt_index(ig) == [0]


@pytest.mark.parametrize("n", [512, 32768])
def test_modarith_kernels_match_plain(n):
    """K11: add, sub, neg and the Montgomery product with an operand of the
    same shape (read in place from a dropped view), a plaintext plane and
    a per-limb constant, the head-only forms, and the row sum at R = 1,
    15 and 128 (rows read through a stride)."""
    dev = _device()
    ctx = _ctx(dev, n)
    gen = torch.Generator(device=dev).manual_seed(12)
    for l in (ctx.Lq, 5):
        m = ctx._mod(l)
        a = _rows(ctx, gen, (3, 2), range(ctx.Lq))[..., :l, :]  # a view of l limbs
        b = _rows(ctx, gen, (3, 2), range(l))
        plane = _rows(ctx, gen, (), range(l))
        const = ctx._mont_const(123456789, ctx.q_limbs(l))
        cases = [("add", a, b, None), ("sub", a, b, None), ("neg", a, None, None),
                 ("mul", a, b, None), ("mul", a, plane, None), ("mul", a, const, None),
                 ("add", a, const, None), ("add", a[0], const, 1), ("add", a[0], b[0, :1], 1),
                 ("add", a, const, 1), ("add", a, b[:, :1], 1)]
        for op, x, y, head in cases:
            got = _launched("modarith", lambda: mm.residue_op(op, x, y, m, head=head))
            yp = None if y is None else (y if isinstance(y, tuple) else y.cpu())
            yp = (yp[0].cpu(), yp[1].cpu()) if isinstance(yp, tuple) else yp
            want = mm.residue_op_plain(op, x.cpu(), yp, m.q.cpu(), m.rinv.cpu(), head)
            assert torch.equal(got.cpu(), want), (op, l, head)
        for R in (1, 15, 128):
            rows = _rows(ctx, gen, (R, 2, 2), range(l))[:, 1]  # row stride > row size
            got = _launched("mod_sum", lambda: mm.row_sum(rows, m))
            assert torch.equal(got.cpu(), mm.row_sum_plain(rows.cpu(), m.q.cpu())), R


@pytest.mark.parametrize("approach", [1, 2, 3])
def test_approaches_on_card_match_cpu(approach):
    """Baseline, GROTE and Blind-Match membership and index on the card
    equal the CPU (plain) run bit for bit, given the same numpy noise,
    through every kernel of the path (K2 and K11's row sum only for
    Blind-Match at this size)."""
    dev = _device()
    depth = 10 if approach == 2 else 8
    cfg = MatchConfig(vector_dim=64, chunk_len=16, comp_depth=depth)
    params = SchemeParams.create(ring_dim=512, mult_depth=compute_required_depth(
        approach, depth, cfg.alpha_depth), security="none")
    query, db = dio.gen_dataset(40, 64, seed=1)
    outs = {}
    for d in ("cpu", dev):
        ctx = CkksContext(params, seed=7, device=d, **_numpy_noise(params))
        kernels.reset_counts()
        proto = MatchingProtocol.setup(approach, db, cfg, ctx=ctx)
        qcts = proto.encrypt_query(query)
        mem = proto.membership(qcts)
        idx = proto.index(qcts)
        member = proto.decrypt_membership(mem)
        outs[str(d)] = (proto, mem, idx, member, kernels.counts())
    (_, mc, ic, _, cc), (pg, mg, ig, member, cg) = outs["cpu"], outs[str(dev)]
    assert all(v == 0 for v in cc.values())
    # Baseline and GROTE: one merged score, one flag, so no row sum of flags
    skip = {"ct_dot", "mod_sum"} if approach != 3 else set()
    assert all(cg[k] > 0 for k in IN_MEMORY if k not in skip), cg
    assert torch.equal(mc.data, mg.data.cpu())
    for a, b in zip(ic, ig):
        assert torch.equal(a.data, b.data.cpu())
    assert member is True
    assert pg.decrypt_index(ig) == [0]


def test_default_device_is_the_card():
    """Without a device argument the entry points run on the card."""
    _device()
    p = SchemeParams.create(ring_dim=512, mult_depth=2, security="none")
    assert CkksContext(p, seed=1).device.type == "cuda"


def _needs_cards(k=2):
    _device()
    if torch.cuda.device_count() < k:
        pytest.skip(f"needs {k} or more GPUs ({torch.cuda.device_count()} here)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@pytest.mark.parametrize("n", [512, 32768])
def test_psum_mod_kernel_matches_plain(n):
    """K12: P = 1, 4 and 8 one-row buffers and buffers of several rows
    (16, as a shard's local flags; unequal counts), each a separate
    allocation read through the pointer table, at the flag shape
    [2, l, N], against psum_mod_plain; psum_mod takes the same route."""
    dev = _device()
    ctx = _ctx(dev, n)
    gen = torch.Generator(device=dev).manual_seed(13)
    for l in (1, 3, ctx.Lq):
        q, _ = ctx._qrow(ctx.q_limbs(l))
        primes = ctx.all_primes[:l]
        for rows in ([1], [1] * 4, [1] * 8, [16], [3, 1, 5, 1]):
            parts = [_rows(ctx, gen, (R, 2), range(l)) for R in rows]
            want = sharded.psum_mod_plain([p.cpu() for p in parts], q.cpu())
            got = _launched("psum_mod", lambda: sharded.psum_mod_kernel(parts, primes))
            assert torch.equal(got.cpu(), want), (l, rows)
            got = _launched("psum_mod", lambda: sharded.psum_mod(parts, primes, dev))
            assert torch.equal(got.cpu(), want), (l, rows)


def _counted(name, fn):
    before = kernels.counts()[name]
    out = fn()
    return out, kernels.counts()[name] - before


@pytest.mark.parametrize("n", [512, 32768])
def test_psum_mod_kernel_past_the_cap_and_misaligned(n):
    """K12 over P = 64, 65 and 133 buffers (one launch at the cap, chunks
    past it), unequal counts and one-row views, each list also with
    every buffer 4 bytes off a 16-byte boundary (V = 1), at the flag's
    [2, 2, N], against psum_mod_plain."""
    dev = _device()
    ctx = _ctx(dev, n)
    gen = torch.Generator(device=dev).manual_seed(31)
    cap = sharded.PSUM_CAP
    q, _ = ctx._qrow(ctx.q_limbs(2))
    primes = ctx.all_primes[:2]
    for counts, launches in [([1] * cap, 1), ([1] * (cap + 1), 2), ([2] * (2 * cap + 5), 3),
                             ([16, 1, 5, 16], 1)]:
        parts = [_rows(ctx, gen, (R, 2), range(2)) for R in counts]
        for ps in (parts, [_misaligned(p) for p in parts]):
            got, k = _counted("psum_mod", lambda: sharded.psum_mod_kernel(ps, primes))
            assert k == launches, (len(ps), k)
            want = sharded.psum_mod_plain([p.cpu() for p in ps], q.cpu())
            assert torch.equal(got.cpu(), want), (len(ps), ps[0].data_ptr() % 16)
    stack = _rows(ctx, gen, (4, 2), range(2))  # all_gather's list: views of one stack
    got = _launched("psum_mod", lambda: sharded.psum_mod_kernel(list(stack[:, None]), primes))
    assert torch.equal(got.cpu(), sharded.psum_mod_plain([stack.cpu()], q.cpu()))


def test_psum_mod_kernel_does_not_sync():
    """K12's wrapper makes no copy from the host and waits for nothing:
    with the card busy (a sleep queued first), the call returns while
    the stream still runs; its result then equals the plain version."""
    dev = _device()
    ctx = _ctx(dev, 32768)
    gen = torch.Generator(device=dev).manual_seed(32)
    q, _ = ctx._qrow(ctx.q_limbs(2))
    primes = ctx.all_primes[:2]
    parts = [_rows(ctx, gen, (16, 2), range(2)) for _ in range(4)]
    sharded.psum_mod_kernel(parts, primes)  # the build and the limb constants
    torch.cuda.synchronize()
    torch.cuda._sleep(500_000_000)  # ~0.25 s of the card's clock
    got = sharded.psum_mod_kernel(parts, primes)
    assert not torch.cuda.current_stream().query(), "psum_mod_kernel waited for the card"
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), sharded.psum_mod_plain([p.cpu() for p in parts], q.cpu()))


@pytest.mark.parametrize("n", [512, 32768])
def test_decrypt_mac_kernel_lists(n):
    """K9's decrypt MAC over lists of separate ciphertexts: B = 1 and 64
    (one launch), 65 and 130 (past the cap), k = 2 and 3, blocks 4 bytes
    off a 16-byte boundary (V = 1) and limb-slice views, against
    decrypt_mac_plain; _decrypt_group against decrypt_plain, and
    _decrypt_many against decrypt_coeffs one at a time over a mixed list."""
    dev = _device()
    ctx = _ctx(dev, n)
    gen = torch.Generator(device=dev).manual_seed(33)
    cap = ctx.DECRYPT_CAP
    for B, k, l, launches in [(1, 2, 2, 1), (64, 2, 2, 1), (cap + 1, 2, 2, 2),
                              (2 * cap + 2, 3, 3, 3), (1, 3, ctx.Lq, 1)]:
        blocks = [_rows(ctx, gen, (k,), range(l)) for _ in range(B)]
        views = [_rows(ctx, gen, (k,), range(ctx.Lq))[:, :l] for _ in range(B)]
        for bs in (blocks, [_misaligned(b) for b in blocks], views):
            got, c = _counted("decrypt_mac", lambda: ctx._decrypt_mac(bs))
            assert c == launches, (B, c)
            stack = torch.stack([b.contiguous() for b in bs])
            assert torch.equal(got, tc.decrypt_mac_plain(ctx, stack)), (B, k, l)
        got = ctx._decrypt_group(blocks)
        assert torch.equal(got, tc.decrypt_plain(ctx, torch.stack(blocks)))
    cts = [tc.Ciphertext(_rows(ctx, gen, (2 + i % 2,), range(1 + i % 3)), 2.0 ** 20)
           for i in range(12)]
    for a, b in zip(ctx._decrypt_many(cts), cts):
        assert np.array_equal(a, ctx.decrypt_coeffs(b))


def _sharded_vs_single(mesh_devices, streamed, n_groups):
    """HyDia on the card (3 groups at ring 512) served single-device and
    over the mesh: membership bit-equal, the real groups' index flags
    bit-equal, decisions right, K12 and every kernel of the path launched
    by the sharded run."""
    dev = _device()
    cfg = MatchConfig(vector_dim=64, chunk_len=16, comp_depth=8)
    params = SchemeParams.create(ring_dim=512, mult_depth=compute_required_depth(5, 8),
                                 security="none")
    query, db = dio.gen_dataset(params.slots * n_groups, 64, seed=3)
    ctx = CkksContext(params, seed=7, device=dev, **_numpy_noise(params))
    proto = MatchingProtocol.setup(5, db, cfg, ctx=ctx, streamed=streamed)
    qcts = proto.encrypt_query(query)
    mem, idx = proto.membership(qcts), proto.index(qcts)
    mesh = sharded.make_mesh(devices=mesh_devices)
    scen = (sharded.ShardedStreamedScenario if streamed else sharded.ShardedScenario)(
        proto.sender, mesh)
    kernels.reset_counts()
    smem, sidx = scen.membership(qcts), scen.index(qcts)
    counts = kernels.counts()
    assert smem.data.device == mesh.root
    assert torch.equal(smem.data.cpu(), mem.data.cpu())
    for a, b in zip(idx, sidx[:n_groups]):
        assert torch.equal(a.data.cpu(), b.data.cpu())
    res = smem if smem.data.device == dev else tc.Ciphertext(smem.data.to(dev), smem.scale)
    assert proto.decrypt_membership(res) is True
    assert proto.decrypt_index([tc.Ciphertext(f.data.to(dev), f.scale) for f in sidx]) == [0]
    # not in the run: setup's and the query's encryption, decryption
    skip = ("pk_pre", "pk_mac", "seeded_pre", "seeded_c0", "decrypt_mac")
    path = (STREAMED if streamed else IN_MEMORY) + ("psum_mod",)
    assert all(counts[k] > 0 for k in path if k not in skip), counts


@pytest.mark.parametrize("streamed", [False, True])
def test_sharded_on_one_card_matches_single(streamed):
    """A mesh naming the card twice: in memory 2 groups on 2 shards,
    streamed 3 groups on 2 shards (one padding group)."""
    _sharded_vs_single([_device()] * 2, streamed, 3 if streamed else 2)


@pytest.mark.parametrize("streamed", [False, True])
def test_sharded_worker_error_propagates_over_cards(streamed):
    """Over real cards a shard's failure on its card's thread comes out of
    the sharded call."""
    cards = _needs_cards()[:2]
    cfg = MatchConfig(vector_dim=64, chunk_len=16, comp_depth=8)
    params = SchemeParams.create(ring_dim=512, mult_depth=compute_required_depth(5, 8),
                                 security="none")
    query, db = dio.gen_dataset(params.slots * 2, 64, seed=3)
    ctx = CkksContext(params, seed=7, device=cards[0], **_numpy_noise(params))
    proto = MatchingProtocol.setup(5, db, cfg, ctx=ctx, streamed=streamed)
    qcts = proto.encrypt_query(query)
    scen = (sharded.ShardedStreamedScenario if streamed else sharded.ShardedScenario)(
        proto.sender, sharded.make_mesh(devices=cards))

    def fail(*a, **k):
        raise RuntimeError("shard failed")

    if streamed:
        scen.views[cards[1]]._group_compute = fail
    else:
        scen.shards[1].compute_similarity = fail
    with pytest.raises(RuntimeError, match="shard failed"):
        scen.membership(qcts)


@pytest.mark.parametrize("streamed", [False, True])
def test_sharded_over_cards_matches_one_card(streamed):
    """The same over real cards (up to 4), the store and DB on card 0, the
    shards on context replicas, partials copied to card 0."""
    cards = _needs_cards()[:4]
    _sharded_vs_single(cards, streamed, len(cards) if not streamed else len(cards) + 1)


def test_context_on_another_card():
    """A context built on the last card while card 0 is current launches
    its kernels there: NTT, keyswitch (relinearization and rotation) and
    decryption bit-equal to the same work on card 0; so is a replica of
    card 0's context on the last card."""
    cards = _needs_cards()
    last = cards[-1]
    torch.cuda.set_device(0)
    ctx0 = CkksContext(PARAMS, seed=1, device=cards[0], **_numpy_noise(PARAMS))
    ctx0.gen_rotation_keys([1, 3])
    ctxs = [CkksContext(PARAMS, seed=1, device=last, **_numpy_noise(PARAMS)), ctx0.replica(last)]
    ctxs[0].gen_rotation_keys([1, 3])
    vals = np.random.default_rng(2).uniform(-1, 1, ctx0.slots)
    x0 = ctx0.encrypt(vals)
    want = [ctx0.plan.fwd(x0.data, ctx0.q_limbs(x0.limbs)),
            ctx0.relinearize(ctx0.mul(x0, x0)).data, ctx0.rotate(x0, 3).data,
            torch.from_numpy(ctx0.decrypt_coeffs(x0))]
    for ctx in ctxs:
        x = tc.Ciphertext(x0.data.to(last), x0.scale)
        got = [ctx.plan.fwd(x.data, ctx.q_limbs(x.limbs)), ctx.relinearize(ctx.mul(x, x)).data,
               ctx.rotate(x, 3).data, torch.from_numpy(ctx.decrypt_coeffs(x))]
        assert all(g.device in (last, torch.device("cpu")) for g in got)
        for w, g in zip(want, got):
            assert torch.equal(w.cpu(), g.cpu())
        assert torch.cuda.current_device() == 0
    assert torch.equal(ctxs[0].relin_key.cpu(), ctx0.relin_key.cpu())


def test_two_process_psum_mod_over_nccl():
    """psum_mod across two processes, one card each, over NCCL (the
    worker of tests/test_torch_multihost.py)."""
    _needs_cards()
    from test_torch_multihost import run_pair

    run_pair("cuda")

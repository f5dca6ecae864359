#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (image_matching_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port builds and runs on the card.

    python3 chip_smoke.py

Phases (every one asserts; any failure exits non-zero before the result
line is printed):
  1. build the CUDA kernels from csrc/ (one nvcc per source, sm_90a) and
     print the time;
  2. run each kernel (NTT fwd/inv, ct_dot, the seeded contraction
     ct_dot_seeded, fast base conversion, keyswitch MAC, c1 expansion, both
     passes of seeded encryption, and the fused operations built on
     K7-K10: rescale, mod-down, digit decomposition, tensor product,
     decryption, public-key encryption) on the card at the shapes of the
     main path and require bit-exact equality with its plain torch version
     on the same inputs; print both times (CUDA events); K8 and K7's two
     passes also alone, without their K1 launches (relinearization R = 16,
     giant steps R = 15, l = 14), before the fused operations; ct_dot also at
     Blind-Match's K = 4 x 128 blocks of 15 limbs, ct_dot_seeded at HERS's
     shape, with fewer limbs than the group and for a padding group, each
     also equal to K5's c1 stacked with c0 and contracted by ct_dot; K1
     also at 2, 28, 160 and 448 rows, with and without a per-row Galois
     gather, beside the earlier design's ntt.cu where build/ntt_prev/
     holds one (utils/ntt_bench.py); the streamed membership's 64-group
     contraction through ct_dot_seeded and through a stack filled by K5
     and a copy, in turns, and K2 beside the earlier design's ct_dot.cu
     where build/ct_dot_prev/ holds one (utils/dot_bench.py); K3 and K8
     alone at the main path's shapes beside the earlier design's
     basis_convert.cu and decompose.cu where build/fbc_prev/ holds them
     (utils/fbc_bench.py); K7's two passes and K11's two passes alone at
     the streamed membership's most frequent shapes, beside the earlier
     design's rescale.cu and modarith.cu where build/resid_prev/ holds
     them, and one torch.add of int32 as a yardstick (utils/resid_bench.py);
  3. drive HyDia (approach 5) with an in-memory encrypted DB of 2^16
     vectors at production parameters (ring 32768, dim 512, threshold
     0.44, comparison depth 10): setup, encrypt the query, membership,
     index, decrypt; require membership True, the index set equal to the
     plaintext set cosine >= 0.44 (which holds the planted vector 0), and
     decrypted scores within 1e-4 of the plaintext cosine;
  4. require that every kernel but the streamed store's (ct_dot_seeded,
     K6) and K5 was launched during phase 3;
  5. the streamed, seed-compressed HyDia store at 2^20 vectors (64
     groups) with the device-memory budget derived on the card: setup
     (split into keygen, enrollment, rotation keys), membership and index
     (a first call, then three repetitions each), the same decisions and
     score parity over all 2^20 vectors; resident and pinned group counts,
     peak device memory (and over the queries alone); the launches of one
     membership and K1's launches by row count; every kernel launched but
     K5 and ct_dot (the seeded contraction draws c1 in registers);
  6. 2^17 vectors (8 groups) with resident_budget=0, so every group
     crosses PCIe on every query: the same decisions, the per-group copy
     and compute times, and a membership ciphertext bit-equal to the same
     store served all resident;
  7. HERS (approach 4) in memory at 2^16 (4 matrices of 512 feature
     ciphertexts, a 512-ciphertext query), as phase 3;
  8. the streamed HERS store at 2^20 (64 groups), as phase 5;
  9. Baseline (approach 1), GROTE (approach 2) and Blind-Match (approach 3)
     in memory at 2^15 vectors, each at its own depth (13, 18, 12), as
     phase 3 (and but K2 for Baseline and GROTE).
Sharded (parallel/sharded.py), reusing the protocols above: after phase 3,
K12 (the modular sum of shard partials) against its plain version at the
flag's shape, P = 4 x 16 rows, 4 and 8 one-row buffers and one of 16 rows;
then HyDia 2^16 (after phase 3) and HERS 2^16 (after phase 7) in memory over
one-card meshes of 4, 2 and 3 shards, HyDia 2^20 streamed (after phase 5)
and 2^17 pinned (inside phase 6, before its groups are promoted) over 4
and 3 shards: decisions equal to the plaintext set, the membership
ciphertext and index flags bit-equal to one device (all but the uneven
in-memory mesh, whose padding flags are ~0 and summed, as in the JAX
package), K12 and every kernel of the unsharded path but setup's and query
encryption's (and K11's row sum, whose sum of flags K12 takes over)
launched.  Where the machine has 2 or more cards, each also
runs over cuda:0..k-1 (k = min(count, 4)), one issuing thread per card,
and prints each card's window (issue start, issue end, card done), else
one line says why not.
K11 (standalone residue arithmetic) must launch on every path; nothing of
jax or of the JAX package may be imported.  The last lines are the card's
name and power limit, one JSON line of per-kernel results (with each
kernel's bound: the larger of its bytes over 3.35 TB/s and its 32-bit
integer operations over 67 T/s, the float32 rate: Hopper issues integer
add, xor and shift at a lower one), and the JSON result line.
"""

import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

NVEC = 1 << 16          # in-memory HyDia and HERS
NVEC_SLOTS = 1 << 15    # in-memory Baseline, GROTE, Blind-Match
NVEC_STREAM = 1 << 20   # streamed phases: 64 groups of 16384 vectors
NVEC_PINNED = 1 << 17   # forced-pinned phase: 8 groups
DIM = 512
SEED = 0
SEEDED_KERNELS = ("ct_dot_seeded", "seeded_pre", "seeded_c0")  # the streamed store's
ENCRYPT_KERNELS = ("pk_pre", "pk_mac", "seeded_pre", "seeded_c0")  # setup, query encryption
APPROACH = {1: "Baseline", 2: "GROTE", 3: "Blind-Match", 4: "HERS", 5: "HyDia"}
HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM device memory
INT_OPS_PER_S = 67e12      # 32-bit lanes outside the tensor cores (float32 peak)
MUL, ADD = 6, 2            # 32-bit operations per modular product / add
MAD = 2                    # a product added into a 64-bit sum (mad.wide.u32)
UNIFORM_OPS = 20 * 4 + 4 * 6 + 2 * MUL  # a Threefry draw (20 rounds of add, rotate,
# xor; key injections) and its two Montgomery products
T0 = time.perf_counter()


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters=5):
    """Mean device time of fn() in ms over `iters` calls after a warm-up,
    the calls queued behind a sleep on the card so that the window holds
    their device time and not their wrappers' host time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(iters * 400_000))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def ntt_ops(rows, n):
    """Butterflies of `rows` transforms, a Shoup product and two adds each."""
    return rows * n // 2 * (n.bit_length() - 1) * (MUL + 2 * ADD)


def fbc_ops(rows, g, t, n):
    """A conversion's operations (csrc/fbc.cuh): y_i (one modular product
    each) and, per output, g + 1 products added into 64-bit sums and one
    Montgomery step per partial of four plus a final one."""
    return rows * n * (g * MUL + t * ((g + 1) * MAD + (2 + (g > 4)) * MUL))


def rand_residues(shape, primes, gen, device):
    """Uniform residues mod primes[i] along axis -2, int32 on device."""
    q = torch.tensor(primes, dtype=torch.int64, device=device)[:, None]
    x = torch.randint(0, 1 << 62, shape, generator=gen, device=device, dtype=torch.int64)
    return (x % q).int()


def recorder(rows):
    """record(name, label, got, want, fn, plain_fn, nbytes, ops): hold one
    kernel call against its plain version, bit for bit, and time both;
    nbytes and ops are the work of the call (inputs read once, outputs
    written once), for its bound.  The first shape recorded for a kernel
    is its main path's and gives its row in `rows`.  Returns the kernel's
    ms."""
    def record(name, label, got, want, fn, plain_fn, nbytes, ops):
        assert got.dtype == want.dtype == torch.int32 and got.shape == want.shape, label
        err = int((got.long() - want.long()).abs().max())
        ms, pms = cuda_ms(fn), cuda_ms(plain_fn)
        bms, by = bound(nbytes, ops)
        log(f"kernel {name} [{label}]: max_abs_err {err}  kernel {ms:.4f} ms  "
            f"plain {pms:.4f} ms  bound {bms:.4f} ms ({by})")
        assert err == 0, f"{name} [{label}] differs from its plain version"
        r = rows.setdefault(name, {"max_abs_err": 0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if "ms" not in r:
            r.update(ms=ms, plain_ms=pms, shape=label, bound_ms=bms, bound_by=by)
        return ms
    return record


def check_psum_mod(rows, l, device):
    """Phase 2, K12: the modular sum of shard partials against
    psum_mod_plain, bit-exact, at the membership flag's shape [2, l, N]
    (l read from phase 3's flag): first the one-card streamed main path's
    4 shards of 16 flags each (2^20 over 4 shards), then P = 4 and 8
    one-row buffers (shard partials) and one buffer of 16 rows."""
    from image_matching_tpu_torch.ckks.params import SchemeParams, compute_required_depth
    from image_matching_tpu_torch.matching.config import MatchConfig
    from image_matching_tpu_torch.parallel import sharded

    record = recorder(rows)
    gen = torch.Generator(device=device)
    gen.manual_seed(4321)
    params = SchemeParams.create(mult_depth=compute_required_depth(5, MatchConfig().comp_depth))
    primes, n = params.q_primes[:l], params.ring_dim
    q = torch.tensor(primes, dtype=torch.int64, device=device)[:, None]
    for label, counts in [("P=4 x 16 rows", [16] * 4), ("P=4 x 1 row", [1] * 4),
                          ("P=8 x 1 row", [1] * 8), ("P=1 x 16 rows", [16])]:
        parts = [rand_residues((R, 2, l, n), primes, gen, device) for R in counts]
        R = sum(counts)
        record("psum_mod", f"{label}, [2,{l},N]", sharded.psum_mod_kernel(parts, primes),
               sharded.psum_mod_plain(parts, q), lambda: sharded.psum_mod_kernel(parts, primes),
               lambda: sharded.psum_mod_plain(parts, q), (R + 1) * 2 * l * n * 4,
               R * 2 * l * n * ADD)
        del parts


def check_kernels(ctx, device):
    """Phase 2: each kernel against its plain version, bit-exact."""
    from image_matching_tpu_torch.ckks.context import (fbc_plain, ks_mac_plain, seeded_c0_plain,
                                                       seeded_pre_plain)
    from image_matching_tpu_torch.matching.senders import ct_dot, ct_dot_plain
    from image_matching_tpu_torch.ops.ntt import ntt_fwd_plain, ntt_inv_plain
    from image_matching_tpu_torch.ops.prng import uniform_residues_plain

    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    P = ctx.all_primes
    n, Lq, l = ctx.n, ctx.Lq, ctx.Lq
    rows = {}
    record = recorder(rows)
    plan = ctx.plan
    limbs = tuple(range(ctx.Ltot))
    idx = plan.limb_index(limbs).long()
    x = rand_residues((8, ctx.Ltot, n), P, gen, device)
    nb, ops = (2 * x.numel() + 2 * ctx.Ltot * n) * 4, ntt_ops(8 * ctx.Ltot, n)
    record("ntt_fwd", "8x20 limbs", plan.fwd(x, limbs), ntt_fwd_plain(x, plan.psis[idx], plan.q[idx]),
           lambda: plan.fwd(x, limbs), lambda: ntt_fwd_plain(x, plan.psis[idx], plan.q[idx]),
           nb, ops)
    record("ntt_inv", "8x20 limbs", plan.inv(x, limbs),
           ntt_inv_plain(x, plan.ipsis[idx], plan.q[idx], plan.ninv[idx]),
           lambda: plan.inv(x, limbs),
           lambda: ntt_inv_plain(x, plan.ipsis[idx], plan.q[idx], plan.ninv[idx]), nb, ops)
    del x
    check_ntt_shapes(plan, rows)

    qp = P[:Lq]
    A = rand_residues((32, 2, Lq, n), qp, gen, device)
    B = rand_residues((16, 32, 2, Lq, n), qp, gen, device)
    record("ct_dot", "K=32 x 16 blocks", ct_dot(ctx, A, B), ct_dot_plain(ctx, A, B),
           lambda: ct_dot(ctx, A, B), lambda: ct_dot_plain(ctx, A, B),
           *ct_dot_work(32, 16, Lq, n))
    A = rand_residues((512, 2, Lq, n), qp, gen, device)
    B = rand_residues((512, 2, Lq, n), qp, gen, device)
    record("ct_dot", "K=512", ct_dot(ctx, A, B), ct_dot_plain(ctx, A, B),
           lambda: ct_dot(ctx, A, B), lambda: ct_dot_plain(ctx, A, B), *ct_dot_work(512, 1, Lq, n))
    del A, B
    check_blind_width(device, gen, record)

    # K3 on the main path: the mod-down's centred conversion of a batched
    # keyswitch of 16 ciphertexts; then a digit's conversion
    sp, lim = ctx.sp_limbs(), ctx.q_limbs(l)
    c, shift = ctx._fbc_consts(sp, lim), ctx._centre_shift(l)
    pre, post = shift[0][0], shift[1][0]
    x = rand_residues((32, len(sp), n), [P[i] for i in sp], gen, device)
    record("fbc", f"{len(sp)}->{len(lim)} x32 centred (mod-down)", ctx._fbc(x, sp, lim, shift),
           fbc_plain(x, c, pre, post), lambda: ctx._fbc(x, sp, lim, shift),
           lambda: fbc_plain(x, c, pre, post),
           32 * (len(sp) + len(lim)) * n * 4, fbc_ops(32, len(sp), len(lim), n))
    grp = tuple(ctx.groups[0])                         # 5 limbs
    other = tuple(i for i in ctx.ext_limbs(l) if i not in grp)  # 15 limbs
    c = ctx._fbc_consts(grp, other)
    x = rand_residues((16, len(grp), n), [P[i] for i in grp], gen, device)
    record("fbc", f"{len(grp)}->{len(other)} x16", ctx._fbc(x, grp, other), fbc_plain(x, c),
           lambda: ctx._fbc(x, grp, other), lambda: fbc_plain(x, c),
           16 * (len(grp) + len(other)) * n * 4, fbc_ops(16, len(grp), len(other), n))
    del x

    ext = ctx.ext_limbs(l)
    E = len(ext)
    digs = rand_residues((ctx.dnum, E, n), [P[i] for i in ext], gen, device)
    keys = rand_residues((31, ctx.dnum, 2, ctx.Ltot, n), P, gen, device)
    perms = torch.from_numpy(np.stack(
        [ctx.plan.auto_perm(ctx.rotation_galois(r)) for r in range(1, 32)])).to(device)
    qe, rinve = ctx._qrow(ext)
    record("ks_mac", "R=31 hoisted", ctx._ks_mac(digs, keys, l, perms),
           ks_mac_plain(digs, keys, l, Lq, qe, rinve, perms),
           lambda: ctx._ks_mac(digs, keys, l, perms),
           lambda: ks_mac_plain(digs, keys, l, Lq, qe, rinve, perms),
           (digs.numel() + 31 * ctx.dnum * 2 * E * n + 31 * n + 31 * 2 * E * n) * 4,
           31 * 2 * E * n * ctx.dnum * (MUL + ADD))
    del digs, keys

    # the streamed store's kernels at one DB group: dim 512 ciphertexts
    B, seed, grp = DIM, 1234, 63
    label = f"{B}x{Lq} limbs"
    record("expand_c1", label, ctx.expand_c1(seed, grp, B, Lq),
           uniform_residues_plain(seed, grp, (B, Lq, n), ctx.q32, ctx.r1_32),
           lambda: ctx.expand_c1(seed, grp, B, Lq),
           lambda: uniform_residues_plain(seed, grp, (B, Lq, n), ctx.q32, ctx.r1_32),
           B * Lq * n * 4, B * Lq * n * UNIFORM_OPS)
    check_seeded_dot(ctx, device, gen, record, rows)
    hi, lo = (torch.from_numpy(a.view(np.int32)).to(device) for a in ctx.split_coeffs(
        np.random.default_rng(5).integers(-(2 ** 40), 2 ** 40, size=(B, n))))
    e = torch.round(torch.randn((B, n), generator=gen, device=device) * 3.19).int()
    record("seeded_pre", label, ctx._seeded_pre(hi, lo, e, Lq),
           seeded_pre_plain(ctx, hi, lo, e, Lq),
           lambda: ctx._seeded_pre(hi, lo, e, Lq), lambda: seeded_pre_plain(ctx, hi, lo, e, Lq),
           (3 * B * n + B * Lq * n) * 4, B * Lq * n * (2 * MUL + 3 * ADD))
    x = ctx.plan.fwd(ctx._seeded_pre(hi, lo, e, Lq), ctx.q_limbs(Lq))
    want = seeded_c0_plain(ctx, x, seed, grp)
    # the kernel writes c0 over its input: compare its first call on a
    # copy; the timed calls repeat the same work on that copy
    xs = x.clone()
    record("seeded_c0", label, ctx._seeded_c0(xs, seed, grp), want,
           lambda: ctx._seeded_c0(xs, seed, grp),
           lambda: seeded_c0_plain(ctx, x, seed, grp),
           (2 * B * Lq * n + Lq * n) * 4, B * Lq * n * (UNIFORM_OPS + MUL + ADD))
    del x, xs, want, hi, lo, e
    check_alone(ctx, device, gen, record)
    check_fused(ctx, device, gen, record, rows)
    check_residue_ops(ctx, device, gen, record)
    check_grote_width(device, gen, record)
    check_dot_bench(ctx)
    check_fbc_bench(ctx)
    check_resid_bench(ctx)
    return rows


def ct_dot_work(K, blocks, l, n, LA=None, seeded=False):
    """(bytes, operations) of a contraction of A [K, 2, LA, n] with `blocks`
    blocks of K ciphertexts at l limbs: A, B (seeded: c0 alone) and the
    output moved once; four products added into 64-bit sums per term, one
    reduction (three Montgomery products, two adds) per output; seeded,
    each c1 residue's Threefry draw too."""
    LA = l if LA is None else LA
    b_words = blocks * K * (1 if seeded else 2) * l * n
    ops = blocks * l * n * (4 * K * MAD + 3 * (3 * MUL + 2 * ADD))
    if seeded:
        ops += blocks * K * l * n * UNIFORM_OPS
    return (K * 2 * LA * n + b_words + blocks * 3 * l * n) * 4, ops


def check_blind_width(device, gen, record):
    """Phase 2, K2 at Blind-Match's shape: K = 4 (its query's ciphertexts)
    by 128 blocks (a row chunk of its DB), 15 limbs (depth 12), on a
    context of Blind-Match's own primes."""
    from image_matching_tpu_torch.ckks.context import CkksContext
    from image_matching_tpu_torch.ckks.params import SchemeParams, compute_required_depth
    from image_matching_tpu_torch.matching.config import MatchConfig
    from image_matching_tpu_torch.matching.senders import ct_dot, ct_dot_plain

    cfg = MatchConfig()
    ctx = CkksContext(SchemeParams.create(mult_depth=compute_required_depth(3, cfg.comp_depth)),
                      seed=SEED + 3, device=device)
    n, l = ctx.n, ctx.Lq
    assert l == 15, l
    K = cfg.vector_dim // cfg.chunk_len  # the query's ciphertexts
    A = rand_residues((K, 2, l, n), ctx.all_primes[:l], gen, device)
    B = rand_residues((128, K, 2, l, n), ctx.all_primes[:l], gen, device)
    record("ct_dot", f"K={K} x 128 blocks, {l} limbs (Blind-Match)", ct_dot(ctx, A, B),
           ct_dot_plain(ctx, A, B), lambda: ct_dot(ctx, A, B), lambda: ct_dot_plain(ctx, A, B),
           *ct_dot_work(K, 128, l, n))
    del ctx, A, B
    torch.cuda.empty_cache()


def check_seeded_dot(ctx, device, gen, record, rows):
    """Phase 2, the seeded contraction (K2's variant that draws K5's c1 in
    registers) against its plain version, and against K5's c1 stacked with
    c0 and contracted by K2 (the route it replaces), bit-exact: at HyDia's
    shape (A [32, 2, 14, N], one group's c0 [512, 14, N] in 16 blocks),
    HERS's (K = 512), with A at 10 limbs (l < L: the counter still runs
    over the group's 14), and for a padding group (zero); each timed
    beside K5's time on one group."""
    from image_matching_tpu_torch.matching.senders import (ct_dot, ct_dot_seeded,
                                                           ct_dot_seeded_plain)

    n, L, P = ctx.n, ctx.Lq, ctx.all_primes
    seed, grp = 2 ** 31 + 5, 2 ** 32 - 3
    c0 = rand_residues((DIM, L, n), P[:L], gen, device)
    k5_ms = rows["expand_c1"]["ms"]
    for label, K, LA in ((f"HyDia K=32 x {DIM // 32} blocks", 32, L), (f"HERS K={DIM}", DIM, L),
                         (f"HyDia, A at 10 of {L} limbs", 32, 10)):
        nb = DIM // K
        A = rand_residues((K, 2, LA, n), P[:LA], gen, device)
        got = ct_dot_seeded(ctx, A, c0, seed, grp, nb)
        stacked = torch.stack([c0, ctx.expand_c1(seed, grp, DIM, L)], dim=1)
        k5_route = ct_dot(ctx, A, stacked.view(nb, K, 2, L, n))
        del stacked
        assert torch.equal(got, k5_route), f"ct_dot_seeded [{label}] differs from K5 + K2"
        ms = record("ct_dot_seeded", label, got, ct_dot_seeded_plain(ctx, A, c0, seed, grp, nb),
                    lambda: ct_dot_seeded(ctx, A, c0, seed, grp, nb),
                    lambda: ct_dot_seeded_plain(ctx, A, c0, seed, grp, nb),
                    *ct_dot_work(K, nb, min(LA, L), n, LA, seeded=True))
        log(f"ct_dot_seeded [{label}] {ms:.4f} ms beside K5's {k5_ms:.4f} ms on the same "
            f"group ({ms / k5_ms:.2f} x K5); equal to K5's c1 contracted by K2")
        del got, k5_route
    pad = ct_dot_seeded(ctx, A, c0, seed, grp, DIM // 32, valid=False)
    assert torch.equal(pad, ct_dot_seeded_plain(ctx, A, c0, seed, grp, DIM // 32, valid=False))
    assert not pad.any(), "a padding group's contraction must be zero"
    log("ct_dot_seeded: a padding group's contraction is zero and equal to its plain version")
    del A, c0, pad


def check_dot_bench(ctx):
    """Phase 2, utils/dot_bench.py: the streamed membership's 64-group
    contraction, seeded and stacked, in turns; with build/ct_dot_prev/
    ct_dot.cu (an earlier design, its own modmath.cuh beside it), K2
    beside that kernel and the stacked route through it."""
    from pathlib import Path

    from image_matching_tpu_torch.utils import dot_bench

    src = Path(__file__).resolve().parent / "build" / "ct_dot_prev" / "ct_dot.cu"
    baseline = dot_bench.build_baseline(src) if src.exists() else None
    if baseline is None:
        log(f"dot_bench: no earlier ct_dot.cu at {src}: the routes of this tree alone")
    for r in dot_bench.measure(ctx, baseline):
        log("dot_bench " + json.dumps(r))
    free_device()


def check_fbc_bench(ctx):
    """Phase 2, utils/fbc_bench.py: K3 and K8 alone at the main path's
    shapes; with build/fbc_prev/ (an earlier basis_convert.cu, decompose.cu
    and the headers beside them), each beside that design built alone, in
    turns."""
    from pathlib import Path

    from image_matching_tpu_torch.utils import fbc_bench

    src = Path(__file__).resolve().parent / "build" / "fbc_prev"
    have = all((src / f).exists() for f in fbc_bench.SOURCES)
    baseline = fbc_bench.build_baseline(src) if have else None
    if baseline is None:
        log(f"fbc_bench: no earlier basis_convert.cu / decompose.cu in {src}: "
            "this tree's kernels alone")
    for r in fbc_bench.measure(ctx, baseline):
        log("fbc_bench " + json.dumps(r))
    free_device()


def check_resid_bench(ctx):
    """Phase 2, utils/resid_bench.py: K7's and K11's passes alone at the
    main path's shapes, with the torch.add yardstick; with build/resid_prev/
    (an earlier rescale.cu, modarith.cu and modmath.cuh), each beside that
    design built alone, in turns."""
    from pathlib import Path

    from image_matching_tpu_torch.utils import resid_bench

    src = Path(__file__).resolve().parent / "build" / "resid_prev"
    have = all((src / f).exists() for f in resid_bench.SOURCES)
    baseline = resid_bench.build_baseline(src) if have else None
    if baseline is None:
        log(f"resid_bench: no earlier rescale.cu / modarith.cu / modmath.cuh in {src}: "
            "this tree's kernels alone")
    for r in resid_bench.measure(ctx, baseline):
        log("resid_bench " + json.dumps(r))
    free_device()


def check_alone(ctx, device, gen, record):
    """Phase 2, K8 and K7's two passes each launched alone, without the
    K1 launches around them, at the main path's shapes: K8 over a
    relinearization's R = 16 and the giant steps' R = 15 coefficient
    stacks at l = 14; the lift pass over the compare circuit's stack of 16
    ciphertexts; the sub-scale pass of the giant steps' mod-down (R = 15,
    each row's c0 gathered through its automorphism) and of a
    relinearization's (R = 16, c0 and c1 added)."""
    from image_matching_tpu_torch.ckks import context as tc

    P, n, l, S = ctx.all_primes, ctx.n, ctx.Lq, ctx.S
    qp = P[:l]
    E = l + S
    for R in (16, 15):
        coeff = rand_residues((R, l, n), qp, gen, device)
        record("decompose", f"K8 alone R={R}x{l} limbs", ctx._decompose_coeff(coeff, l),
               tc.decompose_coeff_plain(ctx, coeff, l), lambda: ctx._decompose_coeff(coeff, l),
               lambda: tc.decompose_coeff_plain(ctx, coeff, l),
               R * (l + ctx.dnum * E) * n * 4,
               sum(fbc_ops(R, len(g), len(o), n) for g, o in ctx._digits(l)))
    del coeff
    top = rand_residues((16, 2, 1, n), [P[l - 1]], gen, device)
    record("rescale_lift", f"lift alone 16x2x1 -> {l - 1} limbs", ctx._rescale_lift(top, l),
           tc.rescale_lift_plain(ctx, top, l), lambda: ctx._rescale_lift(top, l),
           lambda: tc.rescale_lift_plain(ctx, top, l), 16 * 2 * l * n * 4,
           16 * 2 * (l - 1) * n * (2 * MUL + 2 * ADD))
    del top
    ext = ctx.ext_limbs(l)
    perms = torch.from_numpy(np.stack(
        [ctx.plan.auto_perm(ctx.rotation_galois(32 * r)) for r in range(1, 16)])).to(device)
    pinv = ctx._pinv(l)
    for R, k, p in [(15, 1, perms), (16, 2, None)]:
        comp = rand_residues((R, 2, E, n), [P[i] for i in ext], gen, device)
        t = rand_residues((R, 2, l, n), qp, gen, device)
        add = rand_residues((R, k, l, n), qp, gen, device)
        what = "giant steps, c0 gathered" if p is not None else "relinearization"
        record("sub_scale", f"sub-scale alone R={R}x2x{l} limbs ({what})",
               ctx._sub_scale(comp, t, pinv[1], add, p),
               tc.sub_scale_plain(ctx, comp, t, pinv[0], add, p),
               lambda: ctx._sub_scale(comp, t, pinv[1], add, p),
               lambda: tc.sub_scale_plain(ctx, comp, t, pinv[0], add, p),
               (R * (2 + 2 + k + 2) * l * n + (R * n if p is not None else 0)) * 4,
               R * 2 * l * n * (MUL + 2 * ADD) + R * k * l * n * ADD)
    del comp, t, add, perms


def check_ntt_shapes(plan, rows):
    """Phase 2, K1 at the row counts of the main path (2, 28, 160 and 448
    rows; forward and inverse; plain loads and a per-row Galois gather),
    bit-exact with its plain version, timed beside its plain version and,
    where the checkout holds one (build/ntt_prev/ntt.cu, the design before
    this one), beside that earlier kernel built alone, in turns on the same
    inputs (utils/ntt_bench.py)."""
    from pathlib import Path

    from image_matching_tpu_torch.utils import ntt_bench

    src = Path(__file__).resolve().parent / "build" / "ntt_prev" / "ntt.cu"
    baseline = ntt_bench.build_baseline(src) if src.exists() else None
    if baseline is None:
        log(f"K1 shapes: no earlier ntt.cu at {src}: K1 timed alone")
    cases = ntt_bench.measure(plan, baseline)
    for c in cases:
        log("K1 shape " + json.dumps(c))
        assert c["max_abs_err"] == 0, f"K1 differs from its plain version at {c}"
        assert c["baseline_max_abs_err"] in (None, 0), f"the earlier K1 differs at {c}"
    for k in ("ntt_fwd", "ntt_inv"):
        rows[k]["shapes"] = [c for c in cases if c["direction"] == k[-3:]]


def check_fused(ctx, device, gen, record, rows):
    """Phase 2, K7-K10: each fused operation (its kernel passes with the
    K1 launches between them) against its plain version, at HERS's shapes
    first (a relinearization's R = 1, the query's B = 512), then at
    HyDia's batched key switches (R = 15 giant, 31 hoisted rotations)."""
    from image_matching_tpu_torch.ckks import context as tc

    P, n, Lq, S = ctx.all_primes, ctx.n, ctx.Lq, ctx.S
    ext = ctx.ext_limbs(Lq)
    E = len(ext)
    qp = P[:Lq]
    # K7: rescale (K1 inverse of the top limb, lift, K1, sub-scale)
    x = rand_residues((2, Lq, n), qp, gen, device)
    record("rescale_lift", "rescale 2x14 limbs", ctx.rescale(tc.Ciphertext(x, 1.0)).data,
           tc.rescale_plain(ctx, x), lambda: ctx.rescale(tc.Ciphertext(x, 1.0)),
           lambda: tc.rescale_plain(ctx, x), (2 * Lq + 2 * (Lq - 1)) * n * 4,
           ntt_ops(2 + 2 * (Lq - 1), n) + 2 * (Lq - 1) * n * 2 * (MUL + ADD))
    # K7: mod-down (K1 inverse of the specials, centred K3, K1, sub-scale),
    # with a relinearization's addend, then a rotation's gathered c0
    perms = torch.from_numpy(np.stack(
        [ctx.plan.auto_perm(ctx.rotation_galois(r)) for r in range(1, 32)])).to(device)
    for R, add, p in [(1, 2, None), (31, 1, perms)]:
        comp = rand_residues((R, 2, len(ext), n), [P[i] for i in ext], gen, device)
        a = rand_residues((1 if p is not None else R, add, Lq, n), qp, gen, device)
        record("sub_scale", f"mod-down R={R}x2x20 limbs", ctx._moddown(comp, Lq, a, p),
               tc.moddown_plain(ctx, comp, Lq, a, p), lambda: ctx._moddown(comp, Lq, a, p),
               lambda: tc.moddown_plain(ctx, comp, Lq, a, p),
               (comp.numel() + a.numel() + (R * n if p is not None else 0) + R * 2 * Lq * n) * 4,
               ntt_ops(R * 2 * (S + Lq), n) + fbc_ops(R * 2, S, Lq, n)
               + R * 2 * Lq * n * (MUL + 2 * ADD))
    del comp, a
    # K8: decomposition (K1 inverse with the gather, K8, K1 over the stack)
    for R, p in [(1, None), (15, perms[:15])]:
        poly = rand_residues((R, Lq, n), qp, gen, device)
        record("decompose", f"decompose R={R}x14 limbs", ctx._decompose_extended(poly, Lq, p),
               tc.decompose_plain(ctx, poly, Lq, p),
               lambda: ctx._decompose_extended(poly, Lq, p),
               lambda: tc.decompose_plain(ctx, poly, Lq, p),
               (poly.numel() + (R * n if p is not None else 0) + R * ctx.dnum * E * n) * 4,
               ntt_ops(R * (Lq + ctx.dnum * E), n)
               + sum(fbc_ops(R, len(g), len(o), n) for g, o in ctx._digits(Lq)))
    del poly
    # K9: tensor product and decryption (MAC + REDC, K1)
    y = rand_residues((2, Lq, n), qp, gen, device)
    record("tensor", "2x14 limbs pair", ctx._tensor(x, y), tc.tensor_plain(ctx, x, y),
           lambda: ctx._tensor(x, y), lambda: tc.tensor_plain(ctx, x, y),
           7 * Lq * n * 4, Lq * n * (4 * MUL + ADD))
    record("tensor", "square 2x14 limbs", ctx._tensor(x, None), tc.tensor_plain(ctx, x),
           lambda: ctx._tensor(x, None), lambda: tc.tensor_plain(ctx, x),
           5 * Lq * n * 4, Lq * n * (3 * MUL + ADD))
    d = rand_residues((3, Lq, n), qp, gen, device)
    record("decrypt_mac", "decrypt 3x14 limbs", ctx._decrypt_impl(d), tc.decrypt_plain(ctx, d),
           lambda: ctx._decrypt_impl(d), lambda: tc.decrypt_plain(ctx, d),
           5 * Lq * n * 4, Lq * n * (4 * MUL + 2 * ADD) + ntt_ops(Lq, n))
    del x, y, d
    # K10: public-key encryption of the HERS query, B = 512 (pre, K1, MAC)
    B = DIM
    m = rand_residues((B, Lq, n), qp, gen, device)
    v = torch.randint(-1, 2, (B, n), generator=gen, device=device)
    e0, e1 = (torch.round(torch.randn((B, n), generator=gen, device=device) * 3.19).long()
              for _ in range(2))
    want = tc.pk_encrypt_plain(ctx, m, v, e0, e1, Lq)
    torch.cuda.empty_cache()
    record("pk_pre", f"encrypt B={B}x14 limbs", ctx._encrypt_impl(m, v, e0, e1, Lq), want,
           lambda: ctx._encrypt_impl(m, v, e0, e1, Lq),
           lambda: tc.pk_encrypt_plain(ctx, m, v, e0, e1, Lq),
           (B * Lq * n * 4 + 3 * B * n * 8 + 2 * Lq * n * 4 + B * 2 * Lq * n * 4),
           B * Lq * n * (4 * MUL + 2 * MUL + 3 * ADD) + ntt_ops(3 * B * Lq, n))
    rows["pk_mac"] = dict(rows["pk_pre"])  # one operation, two passes
    del m, v, e0, e1, want
    torch.cuda.empty_cache()


def check_residue_ops(ctx, device, gen, record):
    """Phase 2, K11: the standalone residue ops against their plain
    versions (ops/modmath.py) at the shapes of the compare circuit and of
    the sums: add, mul_plain and mul_scalar on [2, 14, N]; the row sum of
    HyDia's 15 giant steps and of 128 rows, one output of Blind-Match's
    compression at 2^15."""
    from image_matching_tpu_torch.ops import modmath as mm

    P, n, Lq = ctx.all_primes, ctx.n, ctx.Lq
    m = ctx._mod(Lq)
    a = rand_residues((2, Lq, n), P[:Lq], gen, device)
    b = rand_residues((2, Lq, n), P[:Lq], gen, device)
    pt = rand_residues((Lq, n), P[:Lq], gen, device)
    const = ctx._mont_const(987654321, ctx.q_limbs(Lq))
    el = a.numel()
    for label, op, y, nbytes, ops in [
            ("add 2x14 limbs", "add", b, 3 * el * 4, el * ADD),
            ("mul_plain 2x14 limbs by 14 limbs", "mul", pt, (2 * el + pt.numel()) * 4, el * MUL),
            ("mul_scalar 2x14 limbs by 14x1", "mul", const, (2 * el + Lq) * 4, el * MUL)]:
        record("modarith", label, mm.residue_op(op, a, y, m),
               mm.residue_op_plain(op, a, y, m.q, m.rinv), lambda: mm.residue_op(op, a, y, m),
               lambda: mm.residue_op_plain(op, a, y, m.q, m.rinv), nbytes, ops)
    del a, b, pt
    for R, l in [(15, Lq), (128, Lq - 1)]:
        rows = rand_residues((R, 2, l, n), P[:l], gen, device)
        ml = ctx._mod(l)
        record("mod_sum", f"row sum R={R} x 2x{l} limbs", mm.row_sum(rows, ml),
               mm.row_sum_plain(rows, ml.q), lambda: mm.row_sum(rows, ml),
               lambda: mm.row_sum_plain(rows, ml.q), (R + 1) * 2 * l * n * 4,
               R * 2 * l * n * ADD)
        del rows


def check_grote_width(device, gen, record):
    """Phase 2 at GROTE's width (depth 18: 21 q limbs, 8 special, the widest
    parameter set): the mod-down's conversion from 8 special limbs (K3's
    limit) and the decomposition into 29 extended limbs, at l = 21."""
    from image_matching_tpu_torch.ckks import context as tc
    from image_matching_tpu_torch.ckks.context import CkksContext
    from image_matching_tpu_torch.ckks.params import SchemeParams, compute_required_depth
    from image_matching_tpu_torch.matching.config import MatchConfig

    cfg = MatchConfig()
    ctx = CkksContext(SchemeParams.create(
        mult_depth=compute_required_depth(2, cfg.comp_depth, cfg.alpha_depth)),
        seed=SEED + 2, device=device)
    P, n, Lq, S = ctx.all_primes, ctx.n, ctx.Lq, ctx.S
    assert (Lq, S) == (21, 8), (Lq, S)
    ext = ctx.ext_limbs(Lq)
    E = len(ext)
    comp = rand_residues((1, 2, E, n), [P[i] for i in ext], gen, device)
    a = rand_residues((1, 2, Lq, n), P[:Lq], gen, device)
    record("sub_scale", f"mod-down R=1x2x{E} limbs (GROTE)", ctx._moddown(comp, Lq, a),
           tc.moddown_plain(ctx, comp, Lq, a), lambda: ctx._moddown(comp, Lq, a),
           lambda: tc.moddown_plain(ctx, comp, Lq, a), (comp.numel() + 2 * a.numel()) * 4,
           ntt_ops(2 * (S + Lq), n) + fbc_ops(2, S, Lq, n))
    poly = rand_residues((1, Lq, n), P[:Lq], gen, device)
    record("decompose", f"decompose R=1x{Lq} limbs (GROTE)", ctx._decompose_extended(poly, Lq),
           tc.decompose_plain(ctx, poly, Lq), lambda: ctx._decompose_extended(poly, Lq),
           lambda: tc.decompose_plain(ctx, poly, Lq), (poly.numel() + ctx.dnum * E * n) * 4,
           ntt_ops(Lq + ctx.dnum * E, n))
    del ctx, comp, a, poly
    torch.cuda.empty_cache()


def timed(times, label, fn):
    """fn() with the host clock around it, ending in a device sync."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    times[label] = time.perf_counter() - t
    return out


def expected_matches(query, db, thr):
    from image_matching_tpu_torch.matching import vector_utils as vu
    sims = vu.cosine_similarity(vu.normalize(query)[None, :], vu.normalize(db))
    return sims, sorted(int(i) for i in np.nonzero(sims >= thr)[0])


def setup_split(times, fn):
    """Run fn (a MatchingProtocol.setup) and split its time into
    enrollment, rotation keys and context keygen."""
    from image_matching_tpu_torch.ckks.context import CkksContext
    from image_matching_tpu_torch.matching import streaming

    enroll, henroll = streaming.enroll_diag_streamed, streaming.enroll_hers_streamed
    gen = CkksContext.gen_rotation_keys
    times.update(enroll_s=0.0, rotation_keys_s=0.0)

    def wrap(key, f):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = f(*a, **k)
            torch.cuda.synchronize()
            times[key] += time.perf_counter() - t
            return out
        return run

    streaming.enroll_diag_streamed = wrap("enroll_s", enroll)
    streaming.enroll_hers_streamed = wrap("enroll_s", henroll)
    CkksContext.gen_rotation_keys = wrap("rotation_keys_s", gen)
    try:
        proto = timed(times, "setup_s", fn)
    finally:
        streaming.enroll_diag_streamed, streaming.enroll_hers_streamed = enroll, henroll
        CkksContext.gen_rotation_keys = gen
    # the rest of setup is the context's construction: its key generation
    times["keygen_s"] = times["setup_s"] - times["enroll_s"] - times["rotation_keys_s"]
    return proto


def queries(proto, qcts, times):
    """Membership and index: a first call, then three repetitions each."""
    for rep in ("first", 1, 2, 3):
        mem = timed(times, f"membership_{rep}_s", lambda: proto.membership(qcts))
        idx = timed(times, f"index_{rep}_s", lambda: proto.index(qcts))
    return mem, idx


def streamed_phase(approach, cfg, device, smi):
    """Phases 5 and 8: the streamed, seed-compressed store of `approach`
    at 2^20 with the derived device-memory budget, through the user entry
    points.  The kernel counts cover setup, the query's encryption, the
    queries and their decryption."""
    from image_matching_tpu_torch.matching.protocol import MatchingProtocol
    from image_matching_tpu_torch.ops import kernels
    from image_matching_tpu_torch.utils.io import gen_dataset

    name = f"{APPROACH[approach]} streamed 2^{NVEC_STREAM.bit_length() - 1}"
    times = {}
    query, db = timed(times, "gen_dataset_s", lambda: gen_dataset(NVEC_STREAM, DIM, seed=SEED))
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    proto = setup_split(times, lambda: MatchingProtocol.setup(
        approach, db, cfg, seed=SEED, device=device, streamed=True))
    qcts = timed(times, "encrypt_query_s", lambda: proto.encrypt_query(query))
    setup_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mem, idx = queries(proto, qcts, times)
    query_peak = torch.cuda.max_memory_allocated()
    one_membership_launches(name, proto, qcts)
    member = proto.decrypt_membership(mem)
    found = sorted(proto.decrypt_index(idx))
    launches = kernels.counts()
    store = proto.sender.store
    times.update(groups=store.num_groups, resident_groups=store.resident_count(),
                 pinned_groups=store.host_count(),
                 store_gb=store.num_groups * store.group_bytes() / 1e9,
                 peak_mem_gib=max(setup_peak, query_peak) / 2 ** 30,
                 query_peak_mem_gib=query_peak / 2 ** 30)
    log(f"{name} on {smi}: " + json.dumps(times) + " launches " + json.dumps(launches))

    sims, expect = expected_matches(query, db, cfg.match_threshold)
    log(f"{name} membership {member}; index {found[:10]} ({len(found)}); "
        f"expected {expect[:10]}")
    assert member is True, f"{name}: membership must be True (vector 0 is planted)"
    assert found == expect and 0 in found, f"{name}: index differs from the plaintext set"
    t = {}
    scores = timed(t, "similarity_s", lambda: proto.sender.compute_similarity(qcts))
    vals = proto.receiver.decrypt_scores(scores)[:NVEC_STREAM]
    assert vals.shape == sims.shape and np.all(np.isfinite(vals))
    err = float(np.abs(vals - sims).max())
    log(f"{name} score parity: max |decrypted - cosine| = {err:.3e} over {NVEC_STREAM} "
        f"vectors; similarity alone {t['similarity_s']:.4f} s "
        f"({t['similarity_s'] / store.num_groups * 1e3:.3f} ms per group)")
    assert err <= 1e-4, f"{name}: score parity above the 1e-4 bar"
    return launches, dict(proto=proto, qcts=qcts, mem=mem, idx=idx, expect=expect)


def one_membership_launches(name, proto, qcts):
    """One more membership: its kernel launches (all, and by kernel) and
    K1's launches by row count (NttPlan.rows_hist), read around it."""
    from image_matching_tpu_torch.ops import kernels

    hist = proto.ctx.plan.rows_hist
    hist.clear()
    before = kernels.counts()
    proto.membership(qcts)
    torch.cuda.synchronize()
    by_kernel = {k: v - before[k] for k, v in kernels.counts().items() if v > before[k]}
    log(f"{name}: one membership launched {sum(by_kernel.values())} kernels "
        f"{json.dumps(by_kernel)}; K1 launches by rows {json.dumps(dict(sorted(hist.items())))}")


def pinned_phase(cfg, device, smi):
    """Phase 6: 2^17 vectors with resident_budget=0, so every group crosses
    PCIe on every query, served single-device and then sharded (the
    host-tier copies run per shard); then the same store all resident must
    give a bit-equal membership ciphertext.  Returns the launches of the
    single-device path and of each sharded one."""
    from image_matching_tpu_torch.matching import streaming
    from image_matching_tpu_torch.matching.protocol import MatchingProtocol
    from image_matching_tpu_torch.ops import kernels
    from image_matching_tpu_torch.utils.io import gen_dataset

    times = {}
    query, db = gen_dataset(NVEC_PINNED, DIM, seed=SEED)
    kernels.reset_counts()
    proto = setup_split(times, lambda: MatchingProtocol.setup(
        5, db, cfg, seed=SEED, device=device, streamed=True, resident_budget=0))
    store = proto.sender.store
    assert store.resident_count() == 0 and all(g.is_pinned() for g in store.groups)
    qcts = proto.encrypt_query(query)
    mem, idx = queries(proto, qcts, times)
    member = proto.decrypt_membership(mem)
    found = sorted(proto.decrypt_index(idx))
    launches = kernels.counts()
    sim_pinned = [timed(times, f"similarity_pinned_{r}_s",
                        lambda: proto.sender.compute_similarity(qcts)) for r in (1, 2)][-1]

    # one group's host-to-device copy alone, CUDA events, mean of the groups
    buf = torch.empty_like(store.groups[0], device=device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for g in store.groups:
        buf.copy_(g, non_blocking=True)
    end.record()
    end.synchronize()
    h2d_ms = start.elapsed_time(end) / store.num_groups
    del buf
    sims, expect = expected_matches(query, db, cfg.match_threshold)
    shard_launches = sharded_phase(
        f"HyDia pinned 2^{NVEC_PINNED.bit_length() - 1}", True,
        dict(proto=proto, qcts=qcts, mem=mem, idx=idx, expect=expect), launches, device, smi)
    assert store.resident_count() == 0

    streaming._promote_resident(store, store.num_groups * store.group_bytes())
    assert store.host_count() == 0
    mem_res = timed(times, "membership_resident_s", lambda: proto.membership(qcts))
    for r in (1, 2):
        timed(times, f"similarity_resident_{r}_s", lambda: proto.sender.compute_similarity(qcts))
    G = store.num_groups
    per_group = {k: v / G * 1e3 for k, v in times.items() if k.startswith("similarity_")}
    log(f"pinned 2^{NVEC_PINNED.bit_length() - 1} on {smi}: " + json.dumps(times)
        + " launches " + json.dumps(launches))
    log(f"pinned 2^{NVEC_PINNED.bit_length() - 1} per group: host-to-device copy {h2d_ms:.3f} ms "
        f"({store.group_bytes() / h2d_ms / 1e6:.2f} GB/s); similarity ms per group "
        + json.dumps(per_group) + " (copies overlap the compute when the pinned time per "
        "group is near the larger of copy and resident compute, not their sum)")

    log(f"pinned membership {member}; index {found[:10]}; expected {expect[:10]}")
    assert member is True and found == expect and 0 in found, "pinned decisions differ"
    assert torch.equal(mem.data, mem_res.data), \
        "membership from the pinned tier differs from the same store all resident"
    vals = proto.receiver.decrypt_scores(sim_pinned)[:NVEC_PINNED]
    err = float(np.abs(vals - sims).max())
    log(f"pinned score parity {err:.3e}; membership ciphertext bit-equal to all-resident")
    assert err <= 1e-4
    return launches, shard_launches


def require_launched(launches, names, path):
    missing = [k for k in names if launches[k] == 0]
    assert not missing, f"kernels never launched on the {path} path: {missing}"


def in_memory_phase(approach, cfg, device, smi, nvec=NVEC):
    """Phases 3, 7 and 9: `approach` with an in-memory encrypted DB of
    `nvec` vectors, its context at the approach's own depth.  The kernel
    counts cover setup, the query's encryption, the queries and their
    decryption."""
    from image_matching_tpu_torch.matching import enrollers, protocol
    from image_matching_tpu_torch.matching.protocol import MatchingProtocol
    from image_matching_tpu_torch.ops import kernels
    from image_matching_tpu_torch.utils.io import gen_dataset

    name = f"{APPROACH[approach]} in-memory 2^{nvec.bit_length() - 1}"
    query, db = gen_dataset(nvec, DIM, seed=SEED)
    times = {}
    # time the enrollment inside setup: the protocol looks the enroller up
    # on its module at call time
    attr = protocol.ENROLLERS[approach]
    enroll = getattr(enrollers, attr)

    def timed_enroll(*a, **k):
        return timed(times, "enroll_s", lambda: enroll(*a, **k))

    setattr(enrollers, attr, timed_enroll)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    try:
        proto = timed(times, "setup_s", lambda: MatchingProtocol.setup(
            approach, db, cfg, seed=SEED, device=device))
    finally:
        setattr(enrollers, attr, enroll)
    qcts = timed(times, "encrypt_query_s", lambda: proto.encrypt_query(query))
    mem = timed(times, "membership_s", lambda: proto.membership(qcts))
    idx = timed(times, "index_s", lambda: proto.index(qcts))
    member = proto.decrypt_membership(mem)
    found = sorted(proto.decrypt_index(idx))
    launches = kernels.counts()
    times["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    p = proto.ctx.params
    times.update(q_limbs=p.num_limbs, special=p.num_special,
                 gallery_gb=proto.sender.db.data.numel() * 4 / 1e9)
    log(f"{name} on {smi}: " + json.dumps(times) + " launches " + json.dumps(launches))

    sims, expect = expected_matches(query, db, cfg.match_threshold)
    log(f"{name} membership {member}; index {found[:10]} ({len(found)}); "
        f"expected {expect[:10]}")
    assert mem.data.shape == (2, mem.limbs, proto.ctx.n)
    assert member is True, f"{name}: membership must be True (vector 0 is planted)"
    assert found == expect and 0 in found, f"{name}: index differs from the plaintext set"
    t = {}
    scores = timed(t, "similarity_s", lambda: proto.sender.compute_similarity(qcts))
    vals = proto.receiver.decrypt_scores(scores)[:nvec]
    assert vals.shape == sims.shape and np.all(np.isfinite(vals))
    err = float(np.abs(vals - sims).max())
    log(f"{name} score parity: max |decrypted - cosine| = {err:.3e} over {nvec} vectors; "
        f"similarity alone {t['similarity_s']:.4f} s")
    assert err <= 1e-4, f"{name}: score parity above the 1e-4 bar"
    return launches, dict(proto=proto, qcts=qcts, mem=mem, idx=idx, expect=expect)


def sharded_phase(name, streamed, res, launches, device, smi, shard_counts=(4, 3)):
    """The sharded scenario (parallel/sharded.py) over the protocol of a
    phase just run (`res`: its protocol, query, single-device membership
    and index, the plaintext index set), on one-card meshes of each count
    of `shard_counts` (a mesh naming cuda:0 that many times) and, where the
    machine has 2 or more cards, over cuda:0..k-1 (k = min(count, 4)) with
    context replicas.  Each run: membership and index, decrypted; the
    decisions equal the plaintext set; the membership ciphertext and the
    real groups' index flags bit-equal to the single-device ones wherever
    the padding adds nothing (streamed: always; in memory: when the shard
    count divides the group count); K12 and every kernel the unsharded
    path launched outside setup and query encryption launched (K11's row
    sum aside: K12 sums the flags here).  Returns each run's launches, by
    path."""
    from image_matching_tpu_torch.ckks.context import Ciphertext
    from image_matching_tpu_torch.ops import kernels
    from image_matching_tpu_torch.parallel import sharded

    proto, qcts, mem, idx, expect = (res[k] for k in ("proto", "qcts", "mem", "idx", "expect"))
    G = len(idx)
    cls = sharded.ShardedStreamedScenario if streamed else sharded.ShardedScenario
    # K12 takes over the row sum of the membership's flags (K11 mod_sum)
    need = [k for k, v in launches.items()
            if v > 0 and k not in ENCRYPT_KERNELS + ("mod_sum",)] + ["psum_mod"]
    meshes = [(f"{n} shards on one card", [device] * n) for n in shard_counts]
    cards = torch.cuda.device_count()
    if cards >= 2:
        k = min(cards, 4)
        meshes.append((f"{k} shards on {k} cards", [torch.device("cuda", i) for i in range(k)]))
    else:
        log(f"{name} sharded: the mesh over real cards was not run: this machine has "
            f"{cards} CUDA device (it needs 2 or more); the one-card meshes run the "
            "partition, padding, per-shard compare and K12 reduction")
    out = {}
    for label, devs in meshes:
        times = {}
        routes = dict(sharded.copy_routes)
        kernels.reset_counts()
        scen = timed(times, "construct_s", lambda: cls(proto.sender, sharded.make_mesh(devices=devs)))
        smem = timed(times, "membership_s", lambda: scen.membership(qcts))
        sidx = timed(times, "index_s", lambda: scen.index(qcts))
        member = proto.decrypt_membership(Ciphertext(smem.data.to(device), smem.scale))
        found = sorted(proto.decrypt_index([Ciphertext(f.data.to(device), f.scale) for f in sidx]))
        counts = kernels.counts()
        n = len(devs)
        exact = streamed or G % n == 0
        same = torch.equal(smem.data.to(device), mem.data) and all(
            torch.equal(a.data, b.data.to(device)) for a, b in zip(idx, sidx[:G]))
        copies = {k: v - routes[k] for k, v in sharded.copy_routes.items()}
        if len(set(devs)) > 1:
            # the last call's per-card windows on the host clock: each
            # card's issuing thread began, finished issuing, its card done
            log(f"{name} sharded, {label}: per-card windows of the last call "
                + json.dumps(scen.windows))
        log(f"{name} sharded, {label} on {smi}: " + json.dumps(times)
            + f" membership {member}; index {found[:10]} ({len(found)} of {len(sidx)} flags); "
            f"bit-equal to one device: {same} (required: {exact}); partial copies {copies}; "
            "launches " + json.dumps(counts))
        assert member is True and found == expect, f"{name} sharded {label}: decisions differ"
        assert same or not exact, f"{name} sharded {label}: not bit-equal to one device"
        require_launched(counts, need, f"{name} sharded, {label}")
        out[f"{label}"] = counts
        del scen, smem, sidx
        free_device()
    if cards >= 2:
        d2d_copy(proto, device, name)
    return out


def d2d_copy(proto, device, name):
    """One DB group copied from card 0 to card 1, CUDA events, mean of 5."""
    sender = proto.sender
    group = sender.store.groups[0] if hasattr(sender, "store") else sender.db.data[0]
    src = group.to(device)
    dst = torch.empty_like(src, device=torch.device("cuda", 1))
    ms = cuda_ms(lambda: dst.copy_(src, non_blocking=True))
    log(f"{name}: one group ({src.numel() * 4 / 1e9:.3f} GB) card 0 -> card 1 in {ms:.3f} ms "
        f"({src.numel() * 4 / ms / 1e6:.1f} GB/s; peer access "
        f"{torch.cuda.can_device_access_peer(1, 0)})")


def free_device():
    gc.collect()
    torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one GPU",
              file=sys.stderr)
        sys.exit(2)
    from image_matching_tpu_torch.ckks.context import CkksContext
    from image_matching_tpu_torch.ckks.params import SchemeParams, compute_required_depth
    from image_matching_tpu_torch.matching.config import MatchConfig
    from image_matching_tpu_torch.ops import kernels
    from image_matching_tpu_torch.utils import native

    device = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {smi}; "
        f"host CRT decode in C++: {native.available()}")

    # phase 1: build
    t0 = time.perf_counter()
    kernels.lib()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc {kernels.build_seconds} s; "
        f"library {kernels.build().name})")
    log("\n".join(line for line in kernels.build_log.splitlines()
                  if "registers" in line or "spill" in line))

    # phase 2: kernels against their plain versions at the main path's shapes
    cfg = MatchConfig()
    depth = compute_required_depth(5, cfg.comp_depth)
    assert compute_required_depth(4, cfg.comp_depth) == depth  # one parameter set serves both
    params = SchemeParams.create(mult_depth=depth)
    log(f"params: ring {params.ring_dim}, {params.num_limbs} q limbs, "
        f"{params.num_special} special, dnum {params.dnum}")
    rows = check_kernels(CkksContext(params, seed=SEED + 1, device=device), device)
    free_device()
    # K12: sharded paths only; K5: its c1 is drawn inside ct_dot_seeded on
    # every path, and checked in phase 2 alone
    unsharded = [k for k in kernels.KERNELS if k not in ("psum_mod", "expand_c1")]
    in_memory = [k for k in unsharded if k not in SEEDED_KERNELS]
    streamed = [k for k in unsharded if k != "ct_dot"]  # the seeded variant contracts
    slot_packing = [k for k in in_memory if k != "ct_dot"]
    launches = {}

    def sharded(key, name, streamed, res, shard_counts=(4, 3)):
        for label, counts in sharded_phase(name, streamed, res, launches[key], device, smi,
                                           shard_counts).items():
            launches[f"{key}_sharded {label}"] = counts

    # phases 3-4: HyDia in memory, then K12 at its flag's limbs, then sharded
    launches["hydia_in_memory"], res = in_memory_phase(5, cfg, device, smi)
    require_launched(launches["hydia_in_memory"], in_memory, "HyDia in-memory")
    check_psum_mod(rows, res["mem"].limbs, device)
    sharded("hydia_in_memory", "HyDia in-memory 2^16", False, res, (4, 2, 3))
    del res
    free_device()
    # phase 5: streamed at 2^20, then sharded; 6: forced pinned, sharded inside
    launches["hydia_streamed"], res = streamed_phase(5, cfg, device, smi)
    require_launched(launches["hydia_streamed"], streamed, "HyDia streamed 2^20")
    sharded("hydia_streamed", "HyDia streamed 2^20", True, res)
    del res
    free_device()
    launches["hydia_pinned"], pinned_sharded = pinned_phase(cfg, device, smi)
    free_device()
    require_launched(launches["hydia_pinned"], streamed, "HyDia forced-pinned 2^17")
    for label, counts in pinned_sharded.items():
        launches[f"hydia_pinned_sharded {label}"] = counts
    # phases 7-8: HERS in memory at 2^16 (then sharded) and streamed at 2^20
    launches["hers_in_memory"], res = in_memory_phase(4, cfg, device, smi)
    require_launched(launches["hers_in_memory"], in_memory, "HERS in-memory")
    sharded("hers_in_memory", "HERS in-memory 2^16", False, res, (4, 2, 3))
    del res
    free_device()
    launches["hers_streamed"] = streamed_phase(4, cfg, device, smi)[0]  # drops its 60 GB store
    free_device()
    require_launched(launches["hers_streamed"], streamed, "HERS streamed 2^20")
    # phase 9: Baseline, GROTE and Blind-Match in memory at 2^15
    for approach, key, need in [(1, "baseline_in_memory", slot_packing),
                                (2, "grote_in_memory", slot_packing),
                                (3, "blind_in_memory", in_memory)]:
        launches[key] = in_memory_phase(approach, cfg, device, smi, NVEC_SLOTS)[0]
        free_device()
        require_launched(launches[key], need, f"{APPROACH[approach]} in-memory 2^15")
    imported = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "image_matching_tpu"))
    assert not imported, f"the port's smoke run imported {imported}"

    src = "image_matching_tpu_torch/csrc/"
    ctx_py = "image_matching_tpu/ckks/context.py"
    meta = {
        "ntt_fwd": ("ntt.cu", "image_matching_tpu/ops/ntt.py:231"),
        "ntt_inv": ("ntt.cu", "image_matching_tpu/ops/ntt.py:260"),
        "ct_dot": ("ct_dot.cu", "image_matching_tpu/matching/senders.py:53"),
        # with the expand_c1 before it (image_matching_tpu/ops/prng.py:51)
        "ct_dot_seeded": ("ct_dot.cu", "image_matching_tpu/matching/senders.py:53"),
        "fbc": ("basis_convert.cu", f"{ctx_py}:837"),
        "ks_mac": ("keyswitch.cu", f"{ctx_py}:940"),
        "expand_c1": ("prng.cu", "image_matching_tpu/ops/prng.py:51"),
        "seeded_pre": ("seeded_encrypt.cu", f"{ctx_py}:495"),
        "seeded_c0": ("seeded_encrypt.cu", f"{ctx_py}:512"),
        "rescale_lift": ("rescale.cu", f"{ctx_py}:768"),
        "sub_scale": ("rescale.cu", f"{ctx_py}:890"),
        "decompose": ("decompose.cu", f"{ctx_py}:859"),
        "tensor": ("tensor.cu", f"{ctx_py}:734"),
        "decrypt_mac": ("tensor.cu", f"{ctx_py}:609"),
        "pk_pre": ("pk_encrypt.cu", f"{ctx_py}:420"),
        "pk_mac": ("pk_encrypt.cu", f"{ctx_py}:420"),
        "modarith": ("modarith.cu", "image_matching_tpu/ops/modmath.py:90"),
        "mod_sum": ("modarith.cu", "image_matching_tpu/matching/senders.py:45"),
        "psum_mod": ("psum_mod.cu", "image_matching_tpu/parallel/sharded.py:37"),
    }
    # launches: the sum over every driven path (each counted from 0 just
    # before it and read just after its decryption); launches_by_path has
    # each.  No single PyTorch call computes a modular residue op, an NTT,
    # a key switch or a modular sum of separate buffers, so library_ms is
    # null throughout.
    out = [{"name": k, "route": "cuda", "source": src + meta[k][0],
            "replaces": meta[k][1], "launches": sum(c[k] for c in launches.values()),
            "launches_by_path": {p: c[k] for p, c in launches.items()},
            "max_abs_err": rows[k]["max_abs_err"], "ms": rows[k]["ms"],
            "plain_ms": rows[k]["plain_ms"], "bound_ms": rows[k]["bound_ms"],
            "bound_by": rows[k]["bound_by"], "library_ms": None, "shape": rows[k]["shape"],
            **({"shapes": rows[k]["shapes"]} if "shapes" in rows[k] else {})}
           for k in kernels.KERNELS]
    log(f"total {time.perf_counter() - T0:.1f} s")
    log(smi)
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

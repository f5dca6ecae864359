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
     also at 2 to 960 rows, with and without a per-row Galois
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
     K6's two passes on one group and K10's pre and MAC passes alone on
     64, 128 and 1 ciphertexts of 14 limbs and 64 of GROTE's 21 (int32
     noise), at utils/enc_bench.py's shapes and bounds, before the fused operation
     at B = 512; where build/enc_prev/ holds an earlier seeded_encrypt.cu,
     pk_encrypt.cu, threefry.cuh and modmath.cuh, K6's and K10's passes
     alone beside that design in turns, K5 on K6's draws and K4 at one
     membership's shapes (utils/enc_bench.py); K9's decryption of a list
     of separate ciphertexts (one MAC pass over their addresses, one K1
     inverse) at 64 and 1 ciphertexts of [2, 2, N] (the streamed index
     flags, the membership) and 1 of [3, 14, N]; where build/dec_prev/
     holds an earlier tensor.cu and modmath.cuh, the MAC pass alone
     beside that design in turns (utils/dec_bench.py);
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
     membership and K1's launches by row count; the receiver's decryption
     of the membership and of the index (host clock), the index's flags in
     one decrypt MAC launch; every kernel launched but K5 and ct_dot (the
     seeded contraction draws c1 in registers);
  6. 2^17 vectors (8 groups) with resident_budget=0, so every group
     crosses PCIe on every query: the same decisions, the per-group copy
     and compute times, and a membership ciphertext bit-equal to the same
     store served all resident;
  7. HERS (approach 4) in memory at 2^16 (4 matrices of 512 feature
     ciphertexts, a 512-ciphertext query), as phase 3;
  8. the streamed HERS store at 2^20 (64 groups), as phase 5;
  9. Baseline (approach 1), GROTE (approach 2) and Blind-Match (approach 3)
     in memory at 2^15 vectors, each at its own depth (13, 18, 12), as
     phase 3 (and but K2 for Baseline and GROTE);
 10. the artifact (harness/run_artifact.py): the five approaches in memory
     at 2^10 vectors through the latency CLI's run, from a `.dat` that
     write_dataset writes into a temporary directory: five latency.csv
     rows under the CLI's header, each membership True with vector 0 in
     its index; each approach's scheme summary and seconds;
 11. serialization (utils/serial.py): the artifact's HyDia context and
     in-memory DB saved to a temporary directory and loaded on the card:
     keys and DB bit-equal to the saved ones, and a membership from the
     loaded state bit-equal to the saved protocol's on the same query
     ciphertext, with the same launches, and decrypting True;
 12. the accuracy campaign (harness/accuracy_campaign.py) at full size:
     11,057 identities x 4 plus 50 queries x 2 borderline entries, 44,328
     vectors in a streamed HyDia store (the last group padded), score
     parity per query: TP 200, FN 0, parity <= 1e-4 and every
     encrypted/plaintext decision disagreement inside the +-0.06 band;
 13. the streamed store's on-disk caches (matching/streaming.py) for HyDia
     at 2^16 vectors (4 groups, the caches' threshold) in a temporary
     IMTPU_STORE_DIR, after the free disk space: (a) the native engine
     writes the c0 cache (4 group files and meta.json); (b) without
     meta.json, a resume re-enrolls exactly the newest group, from the
     generator state (a) had there, leaving the trusted files untouched
     and the store bit-equal to (a)'s; (c) a streamed setup on the device
     engine loads the cache: no K6 launch, groups bit-equal to (a)'s,
     membership True, the index equal to the plaintext set, parity <=
     1e-4; (d) the pinned engine (resident_budget=0) cold and then warm
     from the encode cache, with two contexts of one seed: c0 bit-equal and
     no file written by the warm run.  Seconds and bytes of each step.
     Phases 1-12 run with IMTPU_STORE_DIR="" (no cache).
Sharded (parallel/sharded.py), reusing the protocols above: after phase 3,
K12 (the modular sum of shard partials) against its plain version at the
flag's shape, P = 4 x 16 rows, 4 and 8 one-row buffers and one of 16 rows
(and utils/psum_bench.py beside an earlier psum_mod.cu where
build/psum_prev/ holds one);
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
Tensor parallelism (parallel/tensor.py), after the sharded HyDia 2^16
runs: its kernel variants (K1's column and row passes alone, K4 and K7
reading a full-width source) against their plain versions at ring 32768
and D = 4, bit-exact; TPScenario's membership and index over one-card
meshes of 4 slot shards and, where the machine has 2 or more cards, over
cuda:0..k-1 (k = 4, or 2), bit-equal to one device with the decisions
right, the variants and every kernel of the unsharded queries launched and
K1's whole transform never; then the bytes and host times of a sharded
NTT's and rotation's exchanges beside one device's.
K11 (standalone residue arithmetic) must launch on every path; nothing of
jax or of the JAX package may be imported.  The last lines are the card's
name and power limit, one JSON line of per-kernel results (with each
kernel's bound: the larger of its bytes over 3.35 TB/s and its 32-bit
integer operations over 67 T/s, the float32 rate: Hopper issues integer
add, xor and shift at a lower one), and the JSON result line.
"""

import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from image_matching_tpu_torch.utils.benchkit import (ADD, BUTTERFLY_OPS, MUL, SLEEP_CYCLES_PER_CALL,
                                                     THREEFRY_OPS, bound, ntt_ops)

NVEC = 1 << 16          # in-memory HyDia and HERS
NVEC_SLOTS = 1 << 15    # in-memory Baseline, GROTE, Blind-Match
NVEC_STREAM = 1 << 20   # streamed phases: 64 groups of 16384 vectors
NVEC_PINNED = 1 << 17   # forced-pinned phase: 8 groups
NVEC_CACHE = 1 << 16    # the caches' phase: 4 groups, the caches' threshold
LOG2N_ARTIFACT = 10     # the artifact's gallery, as tools/run_artifact.py
CAMPAIGN = dict(queries=50, n_ids=11057, per_id=4, borderline=2)  # 44,328 vectors
DIM = 512
SEED = 0
SEEDED_KERNELS = ("ct_dot_seeded", "seeded_pre", "seeded_c0")  # the streamed store's
ENCRYPT_KERNELS = ("pk_pre", "pk_mac", "seeded_pre", "seeded_c0")  # setup, query encryption
APPROACH = {1: "Baseline", 2: "GROTE", 3: "Blind-Match", 4: "HERS", 5: "HyDia"}
MAD = 2                    # a product added into a 64-bit sum (mad.wide.u32)
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
    torch.cuda._sleep(int(iters * SLEEP_CYCLES_PER_CALL))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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
    from pathlib import Path

    from image_matching_tpu_torch.parallel import sharded
    from image_matching_tpu_torch.utils import psum_bench

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
    # utils/psum_bench.py beside an earlier psum_mod.cu in build/psum_prev/
    src = Path(__file__).resolve().parent / "build" / "psum_prev"
    if not all((src / f).exists() for f in psum_bench.SOURCES):
        log(f"psum_bench: no earlier psum_mod.cu / modmath.cuh in {src}: not run")
        return
    for r in psum_bench.measure(psum_bench.build_baseline(src), device):
        log("psum_bench " + json.dumps(r))


def check_kernels(ctx, device):
    """Phase 2: each kernel against its plain version, bit-exact."""
    from image_matching_tpu_torch.ckks.context import fbc_plain, ks_mac_plain
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
           B * Lq * n * 4, B * Lq * n * THREEFRY_OPS)
    check_seeded_dot(ctx, device, gen, record, rows)
    check_enc_passes(ctx, gen, record)
    check_alone(ctx, device, gen, record)
    check_fused(ctx, device, gen, record, rows)
    check_residue_ops(ctx, device, gen, record)
    check_grote_width(device, gen, record)
    check_dot_bench(ctx)
    check_fbc_bench(ctx)
    check_resid_bench(ctx)
    check_enc_bench(ctx)
    check_dec_bench(ctx)
    return rows


def check_enc_passes(ctx, gen, record):
    """Phase 2, the encryption passes each launched alone, without the K1
    launch between them, at enc_bench's shapes and bounds: K6's pre and c0
    passes on one streamed group [512, l, N] (seed and group >= 2^31), then
    K10's pre and MAC passes on B = 64, 128 and 1 ciphertexts at ctx's top
    level (the in-memory enrollment's chunks, a chunk of the HERS query, a
    HyDia query; GROTE's l = 21 in check_grote_width), int32 noise."""
    from image_matching_tpu_torch.utils import enc_bench

    record_cases(record, ("seeded_pre", "seeded_c0"), enc_bench.seeded_cases(ctx, None, gen, DIM))
    free_device()
    for B in (64, 128, 1):
        record_cases(record, ("pk_pre", "pk_mac"), enc_bench.pk_cases(ctx, None, gen, B))
        free_device()


def record_cases(record, names, cases):
    """Record enc_bench's (label, kernel, baseline, plain, bytes,
    operations) cases under the kernel names, one each in turn."""
    for name, (label, new, _, want, nbytes, ops) in zip(names, cases):
        record(name, label, new(), want(), new, want, nbytes, ops)


def check_enc_bench(ctx):
    """Phase 2, utils/enc_bench.py where build/enc_prev/ holds an earlier
    seeded_encrypt.cu, pk_encrypt.cu, threefry.cuh and modmath.cuh: K6's
    and K10's passes alone and K10 fused beside that design built alone,
    in turns; K5 on K6's draws; K4 at one membership's shapes."""
    from pathlib import Path

    from image_matching_tpu_torch.utils import enc_bench

    src = Path(__file__).resolve().parent / "build" / "enc_prev"
    if not all((src / f).exists() for f in enc_bench.SOURCES):
        log(f"enc_bench: no earlier seeded_encrypt.cu / pk_encrypt.cu / threefry.cuh / "
            f"modmath.cuh in {src}: not run")
        return
    for r in enc_bench.measure(ctx, baseline=enc_bench.build_baseline(src)):
        log("enc_bench " + json.dumps(r))
    free_device()


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
        ops += blocks * K * l * n * THREEFRY_OPS
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


def check_dec_bench(ctx):
    """Phase 2, utils/dec_bench.py where build/dec_prev/ holds an earlier
    tensor.cu and modmath.cuh: K9's decrypt MAC alone at the receivers'
    shapes beside that design built alone, in turns."""
    from pathlib import Path

    from image_matching_tpu_torch.utils import dec_bench

    src = Path(__file__).resolve().parent / "build" / "dec_prev"
    if not all((src / f).exists() for f in dec_bench.SOURCES):
        log(f"dec_bench: no earlier tensor.cu / modmath.cuh in {src}: not run")
        return
    for r in dec_bench.measure(ctx, dec_bench.build_baseline(src)):
        log("dec_bench " + json.dumps(r))
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
    """Phase 2, K1 at the row counts of the main path (2 to 960 rows,
    utils/ntt_bench.py SHAPES; forward and inverse; plain loads and a
    per-row Galois gather),
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
    from image_matching_tpu_torch.utils import dec_bench

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
    # the decryption of a list of separate ciphertexts: one MAC pass over
    # their addresses, one K1 inverse (the streamed index's 64 flags, the
    # membership, the kernel table's row)
    for B, k, l in [(64, 2, 2), (1, 2, 2), (1, 3, Lq)]:
        blocks = [rand_residues((k, l, n), qp[:l], gen, device) for _ in range(B)]
        nbytes, ops = dec_bench.mac_work(B, k, l, n)
        record("decrypt_mac", f"decrypt {B} ciphertexts [{k},{l},N] (MAC, K1)",
               ctx._decrypt_group(blocks), tc.decrypt_plain(ctx, torch.stack(blocks)),
               lambda: ctx._decrypt_group(blocks),
               lambda: tc.decrypt_plain(ctx, torch.stack(blocks)), nbytes,
               ops + ntt_ops(B * l, n))
    del x, y, blocks
    # K10: public-key encryption of the HERS query, B = 512 (pre, K1, MAC;
    # its passes alone in check_pk_passes)
    B = DIM
    m = rand_residues((B, Lq, n), qp, gen, device)
    v = torch.randint(-1, 2, (B, n), generator=gen, device=device).int()
    e0, e1 = (torch.round(torch.randn((B, n), generator=gen, device=device) * 3.19).int()
              for _ in range(2))
    want = tc.pk_encrypt_plain(ctx, m, v, e0, e1, Lq)
    torch.cuda.empty_cache()
    record("pk_pre", f"encrypt B={B}x14 limbs (pre, K1, MAC)", ctx._encrypt_impl(m, v, e0, e1, Lq),
           want, lambda: ctx._encrypt_impl(m, v, e0, e1, Lq),
           lambda: tc.pk_encrypt_plain(ctx, m, v, e0, e1, Lq),
           (B * Lq * n * 4 + 3 * B * n * 4 + 2 * Lq * n * 4 + B * 2 * Lq * n * 4),
           B * Lq * n * (4 * MUL + 6 * ADD) + ntt_ops(3 * B * Lq, n))
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
    limit) and the decomposition into 29 extended limbs, at l = 21; K10's
    passes alone on an enrollment chunk of 64 ciphertexts of 21 limbs."""
    from image_matching_tpu_torch.ckks import context as tc
    from image_matching_tpu_torch.ckks.context import CkksContext
    from image_matching_tpu_torch.ckks.params import SchemeParams, compute_required_depth
    from image_matching_tpu_torch.matching.config import MatchConfig
    from image_matching_tpu_torch.utils import enc_bench

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
    del comp, a, poly
    record_cases(record, ("pk_pre", "pk_mac"), enc_bench.pk_cases(ctx, None, gen, 64, " (GROTE)"))
    del ctx
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
    member = timed(times, "decrypt_membership_s", lambda: proto.decrypt_membership(mem))
    before = kernels.counts()["decrypt_mac"]
    found = sorted(timed(times, "decrypt_index_s", lambda: proto.decrypt_index(idx)))
    launches = kernels.counts()
    # the flags decrypt together: one MAC launch a (components, limbs) group
    groups = {}
    for f in idx:
        groups[f.ncomp, f.limbs] = groups.get((f.ncomp, f.limbs), 0) + 1
    dec = launches["decrypt_mac"] - before
    log(f"{name}: the index's {len(idx)} flags decrypted with {dec} decrypt_mac launch(es)")
    assert dec == sum(-(-g // proto.ctx.DECRYPT_CAP) for g in groups.values()), \
        f"{name}: the index flags were not decrypted together"
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


def check_tp_kernels(tp, rows, device):
    """TP phase: each slot-shard kernel variant (kernels.TP_KERNELS) against
    its plain version, bit-exact, at ring 32768 and D = tp.mesh.size, on
    shard 1's slice (the main path's shapes: 8 x 20 limbs for K1's passes;
    31 hoisted rotations for K4's full-width digits; the giant steps, R =
    15, for K7's full-width c0).  The plain versions are the split stages
    (ops/ntt.py) and ks_mac_plain / sub_scale_plain on the same operands."""
    from image_matching_tpu_torch.ckks import context as tc
    from image_matching_tpu_torch.ckks.context import CkksContext
    from image_matching_tpu_torch.ops.ntt import ntt_fwd_stages, ntt_inv_stages, permute_rows

    record = recorder(rows)
    gen = torch.Generator(device=device)
    gen.manual_seed(77)
    ctx, D = tp.ctx, tp.mesh.size
    sh = 1 % D
    c = tp.shards[sh]
    plan, P, n, Lq = ctx.plan, ctx.all_primes, ctx.n, ctx.Lq
    w, a = n // D, plan.logn - 8
    E, off = 1 << a, sh * (1 << a) // D
    mine = lambda t: t[..., sh * w:(sh + 1) * w].contiguous()  # noqa: E731
    ext = ctx.ext_limbs(Lq)
    L, B = len(ext), 8
    idx = plan.limb_index(ext).long()
    psis, ipsis, q = plan.psis[idx], plan.ipsis[idx], plan.q[idx].long()
    ninv = plan.ninv[idx].long().view(L, 1)
    x = rand_residues((B, L, w), [P[i] for i in ext], gen, device)
    full = rand_residues((B, L, n), [P[i] for i in ext], gen, device)
    perms = torch.from_numpy(np.stack([plan.auto_perm(ctx.rotation_galois(r))
                                       for r in range(1, B + 1)])).to(device)
    own = mine(perms)
    out = torch.empty_like(x)
    label = f"{B}x{L} limbs of N/{D}, shard {sh}"
    data = 2 * x.numel() * 4
    tws = 2 * L * w * 4  # the row pass's twiddles and their Shoup companions
    cols_ops, rows_ops = (B * L * (w // 2) * st * BUTTERFLY_OPS for st in (a, 8))
    record("ntt_fwd_cols", label, plan.launch_pass(out, x, ext, False, True),
           ntt_fwd_stages(x.long(), psis, q, 1, E, inner=w // E).int(),
           lambda: plan.launch_pass(out, x, ext, False, True),
           lambda: ntt_fwd_stages(x.long(), psis, q, 1, E, inner=w // E).int(), data, cols_ops)
    y = x.clone()
    record("ntt_inv_cols", label + ", in place", plan.launch_pass(y, y, ext, True, True),
           (ntt_inv_stages(x.long(), ipsis, q, 1, E, inner=w // E) * ninv % q.view(L, 1)).int(),
           lambda: plan.launch_pass(y, y, ext, True, True),
           lambda: (ntt_inv_stages(x.long(), ipsis, q, 1, E, inner=w // E) * ninv
                    % q.view(L, 1)).int(), data, cols_ops + B * L * w * MUL)
    for name, inverse, stages in (("ntt_fwd_rows", False, ntt_fwd_stages),
                                  ("ntt_inv_rows", True, ntt_inv_stages)):
        tw = ipsis if inverse else psis
        record(name, label + f", blk_off {off}", plan.launch_pass(out, x, ext, inverse, False, off),
               stages(x.long(), tw, q, E, n, nblk=D, blk=sh).int(),
               lambda: plan.launch_pass(out, x, ext, inverse, False, off),
               lambda: stages(x.long(), tw, q, E, n, nblk=D, blk=sh).int(), data + tws, rows_ops)
    src = mine(permute_rows(full, perms))
    record("ntt_inv_rows", label + ", a rotation gathered from the full-width source",
           plan.launch_pass(out, full, ext, True, False, off, own),
           ntt_inv_stages(src.long(), ipsis, q, E, n, nblk=D, blk=sh).int(),
           lambda: plan.launch_pass(out, full, ext, True, False, off, own),
           lambda: ntt_inv_stages(mine(permute_rows(full, perms)).long(), ipsis, q, E, n,
                                  nblk=D, blk=sh).int(),
           data + tws + own.numel() * 4, rows_ops)
    del x, full, out, y, src
    # K4: the hoisted baby steps' MAC reading the all-gathered digit stack
    R = 31
    digs = rand_residues((ctx.dnum, L, n), [P[i] for i in ext], gen, device)
    keys = rand_residues((R, ctx.dnum, 2, ctx.Ltot, w), P, gen, device)
    rp = mine(torch.from_numpy(np.stack([plan.auto_perm(ctx.rotation_galois(r))
                                         for r in range(1, R + 1)])).to(device))
    qe, rinve = c._qrow(ext)
    record("ks_mac_wide", f"R={R} hoisted, digits [3,{L},N], shard {sh} of {D}",
           CkksContext._ks_mac(c, digs, keys, Lq, rp),
           tc.ks_mac_plain(digs, keys, Lq, Lq, qe, rinve, rp),
           lambda: CkksContext._ks_mac(c, digs, keys, Lq, rp),
           lambda: tc.ks_mac_plain(digs, keys, Lq, Lq, qe, rinve, rp),
           (digs.numel() + R * ctx.dnum * 2 * L * w + R * w + R * 2 * L * w) * 4,
           R * 2 * L * w * ctx.dnum * (MUL + ADD))
    del digs, keys
    # K7: the giant steps' mod-down adding c0 gathered from the full width
    R = 15
    rp = mine(torch.from_numpy(np.stack([plan.auto_perm(ctx.rotation_galois(32 * r))
                                         for r in range(1, R + 1)])).to(device))
    comp = rand_residues((R, 2, L, w), [P[i] for i in ext], gen, device)
    t = rand_residues((R, 2, Lq, w), P[:Lq], gen, device)
    add = rand_residues((R, 1, Lq, n), P[:Lq], gen, device)
    pinv = c._pinv(Lq)
    record("sub_scale_wide", f"R={R}x2x{Lq} limbs, c0 [R,1,{Lq},N] gathered, shard {sh} of {D}",
           CkksContext._sub_scale(c, comp, t, pinv[1], add, rp),
           tc.sub_scale_plain(c, comp, t, pinv[0], add, rp),
           lambda: CkksContext._sub_scale(c, comp, t, pinv[1], add, rp),
           lambda: tc.sub_scale_plain(c, comp, t, pinv[0], add, rp),
           (R * (2 + 2 + 1 + 2) * Lq * w + R * w) * 4,
           R * 2 * Lq * w * (MUL + 2 * ADD) + R * Lq * w * ADD)


def tp_costs(tp, proto, qcts, label):
    """One NTT's and one rotation's exchange over the mesh: the bytes that
    cross shards (``Exchange.bytes``) and host-clock times (every card
    synced) of 10 sharded transforms of [2, 14, N] (two all-to-alls each)
    and of their all-to-alls alone, beside one device's transform; of 10
    sharded rotations by 1 beside one device's."""
    ctx, D = proto.ctx, tp.mesh.size
    lim = ctx.q_limbs(ctx.Lq)
    data = qcts[0].data.contiguous()  # [2, 14, N]
    reps = 10

    def sync_all():
        for d in tp.mesh.distinct():
            torch.cuda.synchronize(d)

    def host_s(fn):
        fn()
        sync_all()
        t = time.perf_counter()
        fn()
        sync_all()
        return (time.perf_counter() - t) / reps

    ct = type(qcts[0])(data, qcts[0].scale)
    parts = tp.run_shards(lambda s, c: tp._local(s, ct).data)
    R, cw = (1 << (ctx.plan.logn - 8)) // D, 256 // D
    before = dict(tp.ex.bytes)
    tp.run_shards(lambda s, c: c.plan.fwd(parts[s], lim))
    ntt_bytes = tp.ex.bytes["all_to_all"] - before["all_to_all"]
    before = dict(tp.ex.bytes)
    tp.rotate(ct, 1)
    rot_bytes = {k: v - before[k] for k, v in tp.ex.bytes.items()}

    def a2a(s, c):
        for _ in range(reps):
            cols = tp.ex.all_to_all(s, parts[s].view(2, -1, R, D, cw), -2, -3)
            tp.ex.all_to_all(s, cols, -3, -2)

    out = {
        "ntt_exchange_bytes": ntt_bytes,
        "ntt_sharded_ms": 1e3 * host_s(lambda: tp.run_shards(
            lambda s, c: [c.plan.fwd(parts[s], lim) for _ in range(reps)])),
        "ntt_all_to_alls_ms": 1e3 * host_s(lambda: tp.run_shards(a2a)),
        "ntt_one_device_ms": 1e3 * host_s(lambda: [ctx.plan.fwd(data, lim) for _ in range(reps)]),
        "rotation_exchange_bytes": rot_bytes,
        "rotation_sharded_ms": 1e3 * host_s(lambda: tp.run_shards(
            lambda s, c: [c.rotate(type(ct)(parts[s], ct.scale), 1) for _ in range(reps)])),
        "rotation_one_device_ms": 1e3 * host_s(lambda: [ctx.rotate(ct, 1) for _ in range(reps)]),
    }
    log(f"TP costs, {label} ([2,{ctx.Lq},N] at N = {ctx.n}; host clock, every card synced): "
        + json.dumps(out))


def tp_phase(name, res, launches, rows, device, smi):
    """Slot-sharded tensor parallelism (parallel/tensor.py) over the
    protocol of phase 3 (`res`): TPScenario's membership and index over a
    one-card mesh of 4 shards and, where the machine has 2 or more cards,
    over cuda:0..k-1 (k = 4, or 2 on a machine of 2 or 3 cards).  Each
    run: the membership ciphertext and index flags bit-equal to one
    device's, the decisions equal to the plaintext set, the slot shards'
    kernel variants and every kernel the unsharded queries launched
    (outside encryption, decryption and K1's whole transform, which the
    passes replace: none of those may launch) counted in the run; first
    the variants against their plain versions (`check_tp_kernels`), then
    each mesh's exchange bytes and times (`tp_costs`).  Returns each run's
    launches, by path."""
    from image_matching_tpu_torch.ckks.context import Ciphertext
    from image_matching_tpu_torch.ops import kernels
    from image_matching_tpu_torch.parallel import sharded, tensor

    proto, qcts, mem, idx, expect = (res[k] for k in ("proto", "qcts", "mem", "idx", "expect"))
    skip = ENCRYPT_KERNELS + ("decrypt_mac", "ntt_fwd", "ntt_inv", "mod_sum")
    need = [k for k, v in launches.items() if v > 0 and k not in skip] + list(kernels.TP_KERNELS)
    meshes = [("4 shards on one card", [device] * 4)]
    cards = torch.cuda.device_count()
    if cards >= 2:
        k = 4 if cards >= 4 else 2
        meshes.append((f"{k} shards on {k} cards", [torch.device("cuda", i) for i in range(k)]))
    else:
        log(f"{name} TP: the mesh over real cards was not run: this machine has {cards} "
            "CUDA device (it needs 2 or more)")
    out = {}
    for label, devs in meshes:
        times = {}
        scen = timed(times, "construct_s", lambda: tensor.TPScenario(
            proto.sender, sharded.make_mesh(devices=devs)))
        if label == meshes[0][0]:
            check_tp_kernels(scen.tp, rows, device)
        kernels.reset_counts()
        b0 = dict(scen.tp.ex.bytes)
        tmem = timed(times, "membership_first_s", lambda: scen.membership(qcts))
        mem_bytes = {k: v - b0[k] for k, v in scen.tp.ex.bytes.items()}
        mem_counts = {k: v for k, v in kernels.counts().items() if v}
        tidx = timed(times, "index_first_s", lambda: scen.index(qcts))
        counts = kernels.counts()
        for rep in (1, 2):
            timed(times, f"membership_{rep}_s", lambda: scen.membership(qcts))
            timed(times, f"index_{rep}_s", lambda: scen.index(qcts))
        same = (tmem.scale == mem.scale and torch.equal(tmem.data.to(device), mem.data)
                and len(tidx) == len(idx)
                and all(torch.equal(a.data, b.data.to(device)) for a, b in zip(idx, tidx)))
        member = proto.decrypt_membership(Ciphertext(tmem.data.to(device), tmem.scale))
        found = sorted(proto.decrypt_index([Ciphertext(f.data.to(device), f.scale) for f in tidx]))
        log(f"{name} TP, {label} on {smi}: " + json.dumps(times)
            + f" membership {member}; index {found[:10]} ({len(found)}); bit-equal to one "
            f"device: {same}; exchange bytes a membership {mem_bytes}; launches a "
            f"membership {json.dumps(mem_counts)}; with the index " + json.dumps(counts))
        assert same, f"{name} TP {label}: not bit-equal to one device"
        assert member is True and found == expect, f"{name} TP {label}: decisions differ"
        require_launched(counts, need, f"{name} TP, {label}")
        assert counts["ntt_fwd"] == counts["ntt_inv"] == 0, \
            f"{name} TP {label}: K1's whole transform launched on the sharded path"
        tp_costs(scen.tp, proto, qcts, label)
        out[label] = counts
        del scen, tmem, tidx
        free_device()
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


def artifact_phase(device):
    """Phase 10: the artifact runner's five approaches in memory at
    2^LOG2N_ARTIFACT through the latency CLI's run.  Returns the launches
    and the HyDia protocol (kept from its setup) for phase 11."""
    from image_matching_tpu_torch.harness import latency, run_artifact
    from image_matching_tpu_torch.matching.protocol import MatchingProtocol
    from image_matching_tpu_torch.ops import kernels

    kept = {}
    setup = MatchingProtocol.setup

    def keep(approach, *a, **k):
        proto = setup(approach, *a, **k)
        if approach == 5:
            kept["proto"] = proto
        return proto

    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "latency.csv")
        MatchingProtocol.setup = staticmethod(keep)
        kernels.reset_counts()
        try:
            rows, failures = run_artifact.run(LOG2N_ARTIFACT, csv_path=csv, device=device)
        finally:
            MatchingProtocol.setup = staticmethod(setup)
        launches = kernels.counts()
        with open(csv) as f:
            text = f.read()
    seconds = time.perf_counter() - t
    for row in rows:
        log(f"artifact {row['approach']}: {row['scheme']}; " + json.dumps(
            {k: row[k] for k in ("query_enc_s", "membership_s", "membership_dec_s",
                                 "index_s", "index_dec_s", "query_cts", "index_cts")})
            + f" membership {row['membership_result']}, index {row['index_result'][:10]}")
    log("artifact latency.csv:\n" + text.rstrip("\n"))
    log(f"artifact: {len(rows)} approaches at 2^{LOG2N_ARTIFACT} in {seconds:.1f} s; "
        "launches " + json.dumps(launches))
    lines = text.splitlines(keepends=True)
    assert lines[0] == latency.CSV_HEADER and len(lines) == 6, "artifact: latency.csv rows"
    assert not failures, f"artifact: approaches {failures} failed (membership, index)"
    return launches, kept["proto"]


def serial_phase(proto, device):
    """Phase 11: the HyDia context and in-memory DB of phase 10 saved and
    loaded on the card; the loaded state's membership and its decryption
    against the saved protocol's on one query ciphertext: the same
    ciphertext, the same launches."""
    from image_matching_tpu_torch.matching import receivers, senders
    from image_matching_tpu_torch.ops import kernels
    from image_matching_tpu_torch.utils import serial
    from image_matching_tpu_torch.utils.io import gen_dataset

    ctx, db, cfg = proto.ctx, proto.sender.db, proto.cfg
    query, _ = gen_dataset(1 << LOG2N_ARTIFACT, DIM, seed=SEED)
    qcts = proto.encrypt_query(query)
    kernels.reset_counts()
    mem = proto.membership(qcts)
    assert proto.decrypt_membership(mem) is True
    want = kernels.counts()
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        timed(times, "save_s", lambda: (serial.save_context(ctx, tmp),
                                        serial.save_db(db, tmp, "hydia")))
        size = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
        ctx2 = timed(times, "load_context_s", lambda: serial.load_context(tmp, device=device))
        db2 = timed(times, "load_db_s", lambda: serial.load_db(tmp, "hydia", device=device))
    pairs = [("s_eval", ctx.s_eval, ctx2.s_eval), ("pk_b", ctx.pk_b, ctx2.pk_b),
             ("pk_a", ctx.pk_a, ctx2.pk_a), ("relin_key", ctx.relin_key, ctx2.relin_key),
             ("db", db.data, db2.data)]
    assert len(ctx2._rot_sets) == len(ctx._rot_sets) and ctx2.rot_keys == ctx.rot_keys
    for i, ((p, k), (p2, k2)) in enumerate(zip(ctx._rot_sets, ctx2._rot_sets)):
        pairs += [(f"rotset_{i}_perms", p, p2), (f"rotset_{i}_keys", k, k2)]
    for name, a, b in pairs:
        assert b.device == a.device and b.dtype == a.dtype and torch.equal(a, b), \
            f"serial: {name} differs after the round trip"
    assert np.array_equal(ctx._s_eval_std, ctx2._s_eval_std)
    assert np.array_equal(ctx._s_coeffs, ctx2._s_coeffs)
    assert (db2.num_vectors, db2.scale, db2.bsgs, db2.n1) == \
        (db.num_vectors, db.scale, db.bsgs, db.n1)
    sender = senders.make_sender(5, ctx2, cfg, db2)
    receiver = receivers.make_receiver(5, ctx2, cfg, db2.num_vectors)
    kernels.reset_counts()
    mem2 = timed(times, "membership_s", lambda: sender.run_membership(qcts))
    member = receiver.decrypt_membership(mem2)
    launches = kernels.counts()
    log(f"serial: {size / 2 ** 30:.3f} GiB saved; " + json.dumps(times)
        + f"; membership from the loaded state {member}, bit-equal "
        f"{torch.equal(mem.data, mem2.data)}; launches " + json.dumps(launches))
    assert torch.equal(mem.data, mem2.data) and mem2.scale == mem.scale, \
        "serial: the loaded state's membership differs from the saved protocol's"
    assert launches == want, f"serial: launches {launches} differ from {want}"
    require_launched(launches, [k for k, v in want.items() if v > 0], "serial")
    assert member is True, "serial: the loaded state's membership must decrypt True"
    return launches


def campaign_phase(device):
    """Phase 12: the accuracy campaign at full size, streamed, with parity."""
    from image_matching_tpu_torch.harness import accuracy_campaign
    from image_matching_tpu_torch.ops import kernels

    t = time.perf_counter()
    kernels.reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        s = accuracy_campaign.campaign(**CAMPAIGN, csv_path=os.path.join(tmp, "accuracy.csv"),
                                       device=device)
    launches = kernels.counts()
    seconds = time.perf_counter() - t
    near = s["near_threshold"]
    log("campaign summary " + json.dumps(s))
    log(f"campaign: {s['db_vectors']} vectors, {s['queries']} queries in {seconds:.1f} s; "
        f"encrypted {s['totals_encrypted']}, plaintext {s['totals_plaintext']}; "
        f"{s['decision_disagreements_total']} decision disagreements, "
        f"{near['enc_plain_decision_disagreements']} in the band of {near['entries_total']} "
        f"entries; max parity {s['max_score_parity_err']:.3e}; launches " + json.dumps(launches))
    enc = s["totals_encrypted"]
    assert enc["TP"] == CAMPAIGN["per_id"] * CAMPAIGN["queries"] and enc["FN"] == 0, \
        "campaign: TP/FN"
    assert s["max_score_parity_err"] <= accuracy_campaign.PARITY_TOL, "campaign: score parity"
    assert s["decision_disagreements_total"] == near["enc_plain_decision_disagreements"], \
        "campaign: a decision disagreement outside the near band"
    return launches


def cache_phase(params, cfg, device, smi):
    """Phase 13: the on-disk caches of the streamed HyDia store at
    NVEC_CACHE in a temporary IMTPU_STORE_DIR.  Returns the launches of
    (c)'s path (the setup from the cache, the query's encryption, the
    queries and their decryption) and of (d)'s two pinned setups."""
    import shutil
    from image_matching_tpu_torch.ckks.context import CkksContext
    from image_matching_tpu_torch.matching import streaming
    from image_matching_tpu_torch.matching.protocol import MatchingProtocol
    from image_matching_tpu_torch.ops import kernels
    from image_matching_tpu_torch.utils.io import gen_dataset

    name = f"cache 2^{NVEC_CACHE.bit_length() - 1}"
    query, db = gen_dataset(NVEC_CACHE, DIM, seed=SEED)
    times, sizes = {}, {}

    def tree(d):
        """Each file of d: (inode, mtime, bytes), which a rewrite changes."""
        return {f: (st.st_ino, st.st_mtime_ns, st.st_size)
                for f, st in ((f, os.stat(os.path.join(d, f))) for f in sorted(os.listdir(d)))}

    with tempfile.TemporaryDirectory() as tmp:
        os.environ["IMTPU_STORE_DIR"] = tmp
        try:
            free = shutil.disk_usage(tmp).free
            log(f"{name}: IMTPU_STORE_DIR in {tmp}, {free / 1e9:.1f} GB free")
            # (a) the native engine writes the c0 cache; the generator's
            # state before each group's draw is kept for (b)
            ctx = CkksContext(params, seed=SEED, device=device)
            host_enroll, states, enrolled = ctx.encrypt_seeded_batch_host, {}, []

            def spy(vals, seed, group, *a, **k):
                states.setdefault(group, ctx._rng.bit_generator.state)
                enrolled.append(group)
                return host_enroll(vals, seed, group, *a, **k)

            ctx.encrypt_seeded_batch_host = spy
            store_a = timed(times, "a_native_write_s", lambda: streaming.enroll_diag_streamed(
                ctx, cfg, db, resident_budget=0, engine="native", verbose=True))
            [cdir] = [os.path.join(tmp, d) for d in os.listdir(tmp)]
            G = store_a.num_groups
            files = tree(cdir)
            assert list(files) == [f"g{g:04d}.npy" for g in range(G)] + ["meta.json"] \
                and G == 4, f"{name}: (a) the cache holds {list(files)}"
            sizes["c0_cache_bytes"] = sum(st[2] for st in files.values())
            # (b) an interrupted run: no meta.json; the resume trusts all
            # but the newest file and re-enrolls that one from (a)'s state
            os.remove(os.path.join(cdir, "meta.json"))
            enrolled.clear()
            ctx._rng.bit_generator.state = states[G - 1]
            store_b = timed(times, "b_resume_s", lambda: streaming.enroll_diag_streamed(
                ctx, cfg, db, resident_budget=0, engine="native", verbose=True))
            after = tree(cdir)
            assert enrolled == [G - 1], f"{name}: (b) re-enrolled groups {enrolled}"
            assert "meta.json" in after and all(after[f] == files[f] for f in list(files)[: G - 1]), \
                f"{name}: (b) a trusted file was rewritten"
            assert all(torch.equal(a, b) for a, b in zip(store_a.groups, store_b.groups)), \
                f"{name}: (b) the resumed store differs from (a)'s"
            assert all(g.is_pinned() for g in store_a.groups + store_b.groups)
            del store_b, ctx
            free_device()
            # (c) a streamed setup on the device engine loads the cache
            kernels.reset_counts()
            proto = setup_split(times, lambda: MatchingProtocol.setup(
                5, db, cfg, seed=SEED, device=device, streamed=True, engine="device"))
            k6 = {k: kernels.counts()[k] for k in ("seeded_pre", "seeded_c0")}
            store = proto.sender.store
            equal = all(torch.equal(a.to(device), b) for a, b in zip(store_a.groups, store.groups))
            del store_a
            qcts = timed(times, "c_encrypt_query_s", lambda: proto.encrypt_query(query))
            mem = timed(times, "c_membership_s", lambda: proto.membership(qcts))
            idx = timed(times, "c_index_s", lambda: proto.index(qcts))
            member = proto.decrypt_membership(mem)
            found = sorted(proto.decrypt_index(idx))
            launches = kernels.counts()
            sims, expect = expected_matches(query, db, cfg.match_threshold)
            vals = proto.receiver.decrypt_scores(proto.sender.compute_similarity(qcts))[:NVEC_CACHE]
            err = float(np.abs(vals - sims).max())
            times["c_load_s_per_group"] = times["enroll_s"] / G
            log(f"{name} (c): {store.resident_count()} of {G} groups resident; K6 during the "
                f"setup {json.dumps(k6)}; groups bit-equal to (a)'s {equal}; membership "
                f"{member}; index {found[:10]} ({len(found)}), expected {expect[:10]}; parity "
                f"{err:.3e}")
            assert k6 == {"seeded_pre": 0, "seeded_c0": 0}, f"{name}: (c) K6 ran: not loaded"
            assert equal, f"{name}: (c) the loaded groups differ from (a)'s store"
            assert member is True and found == expect and 0 in found, f"{name}: (c) decisions"
            assert err <= 1e-4, f"{name}: (c) score parity above the 1e-4 bar"
            del proto, store, qcts, mem, idx
            free_device()
            # (d) the pinned engine: cold (writes the encode cache), warm
            # (reads it), two contexts of one seed
            kernels.reset_counts()
            stores = []
            for step in ("cold", "warm"):
                ctx = CkksContext(params, seed=SEED, device=device)
                if step == "warm":
                    [edir] = [os.path.join(tmp, d) for d in os.listdir(tmp)
                              if d.startswith("enc_")]
                    enc_files = tree(edir)
                stores.append(timed(times, f"d_pinned_{step}_enroll_s",
                                    lambda: streaming.enroll_diag_streamed(
                                        ctx, cfg, db, resident_budget=0, engine="pinned",
                                        verbose=True)))
                del ctx
            pinned_launches = kernels.counts()
            assert tree(edir) == enc_files, f"{name}: (d) the warm run wrote a file"
            assert list(enc_files) == [f"g{g:04d}.npy" for g in range(G)]
            sizes["encode_cache_bytes"] = sum(st[2] for st in enc_files.values())
            cold, warm = stores
            assert all(g.is_pinned() for g in cold.groups + warm.groups)
            assert all(torch.equal(a, b) for a, b in zip(cold.groups, warm.groups)), \
                f"{name}: (d) the warm c0 differs from the cold c0"
            del stores, cold, warm
        finally:
            os.environ["IMTPU_STORE_DIR"] = ""
    free_device()
    per_group = {f"{k}_per_group": times[k] / G
                 for k in ("a_native_write_s", "d_pinned_cold_enroll_s", "d_pinned_warm_enroll_s")}
    log(f"{name} on {smi}: " + json.dumps({**times, **per_group, **sizes})
        + " launches " + json.dumps(launches) + " pinned launches " + json.dumps(pinned_launches))
    return launches, pinned_launches


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
    # no on-disk cache before phase 13: setups stay comparable and write
    # nothing into the tree
    os.environ["IMTPU_STORE_DIR"] = ""
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
    unsharded = [k for k in kernels.KERNELS
                 if k not in ("psum_mod", "expand_c1") + kernels.TP_KERNELS]
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
    # slot-sharded tensor parallelism over the same protocol
    for label, counts in tp_phase("HyDia in-memory 2^16", res, launches["hydia_in_memory"], rows,
                                  device, smi).items():
        launches[f"hydia_in_memory_tp {label}"] = counts
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
    # phases 10-12: the artifact, serialization of its HyDia state, the
    # accuracy campaign
    launches["artifact"], proto = artifact_phase(device)
    require_launched(launches["artifact"], in_memory, "artifact")
    launches["serial"] = serial_phase(proto, device)
    del proto
    free_device()
    launches["campaign"] = campaign_phase(device)
    free_device()
    require_launched(launches["campaign"], streamed, "accuracy campaign")
    # phase 13: the on-disk caches; the cached setup launches no K6, the
    # pinned setups do
    launches["cache"], launches["cache_pinned"] = cache_phase(params, cfg, device, smi)
    require_launched(launches["cache"], [k for k in streamed if k not in SEEDED_KERNELS[1:]],
                     "cached streamed setup")
    require_launched(launches["cache_pinned"], SEEDED_KERNELS[1:], "pinned setups")
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
        # tensor parallelism's variants (image_matching_tpu/parallel/tensor.py
        # partitions the same kernels over the slot axis)
        "ntt_fwd_cols": ("ntt.cu", "image_matching_tpu/ops/ntt.py:231"),
        "ntt_fwd_rows": ("ntt.cu", "image_matching_tpu/ops/ntt.py:231"),
        "ntt_inv_rows": ("ntt.cu", "image_matching_tpu/ops/ntt.py:260"),
        "ntt_inv_cols": ("ntt.cu", "image_matching_tpu/ops/ntt.py:260"),
        "ks_mac_wide": ("keyswitch.cu", f"{ctx_py}:940"),
        "sub_scale_wide": ("rescale.cu", f"{ctx_py}:890"),
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

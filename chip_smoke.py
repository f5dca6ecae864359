#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (image_matching_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port builds and runs on the card.

    python3 chip_smoke.py

Phases (every one asserts; any failure exits non-zero before the result
line is printed):
  1. build the CUDA kernels from csrc/ (nvcc, sm_90a) and print the time;
  2. run each kernel (NTT fwd/inv, ct_dot, fast base conversion, keyswitch
     MAC) on the card at the shapes of the main path and require bit-exact
     equality with its plain torch version on the same inputs; print both
     times (CUDA events);
  3. drive HyDia (approach 5) with an in-memory encrypted DB of 2^16
     vectors at production parameters (ring 32768, dim 512, threshold
     0.44, comparison depth 10): setup, encrypt the query, membership,
     index, decrypt; require membership True, the index set equal to the
     plaintext set cosine >= 0.44 (which holds the planted vector 0), and
     decrypted scores within 1e-4 of the plaintext cosine;
  4. require that every kernel was launched during phase 3.
The last lines are the card's name and power limit, one JSON line of
per-kernel results, and the JSON result line.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

NVEC = 1 << 16
DIM = 512
SEED = 0


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters=5):
    """Mean device time of fn() in ms over `iters` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rand_residues(shape, primes, gen, device):
    """Uniform residues mod primes[i] along axis -2, int32 on device."""
    q = torch.tensor(primes, dtype=torch.int64, device=device)[:, None]
    x = torch.randint(0, 1 << 62, shape, generator=gen, device=device, dtype=torch.int64)
    return (x % q).int()


def check_kernels(ctx, device):
    """Phase 2: each kernel against its plain version, bit-exact."""
    from image_matching_tpu_torch.ckks.context import fbc_plain, ks_mac_plain
    from image_matching_tpu_torch.matching.senders import ct_dot, ct_dot_plain
    from image_matching_tpu_torch.ops.ntt import ntt_fwd_plain, ntt_inv_plain

    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    P = ctx.all_primes
    n, Lq, l = ctx.n, ctx.Lq, ctx.Lq
    rows = {}

    def record(name, label, got, want, fn, plain_fn):
        assert got.dtype == want.dtype == torch.int32 and got.shape == want.shape, label
        err = int((got.long() - want.long()).abs().max())
        ms, pms = cuda_ms(fn), cuda_ms(plain_fn)
        log(f"kernel {name} [{label}]: max_abs_err {err}  kernel {ms:.4f} ms  "
            f"plain {pms:.4f} ms")
        assert err == 0, f"{name} [{label}] differs from its plain version"
        r = rows.setdefault(name, {"max_abs_err": 0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if "ms" not in r:  # the first shape listed is the main path's
            r.update(ms=ms, plain_ms=pms, shape=label)

    plan = ctx.plan
    limbs = tuple(range(ctx.Ltot))
    idx = plan.limb_index(limbs).long()
    x = rand_residues((8, ctx.Ltot, n), P, gen, device)
    record("ntt_fwd", "8x20 limbs", plan.fwd(x, limbs), ntt_fwd_plain(x, plan.psis[idx], plan.q[idx]),
           lambda: plan.fwd(x, limbs), lambda: ntt_fwd_plain(x, plan.psis[idx], plan.q[idx]))
    record("ntt_inv", "8x20 limbs", plan.inv(x, limbs),
           ntt_inv_plain(x, plan.ipsis[idx], plan.q[idx], plan.ninv[idx]),
           lambda: plan.inv(x, limbs),
           lambda: ntt_inv_plain(x, plan.ipsis[idx], plan.q[idx], plan.ninv[idx]))
    del x

    qp = P[:Lq]
    A = rand_residues((32, 2, Lq, n), qp, gen, device)
    B = rand_residues((16, 32, 2, Lq, n), qp, gen, device)
    record("ct_dot", "K=32 x 16 blocks", ct_dot(ctx, A, B), ct_dot_plain(ctx, A, B),
           lambda: ct_dot(ctx, A, B), lambda: ct_dot_plain(ctx, A, B))
    A = rand_residues((512, 2, Lq, n), qp, gen, device)
    B = rand_residues((512, 2, Lq, n), qp, gen, device)
    record("ct_dot", "K=512", ct_dot(ctx, A, B), ct_dot_plain(ctx, A, B),
           lambda: ct_dot(ctx, A, B), lambda: ct_dot_plain(ctx, A, B))
    del A, B

    grp = tuple(ctx.groups[0])                         # 5 limbs
    other = tuple(i for i in ctx.ext_limbs(l) if i not in grp)  # 15 limbs
    c = ctx._fbc_consts(grp, other)
    x = rand_residues((16, len(grp), n), [P[i] for i in grp], gen, device)
    record("fbc", f"{len(grp)}->{len(other)} x16", ctx._fbc(x, grp, other), fbc_plain(x, c),
           lambda: ctx._fbc(x, grp, other), lambda: fbc_plain(x, c))
    sp, lim = ctx.sp_limbs(), ctx.q_limbs(l)
    c = ctx._fbc_consts(sp, lim)
    x = rand_residues((32, len(sp), n), [P[i] for i in sp], gen, device)
    record("fbc", f"{len(sp)}->{len(lim)} x32", ctx._fbc(x, sp, lim), fbc_plain(x, c),
           lambda: ctx._fbc(x, sp, lim), lambda: fbc_plain(x, c))
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
           lambda: ks_mac_plain(digs, keys, l, Lq, qe, rinve, perms))
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one GPU",
              file=sys.stderr)
        sys.exit(2)
    from image_matching_tpu.ckks.params import SchemeParams, compute_required_depth
    from image_matching_tpu.matching import vector_utils as vu
    from image_matching_tpu.matching.config import MatchConfig
    from image_matching_tpu.utils.io import gen_dataset
    from image_matching_tpu_torch.ckks.context import CkksContext
    from image_matching_tpu_torch.matching import enrollers
    from image_matching_tpu_torch.matching.protocol import MatchingProtocol
    from image_matching_tpu_torch.ops import kernels

    device = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {smi}")

    # phase 1: build
    t0 = time.perf_counter()
    kernels.lib()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc {kernels.build_seconds} s; "
        f"library {kernels.build().name})")
    log("\n".join(line for line in kernels.build_log.splitlines()
                  if "registers" in line or "spill" in line))

    # phase 2: kernels against their plain versions at the main path's shapes
    cfg = MatchConfig()
    params = SchemeParams.create(mult_depth=compute_required_depth(5, cfg.comp_depth))
    log(f"params: ring {params.ring_dim}, {params.num_limbs} q limbs, "
        f"{params.num_special} special, dnum {params.dnum}")
    rows = check_kernels(CkksContext(params, seed=SEED + 1, device=device), device)
    torch.cuda.empty_cache()

    # phase 3: the main path, through the user entry points
    query, db = gen_dataset(NVEC, DIM, seed=SEED)
    times = {}
    # time the enrollment inside setup: the protocol looks the enroller up
    # on its module at call time
    enroll = enrollers.enroll_diag

    def timed_enroll(*a, **k):
        t = time.perf_counter()
        out = enroll(*a, **k)
        torch.cuda.synchronize()
        times["enroll_s"] = time.perf_counter() - t
        return out

    enrollers.enroll_diag = timed_enroll
    kernels.reset_counts()
    t = time.perf_counter()
    proto = MatchingProtocol.setup(5, db, cfg, seed=SEED, device=device)
    torch.cuda.synchronize()
    times["setup_s"] = time.perf_counter() - t
    enrollers.enroll_diag = enroll
    t = time.perf_counter()
    qcts = proto.encrypt_query(query)
    torch.cuda.synchronize()
    times["encrypt_query_s"] = time.perf_counter() - t
    t = time.perf_counter()
    mem = proto.membership(qcts)
    torch.cuda.synchronize()
    times["membership_s"] = time.perf_counter() - t
    t = time.perf_counter()
    idx = proto.index(qcts)
    torch.cuda.synchronize()
    times["index_s"] = time.perf_counter() - t
    launches = kernels.counts()
    times["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"main path on {smi}: " + json.dumps(times) + " launches " + json.dumps(launches))

    member = proto.decrypt_membership(mem)
    found = sorted(proto.decrypt_index(idx))
    sims = vu.cosine_similarity(vu.normalize(query)[None, :], vu.normalize(db))
    expect = sorted(int(i) for i in np.nonzero(sims >= cfg.match_threshold)[0])
    log(f"membership {member}; index {found[:10]} ({len(found)}); expected {expect[:10]}")
    assert mem.data.shape == (2, mem.limbs, params.ring_dim)
    assert member is True, "membership must be True (vector 0 is planted)"
    assert found == expect and 0 in found, "index differs from the plaintext match set"
    vals = proto.receiver.decrypt_scores(proto.sender.compute_similarity(qcts))[:NVEC]
    assert np.all(np.isfinite(vals))
    err = float(np.abs(vals - sims).max())
    log(f"score parity: max |decrypted - cosine| = {err:.3e} over {NVEC} vectors")
    assert err <= 1e-4, "score parity above the 1e-4 bar"

    # phase 4: the main path went through every kernel
    missing = [k for k, v in launches.items() if v == 0]
    assert not missing, f"kernels never launched on the main path: {missing}"

    src = "image_matching_tpu_torch/csrc/"
    meta = {
        "ntt_fwd": ("ntt.cu", "image_matching_tpu/ops/ntt.py:231"),
        "ntt_inv": ("ntt.cu", "image_matching_tpu/ops/ntt.py:260"),
        "ct_dot": ("ct_dot.cu", "image_matching_tpu/matching/senders.py:53"),
        "fbc": ("basis_convert.cu", "image_matching_tpu/ckks/context.py:837"),
        "ks_mac": ("keyswitch.cu", "image_matching_tpu/ckks/context.py:940"),
    }
    out = [{"name": k, "route": "cuda", "source": src + meta[k][0],
            "replaces": meta[k][1], "launches": launches[k],
            "max_abs_err": rows[k]["max_abs_err"], "ms": rows[k]["ms"],
            "plain_ms": rows[k]["plain_ms"], "shape": rows[k]["shape"]}
           for k in kernels.KERNELS]
    log(smi)
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

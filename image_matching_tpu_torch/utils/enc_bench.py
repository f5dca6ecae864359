"""The encryption kernels on the card, each pass alone (no K1 around it):
K6's pre and c0 passes (``csrc/seeded_encrypt.cu``) at a streamed group,
K10's pre and MAC passes (``csrc/pk_encrypt.cu``) at the shapes the paths
give them, and K10 fused with its K1 launches as the kernel table times it,
beside another build of both (an earlier design) in turns on the same
inputs; K5 (``csrc/prng.cu``) on K6's draws, the c0 pass's floor; and K4
(``csrc/keyswitch.cu``) alone at every shape of one streamed HyDia
membership (``kernels.shape_hist``, printed by ``utils/slice_profile.py``),
with its launches there and the share of the bound weighted by them.

    python3 -m image_matching_tpu_torch.utils.enc_bench [--baseline DIR]

Shapes at production parameters (N = 2^15; HyDia's 14 q limbs, GROTE's
21): K6 at a streamed group [512, 14, N] (seed and group >= 2^31); K10's
passes at the in-memory enrollment's chunks of 64 ciphertexts (l = 14 and
GROTE's l = 21), a chunk of 128 (the HERS query's 512 ciphertexts) and
one ciphertext (a HyDia query); K10 fused at B = 512 (pre, K1 and MAC in
chunks of 128).  Each is held bit-exact against its plain version and
the baseline, then timed kernel, baseline, baseline, kernel, twice, with
CUDA events (windows of 20 calls behind a sleep on the card, so they hold
device time), with its bound: the larger of its bytes (inputs read once,
outputs written once) over 3.35 TB/s and its 32-bit integer operations (6
per modular product, 2 per add, 116 per Threefry residue, 10 per
butterfly) over 67 T/s, the float32 rate (Hopper issues integer add, xor
and shift at a lower one).  K5 is timed on the c0 pass's draws in the
same call.  ``DIR`` holds the earlier ``seeded_encrypt.cu``,
``pk_encrypt.cu``, ``threefry.cuh`` and ``modmath.cuh``; they are built
alone into one library whose entry points take the earlier design's
arguments (the earlier pre passes: 2^56 mod q and the split offset in
place of R^3 mod q; int64 noise).  ``chip_smoke.py`` calls ``measure``
in its kernel phase.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from ..ckks import context as tc
from ..ops import prng
from .benchkit import (ADD, MUL, THREEFRY_OPS, bound, build_alone, call, in_turns, ntt_ops,
                       rand_rows)

SOURCES = ("seeded_encrypt.cu", "pk_encrypt.cu", "threefry.cuh", "modmath.cuh")
# the earlier design's C entry points
BASELINE_ENTRIES = {"imtpu_seeded_pre": "pppppppppiii", "imtpu_seeded_c0": "pppppppiiiii",
                    "imtpu_pk_pre": "ppppppppiii", "imtpu_pk_mac": "ppppppiii"}
# K4's launches in one streamed HyDia 2^20 membership by shape (R, l, key,
# digits, perms, launches; 307 in all), from slice_profile's shape
# histogram (NVIDIA H100 80GB HBM3): key "shared" (the relinearization
# key) or "per-row" (rotation keys), digits "per-row" or "shared" (hoisted)
K4_SHAPES = (
    (16, 14, "shared", "per-row", False, 64),   # relinearization after the similarity
    (15, 14, "per-row", "per-row", False, 64),  # giant steps
    (16, 11, "shared", "per-row", False, 64),
    (16, 10, "shared", "per-row", False, 32),   # the compare circuit's most frequent
    (16, 9, "shared", "per-row", False, 20),
    (1, 2, "shared", "per-row", False, 14),
    (16, 8, "shared", "per-row", False, 12),
    (16, 5, "shared", "per-row", False, 12),
    (16, 4, "shared", "per-row", False, 8),
    (16, 12, "shared", "per-row", False, 4),
    (16, 7, "shared", "per-row", False, 4),
    (16, 6, "shared", "per-row", False, 4),
    (16, 3, "shared", "per-row", False, 4),
    (31, 14, "per-row", "shared", True, 1),     # hoisted baby steps
)


def build_baseline(src_dir: Path):
    """The earlier K6 and K10 built alone into one library, their headers
    from ``src_dir``."""
    return build_alone(src_dir, SOURCES, "enc", BASELINE_ENTRIES)


def _noise(ctx, gen, B):
    """(v, e0, e1) int32 [B, N]: ternary v and rounded gaussians."""
    shape = (B, ctx.n)
    v = torch.randint(-1, 2, shape, generator=gen, device=ctx.device).int()
    e = [torch.round(torch.randn(shape, generator=gen, device=ctx.device) * 3.19).int()
         for _ in range(2)]
    return v, e[0], e[1]


def seeded_cases(ctx, lib, gen, B=512):
    """K6's two passes and K5 on one streamed group [B, Lq, N]."""
    n, l = ctx.n, ctx.Lq
    seed, grp = 2 ** 31 + 5, 2 ** 32 - 3
    hi, lo = (torch.from_numpy(a.view(np.int32)).to(ctx.device) for a in ctx.split_coeffs(
        np.random.default_rng(5).integers(-(2 ** 40), 2 ** 40, size=(B, n))))
    e = _noise(ctx, gen, B)[1]
    out = torch.empty((B, l, n), dtype=torch.int32, device=ctx.device) if lib else None

    def old_pre():
        return call(lib, "imtpu_seeded_pre", out, hi.data_ptr(), lo.data_ptr(), e.data_ptr(),
                    ctx.q32.data_ptr(), ctx.qneg32.data_ptr(), ctx.r2_32.data_ptr(),
                    ctx.c24_32.data_ptr(), ctx.offm_32.data_ptr(), B, l, n)
    x = ctx.plan.fwd(tc.seeded_pre_plain(ctx, hi, lo, e, l), ctx.q_limbs(l))
    # the c0 pass writes over its input: each side checks its first call on
    # a fresh copy of x and repeats the same work on it
    xs, xo = x.clone(), x.clone() if lib else None

    def old_c0():
        return call(lib, "imtpu_seeded_c0", xo, xo.data_ptr(), ctx.s_eval.data_ptr(),
                    ctx.q32.data_ptr(), ctx.qneg32.data_ptr(), ctx.r1_32.data_ptr(),
                    ctx.r2_32.data_ptr(), seed, grp, B, l, n)
    res = B * l * n
    return [
        (f"K6 pre [{B},{l},N]", lambda: ctx._seeded_pre(hi, lo, e, l), old_pre if lib else None,
         lambda: tc.seeded_pre_plain(ctx, hi, lo, e, l), (3 * B * n + res) * 4,
         res * (2 * MUL + 3 * ADD)),
        (f"K6 c0 [{B},{l},N]", lambda: ctx._seeded_c0(xs, seed, grp), old_c0 if lib else None,
         lambda: tc.seeded_c0_plain(ctx, x, seed, grp), (2 * res + l * n) * 4,
         res * (THREEFRY_OPS + MUL + ADD)),
        (f"K5 expand_c1 [{B},{l},N] (K6's draws)", lambda: ctx.expand_c1(seed, grp, B, l), None,
         lambda: prng.uniform_residues_plain(seed, grp, (B, l, n), ctx.q32, ctx.r1_32),
         res * 4, res * THREEFRY_OPS),
    ]


def pk_cases(ctx, lib, gen, B, tag=""):
    """K10's two passes alone on a chunk of B ciphertexts at ctx's Lq."""
    n, l = ctx.n, ctx.Lq
    m = rand_rows(ctx, gen, (B,), range(l))
    v, e0, e1 = _noise(ctx, gen, B)
    v64, e064, e164 = (t.long() for t in (v, e0, e1)) if lib else (None,) * 3
    pre_out = torch.empty((3, B, l, n), dtype=torch.int32, device=ctx.device) if lib else None

    def old_pre():
        return call(lib, "imtpu_pk_pre", pre_out, m.data_ptr(), v64.data_ptr(),
                    e064.data_ptr(), e164.data_ptr(), ctx.q32.data_ptr(), ctx.qneg32.data_ptr(),
                    ctx.r2_32.data_ptr(), B, l, n)
    x = ctx.plan.fwd(tc.pk_pre_plain(ctx, m, v, e0, e1, l), ctx.q_limbs(l))
    mac_out = torch.empty((B, 2, l, n), dtype=torch.int32, device=ctx.device) if lib else None

    def old_mac():
        return call(lib, "imtpu_pk_mac", mac_out, x.data_ptr(), ctx.pk_b.data_ptr(),
                    ctx.pk_a.data_ptr(), ctx.q32.data_ptr(), ctx.qneg32.data_ptr(), B, l, n)
    res = B * l * n
    return [
        (f"K10 pre B={B} x {l} limbs{tag}", lambda: ctx._pk_pre(m, v, e0, e1, l),
         old_pre if lib else None, lambda: tc.pk_pre_plain(ctx, m, v, e0, e1, l),
         (4 * res + 3 * B * n) * 4, res * (2 * MUL + 4 * ADD)),
        (f"K10 MAC B={B} x {l} limbs{tag}", lambda: ctx._pk_mac(x, l), old_mac if lib else None,
         lambda: tc.pk_mac_plain(ctx, x, l), (5 * res + 2 * l * n) * 4, res * 2 * (MUL + ADD)),
    ]


def fused_case(ctx, lib, gen, B=512):
    """K10 with its K1 launches, as ``_encrypt_impl`` runs it, at B."""
    n, l = ctx.n, ctx.Lq
    m = rand_rows(ctx, gen, (B,), range(l))
    v, e0, e1 = _noise(ctx, gen, B)
    v64, e064, e164 = v.long(), e0.long(), e1.long()
    lim = ctx.q_limbs(l)

    def old():
        out = torch.empty((B, 2, l, n), dtype=torch.int32, device=ctx.device)
        for i in range(0, B, ctx._PK_CHUNK):
            b = min(ctx._PK_CHUNK, B - i)
            x = torch.empty((3, b, l, n), dtype=torch.int32, device=ctx.device)
            call(lib, "imtpu_pk_pre", x, m[i].data_ptr(), v64[i].data_ptr(),
                 e064[i].data_ptr(), e164[i].data_ptr(), ctx.q32.data_ptr(),
                 ctx.qneg32.data_ptr(), ctx.r2_32.data_ptr(), b, l, n)
            x = ctx.plan.fwd(x, lim)
            call(lib, "imtpu_pk_mac", out[i], x.data_ptr(), ctx.pk_b.data_ptr(),
                 ctx.pk_a.data_ptr(), ctx.q32.data_ptr(), ctx.qneg32.data_ptr(), b, l, n)
        return out
    res = B * l * n
    return (f"K10 fused (pre, K1, MAC) B={B} x {l} limbs",
            lambda: ctx._encrypt_impl(m, v, e0, e1, l), old if lib else None,
            lambda: tc.pk_encrypt_plain(ctx, m, v, e0, e1, l),
            (res + 3 * B * n + 2 * l * n + 2 * res) * 4,
            res * (4 * MUL + 6 * ADD) + ntt_ops(3 * B * l, n))


def k4_cases(ctx, gen):
    """K4 alone at K4_SHAPES (random digits and keys of the path's
    layout; the time does not depend on their values)."""
    n, out = ctx.n, []
    for R, l, key, digits, perms, launches in K4_SHAPES:
        label = (f"K4 R={R} x {l} limbs, {key} key" + (", shared digits" if digits == "shared"
                                                        else "") + (", perms" if perms else ""))
        ext = ctx.ext_limbs(l)
        E, ndig = len(ext), len([g for g in ctx.groups if g[0] < l])
        digs = rand_rows(ctx, gen, (() if digits == "shared" else (R,)) + (ndig,), ext)
        keys = (ctx.relin_key if key == "shared"
                else rand_rows(ctx, gen, (R, ctx.dnum, 2), range(ctx.Ltot)))
        p = (torch.from_numpy(np.stack([ctx.plan.auto_perm(ctx.rotation_galois(r))
                                        for r in range(1, R + 1)])).to(ctx.device)
             if perms else None)
        q, rinv = ctx._qrow(ext)
        nbytes = (digs.numel() + (1 if key == "shared" else R) * ndig * 2 * E * n
                  + (R * n if perms else 0) + R * 2 * E * n) * 4
        out.append((label, lambda d=digs, k=keys, l=l, p=p: ctx._ks_mac(d, k, l, p), None,
                    lambda d=digs, k=keys, l=l, p=p, q=q, r=rinv:
                    tc.ks_mac_plain(d, k, l, ctx.Lq, q, r, p),
                    nbytes, R * 2 * E * n * ndig * (MUL + ADD), launches))
    return out


def measure(ctx, wide_ctx=None, baseline=None) -> List[Dict]:
    """K6's and K10's passes alone and K10 fused at the main paths'
    shapes, bit-checked, timed in turns with the baseline when given; K4
    at its membership shapes.  ``wide_ctx``: GROTE's context, for K10 at
    its 21 limbs.  Returns one dict per shape."""
    gen = torch.Generator(device=ctx.device).manual_seed(99)
    out = []

    def run(rows):
        for label, new, old, want, nbytes, ops, *launches in rows:
            w = want()
            err = int((new().long() - w.long()).abs().max())
            base_err = None if old is None else int((old().long() - w.long()).abs().max())
            del w
            if err or base_err:
                raise AssertionError(f"enc_bench {label}: max_abs_err {err}, baseline {base_err}")
            torch.cuda.synchronize()
            ms, base_ms = in_turns(new, old)
            bms, by = bound(nbytes, ops)
            out.append({"what": label, "ms": ms, "baseline_ms": base_ms, "bound_ms": bms,
                        "bound_by": by, "share_of_bound": bms / ms,
                        "baseline_share": None if base_ms is None else bms / base_ms,
                        "max_abs_err": err, "baseline_max_abs_err": base_err,
                        **({"launches_a_membership": launches[0]} if launches else {})})
            torch.cuda.empty_cache()

    run(seeded_cases(ctx, baseline, gen))
    # the c0 pass over K5's time on the same draws, both timed just above
    c0, k5 = (r for r in out if r["what"].startswith(("K6 c0", "K5")))
    out.append({"what": "K6 c0 / K5 (same call)", "ratio": c0["ms"] / k5["ms"]})
    for B in (64, 128, 1):
        run(pk_cases(ctx, baseline, gen, B))
    if wide_ctx is not None:
        run(pk_cases(wide_ctx, baseline, gen, 64, " (GROTE)"))
    run([fused_case(ctx, baseline, gen)])
    rows = k4_cases(ctx, gen)
    run(rows)
    k4r = out[-len(rows):]
    t = sum(r["ms"] * r["launches_a_membership"] for r in k4r)
    b = sum(r["bound_ms"] * r["launches_a_membership"] for r in k4r)
    out.append({"what": "K4 at these shapes, weighted by launches a membership",
                "ms": t, "bound_ms": b, "share_of_bound": b / t,
                "launches": sum(r["launches_a_membership"] for r in k4r)})
    return out


def contexts():
    """HyDia's (and HERS's) context and GROTE's, at production parameters."""
    from ..ckks.context import CkksContext
    from ..ckks.params import SchemeParams, compute_required_depth
    from ..matching.config import MatchConfig

    cfg = MatchConfig()
    return tuple(CkksContext(SchemeParams.create(mult_depth=compute_required_depth(
        a, cfg.comp_depth, cfg.alpha_depth)), seed=1, device="cuda") for a in (5, 2))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, default=None,
                    help="a directory with another seeded_encrypt.cu, pk_encrypt.cu, "
                         "threefry.cuh and modmath.cuh to build alone and time beside K6 and K10")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("enc_bench: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    ctx, wide = contexts()
    base = build_baseline(args.baseline) if args.baseline else None
    print(smi, flush=True)
    for r in measure(ctx, wide, base):
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()

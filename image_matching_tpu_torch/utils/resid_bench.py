"""The residue kernels on the card, alone (no K1 around them): K7's lift
and sub-scale passes (``csrc/rescale.cu``) and K11's elementwise and
row-sum passes (``csrc/modarith.cu``) at the shapes one streamed HyDia
membership gives them (``kernels.shape_hist``, printed by
``utils/slice_profile.py``), beside another build of both (an earlier
design) in turns on the same inputs.

    python3 -m image_matching_tpu_torch.utils.resid_bench [--baseline DIR]

Shapes at production parameters (N = 2^15, 14 q limbs, 6 special): the
lift of the compare stack's 16 x 2 top rows into 13 (the earlier table's
shape), 9 (its most frequent level) and 2 limbs, and of one ciphertext
into 13; the sub-scale of the giant steps' mod-down (R = 15, c0 gathered),
of a relinearization (R = 16, both components added), of the compare
stack's rescale (16 x 2 rows, 9 limbs, x read in place from 10) and of one
ciphertext's (2 rows, 13 of 14); K11's add of [2, 14, N] (the most
frequent and the earlier table's shape), add_scalar (head 1) and
mul_scalar of a [16, 2, 11, N] stack and the add of two [16, 2, 10, N]
stacks; the row sum of the giant steps (R = 15 x [2, 14, N]), of the
flags (R = 64 x [2, 2, N]) and of R = 128 x [2, 13, N].  Each shape is held
bit-exact against its plain version and the baseline, then timed kernel,
baseline, baseline, kernel, twice, with CUDA events (windows of 20 calls
behind a sleep on the card, so they hold device time), with its byte
bound: inputs read once and outputs written once over 3.35 TB/s.  Beside K11's add, one
``torch.add`` of two int32 tensors of its shape: the rate a pass of two
reads and one write reaches on this card (a yardstick, not the same
function).  ``DIR`` holds the earlier ``rescale.cu``, ``modarith.cu`` and
``modmath.cuh``; they are built alone into one library whose entry points
take the earlier design's arguments.  ``chip_smoke.py`` calls ``measure``
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
from ..ops import kernels
from ..ops import modmath as mm
from .benchkit import bound as bound_ms
from .benchkit import build_alone, call, event_ms, in_turns, rand_rows

SOURCES = ("rescale.cu", "modarith.cu", "modmath.cuh")
# the earlier design's C entry points (imtpu_mod_sum took no Montgomery
# constants: it reduced with a 64-bit remainder)
BASELINE_ENTRIES = {"imtpu_rescale_lift": "ppiipppiii", "imtpu_sub_scale": "ppipppppiiipiiii",
                    "imtpu_modarith": "ppipiiiiiiiipp", "imtpu_mod_sum": "ppiiiiip"}


def build_baseline(src_dir: Path):
    """The earlier K7 and K11 built alone into one library, their header
    from ``src_dir``."""
    return build_alone(src_dir, SOURCES, "resid", BASELINE_ENTRIES)


def _lift_case(ctx, lib, gen, label, B, l):
    top = rand_rows(ctx, gen, (B,), (l - 1,))
    n = ctx.n
    out = torch.empty((B, l - 1, n), dtype=torch.int32, device=ctx.device)

    def old():
        return call(lib, "imtpu_rescale_lift", out, top.data_ptr(), int(ctx.all_primes[l - 1]),
                    int(ctx.qneg_np[l - 1]), ctx.q32.data_ptr(), ctx.qneg32.data_ptr(),
                    ctx.r2_32.data_ptr(), B, l - 1, n)
    return (label, lambda: ctx._rescale_lift(top, l), old if lib else None,
            tc.rescale_lift_plain(ctx, top, l), B * l * n * 4)


def _sub_case(ctx, lib, gen, label, x, t, cinv, add=None, perms=None):
    """``ctx._sub_scale(x, t, cinv[1], add, perms)`` with x, add and perms
    contiguous (the baseline is given the same strides)."""
    n, l = ctx.n, t.shape[-2]
    B = t.numel() // (l * n)
    out = torch.empty(t.shape, dtype=torch.int32, device=ctx.device)
    add_k = add_r = add_c = perm_r = 0
    if add is not None:
        add_k, add_c = add.shape[1], add.stride(1)
        add_r = add.stride(0) if add.shape[0] > 1 else 0
        perm_r = n if perms is not None and perms.shape[0] > 1 else 0

    def old():
        return call(lib, "imtpu_sub_scale", out, x.data_ptr(), x.shape[-2] * n, t.data_ptr(),
                    cinv[1].data_ptr(), ctx.q32.data_ptr(), ctx.qneg32.data_ptr(),
                    kernels.ptr(add), add_r, add_c, add_k, kernels.ptr(perms), perm_r, B, l, n)
    nbytes = (3 * B * l * n + (0 if add is None else (B // 2) * add_k * l * n)
              + (0 if perms is None else perms.numel())) * 4
    return (label, lambda: ctx._sub_scale(x, t, cinv[1], add, perms), old if lib else None,
            tc.sub_scale_plain(ctx, x, t, cinv[0], add, perms), nbytes)


def _arith_case(ctx, lib, gen, label, op, a, b, head=None):
    m = ctx._mod(a.shape[-2])
    src, a_bs, bt, b_bs, b_mode, kcomp, headk, B, l, n = mm.modarith_args(op, a, b, head)
    out = torch.empty(a.shape, dtype=torch.int32, device=ctx.device)

    def old():
        return call(lib, "imtpu_modarith", out, src.data_ptr(), a_bs, kernels.ptr(bt), b_bs,
                    b_mode, mm.OPS[op], kcomp, headk, B, l, n, m.q32.data_ptr(),
                    m.qneg32.data_ptr())
    b_bytes = 0 if bt is None else bt.numel()
    return (label, lambda: mm.residue_op(op, a, b, m, head), old if lib else None,
            mm.residue_op_plain(op, a, b, m.q, m.rinv, head), (2 * a.numel() + b_bytes) * 4)


def _sum_case(ctx, lib, gen, label, R, B, l):
    rows = rand_rows(ctx, gen, (R, B), range(l))
    m = ctx._mod(l)
    n = ctx.n
    out = torch.empty(rows.shape[1:], dtype=torch.int32, device=ctx.device)

    def old():
        return call(lib, "imtpu_mod_sum", out, rows.data_ptr(), rows.stride(0), R, B, l, n,
                    m.q32.data_ptr())
    return (label, lambda: mm.row_sum(rows, m), old if lib else None,
            mm.row_sum_plain(rows, m.q), (R + 1) * B * l * n * 4)


def cases(ctx, lib, gen):
    """(label, kernel call, baseline call or None, plain result, bytes)
    of every measured shape."""
    Lq = ctx.Lq

    def rows(shape, limbs):
        return rand_rows(ctx, gen, shape, limbs)

    out = [_lift_case(ctx, lib, gen, "K7 lift 16x2x1 -> 13 limbs", 32, Lq),
           _lift_case(ctx, lib, gen, "K7 lift 16x2x1 -> 9 limbs (most frequent)", 32, 10),
           _lift_case(ctx, lib, gen, "K7 lift 2x1 -> 13 limbs (one ciphertext)", 2, Lq),
           _lift_case(ctx, lib, gen, "K7 lift 16x2x1 -> 2 limbs (low level)", 32, 3)]
    perms = torch.from_numpy(np.stack([ctx.plan.auto_perm(ctx.rotation_galois(32 * r))
                                       for r in range(1, 16)])).to(ctx.device)
    ext = ctx.ext_limbs(Lq)
    pinv = ctx._pinv(Lq)
    out.append(_sub_case(ctx, lib, gen, "K7 sub-scale R=15x2x14 (giant steps, c0 gathered)",
                         rows((15, 2), ext), rows((15, 2), range(Lq)),
                         pinv, rows((15, 1), range(Lq)), perms))
    out.append(_sub_case(ctx, lib, gen, "K7 sub-scale R=16x2x14 (relinearization)",
                         rows((16, 2), ext), rows((16, 2), range(Lq)),
                         pinv, rows((16, 2), range(Lq))))
    out.append(_sub_case(ctx, lib, gen, "K7 sub-scale 16x2x9 of 10 (rescale of the stack)",
                         rows((16, 2), range(10)), rows((16, 2), range(9)),
                         ctx._qtinv(10)))
    out.append(_sub_case(ctx, lib, gen, "K7 sub-scale 2x13 of 14 (rescale of one ciphertext)",
                         rows((2,), range(Lq)), rows((2,), range(Lq - 1)),
                         ctx._qtinv(Lq)))
    a2, b2 = rows((2,), range(Lq)), rows((2,), range(Lq))
    a11 = rows((16, 2), range(11))
    c11 = ctx._mont_const(987654321, ctx.q_limbs(11))
    a10, b10 = rand_rows(ctx, gen, (16, 2), range(10)), rand_rows(ctx, gen, (16, 2), range(10))
    out += [_arith_case(ctx, lib, gen, "K11 add [2,14,N]", "add", a2, b2),
            _arith_case(ctx, lib, gen, "K11 add_scalar [16,2,11,N] head 1", "add", a11, c11, 1),
            _arith_case(ctx, lib, gen, "K11 mul_scalar [16,2,11,N] by [11]", "mul", a11, c11),
            _arith_case(ctx, lib, gen, "K11 add [16,2,10,N]", "add", a10, b10),
            _sum_case(ctx, lib, gen, "K11 row sum R=15 x [2,14,N] (giant steps)", 15, 2, Lq),
            _sum_case(ctx, lib, gen, "K11 row sum R=64 x [2,2,N] (flags)", 64, 2, 2),
            _sum_case(ctx, lib, gen, "K11 row sum R=128 x [2,13,N]", 128, 2, Lq - 1)]
    return out, (a2, b2)


def measure(ctx, baseline=None) -> List[Dict]:
    """K7's and K11's passes alone at the main path's shapes, bit-checked,
    timed in turns with the baseline when given, and the torch.add
    yardstick.  Returns one dict per shape."""
    gen = torch.Generator(device=ctx.device).manual_seed(99)
    rows, (a2, b2) = cases(ctx, baseline, gen)
    out = []
    for label, new, old, want, nbytes in rows:
        err = int((new().long() - want.long()).abs().max())
        base_err = None if old is None else int((old().long() - want.long()).abs().max())
        if err or base_err:
            raise AssertionError(f"resid_bench {label}: max_abs_err {err}, baseline {base_err}")
        torch.cuda.synchronize()
        ms, base_ms = in_turns(new, old)
        bound = bound_ms(nbytes, 0)[0]
        out.append({"what": label, "ms": ms, "baseline_ms": base_ms, "bound_ms": bound,
                    "bound_by": "bytes", "share_of_bound": bound / ms,
                    "baseline_share": None if base_ms is None else bound / base_ms,
                    "max_abs_err": err, "baseline_max_abs_err": base_err})
    # yardstick: torch.add of two int32 tensors of the [2, 14, N] add's shape
    ms = (event_ms(lambda: torch.add(a2, b2), 20) + event_ms(lambda: torch.add(a2, b2), 20)) / 2
    bound = bound_ms(3 * a2.numel() * 4, 0)[0]
    out.append({"what": "torch.add int32 [2,14,N] (yardstick)", "ms": ms, "baseline_ms": None,
                "bound_ms": bound, "bound_by": "bytes", "share_of_bound": bound / ms,
                "baseline_share": None, "max_abs_err": None, "baseline_max_abs_err": None})
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, default=None,
                    help="a directory with another rescale.cu, modarith.cu and modmath.cuh to "
                         "build alone and time beside K7 and K11")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("resid_bench: needs a CUDA device")
    from ..ckks.context import CkksContext
    from ..ckks.params import SchemeParams, compute_required_depth
    from ..matching.config import MatchConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    ctx = CkksContext(SchemeParams.create(
        mult_depth=compute_required_depth(5, MatchConfig().comp_depth)), seed=1, device="cuda")
    base = build_baseline(args.baseline) if args.baseline else None
    print(smi, flush=True)
    for r in measure(ctx, base):
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()

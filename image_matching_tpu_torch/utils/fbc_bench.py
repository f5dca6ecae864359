"""The base-conversion kernels on the card, alone (no K1 around them): K3
(``csrc/basis_convert.cu``) and K8 (``csrc/decompose.cu``) at the shapes
the streamed HyDia membership gives them, beside another build of both
(an earlier design) in turns on the same inputs.

    python3 -m image_matching_tpu_torch.utils.fbc_bench [--baseline DIR]

Shapes at production parameters (N = 2^15, 14 q limbs, 6 special, digits
of 5, 5 and 4 limbs): K3 as the mod-down's centred conversion 6 -> 14 of
32 rows (a batched keyswitch of 16 ciphertexts) and of 2 rows (one
relinearization), and a digit's 5 -> 15 of 16 rows; K8 alone over R = 16
(the relinearization of a stack), R = 15 (the giant steps) and R = 1
ciphertexts at l = 14.  Each shape is held bit-exact against its plain
version (``fbc_plain``, ``decompose_coeff_plain``) and the baseline, then
timed kernel, baseline, baseline, kernel with CUDA events (windows of 20
calls behind a sleep on the card, so they hold device time), with its
byte bound: inputs read once and outputs written once over 3.35 TB/s.
``DIR`` holds the earlier ``basis_convert.cu``, ``decompose.cu``,
``fbc.cuh`` and ``modmath.cuh``; they are built alone into one library
whose ``imtpu_fbc`` / ``imtpu_decompose`` take the packed constants of
that design (qs, qnegs, t_std, inv_q, qd, qnegd, qg_r2, qhat).
``chip_smoke.py`` calls ``measure`` in its kernel phase.
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
from .benchkit import build_alone, call, event_ms, rand_rows

SOURCES = ("basis_convert.cu", "decompose.cu")


def build_baseline(src_dir: Path):
    """The earlier K3 and K8 built alone into one library, their includes
    from ``src_dir`` first."""
    return build_alone(src_dir, SOURCES, "fbc",
                       {name: kernels._ENTRIES[name] for name in ("imtpu_fbc", "imtpu_decompose")})


def _old_packed(ctx, src, dst) -> np.ndarray:
    """The earlier design's packed constants of one conversion."""
    c = ctx._fbc_consts(tuple(src), tuple(dst))
    host = {k: mm.to_numpy(getattr(c, k).int()) for k in ("t_std", "qhat", "qg_r2")}
    return np.concatenate([
        ctx.q_np[list(src)], ctx.qneg_np[list(src)], host["t_std"][:, 0],
        c.inv_q.cpu().numpy().view(np.uint32), ctx.q_np[list(dst)], ctx.qneg_np[list(dst)],
        host["qg_r2"][:, 0], host["qhat"].ravel()])


def _fbc_case(ctx, lib, gen, label, src, dst, B, centred):
    shift = ctx._centre_shift(len(dst)) if centred else None
    pre, post = shift if centred else ((None, None), (None, None))
    x = rand_rows(ctx, gen, (B,), src)
    g, t, n = len(src), len(dst), ctx.n
    want = tc.fbc_plain(x, ctx._fbc_consts(src, dst), pre[0], post[0])

    def new():
        return ctx._fbc(x, src, dst, shift)

    old = None
    if lib is not None:
        packed = mm.to_tensor(_old_packed(ctx, src, dst), ctx.device)
        out = torch.empty((B, t, n), dtype=torch.int32, device=ctx.device)

        def old():
            return call(lib, "imtpu_fbc", out, x.data_ptr(), packed.data_ptr(),
                        kernels.ptr(pre[1]), kernels.ptr(post[1]), B, g, t, n)
    return label, new, old, want, B * (g + t) * n * 4


def _decompose_case(ctx, lib, gen, label, R, l):
    coeff = rand_rows(ctx, gen, (R,), range(l))
    E, n = l + ctx.S, ctx.n
    digits = ctx._digits(l)
    want = tc.decompose_coeff_plain(ctx, coeff, l)

    def new():
        return ctx._decompose_coeff(coeff, l)

    old = None
    if lib is not None:
        blocks, info, off = [], [], 0
        for g, other in digits:
            blocks.append(_old_packed(ctx, g, other))
            info += [g[0], len(g), off]
            off += blocks[-1].size
        consts = mm.to_tensor(np.concatenate(blocks), ctx.device)
        dinfo = torch.tensor(info, dtype=torch.int32, device=ctx.device)
        out = torch.empty((R, len(digits), E, n), dtype=torch.int32, device=ctx.device)

        def old():
            return call(lib, "imtpu_decompose", out, coeff.data_ptr(), l * n,
                        consts.data_ptr(), dinfo.data_ptr(), R, len(digits), E, n)
    return label, new, old, want, R * (l + len(digits) * E) * n * 4


def measure(ctx, baseline=None) -> List[Dict]:
    """K3 and K8 alone at the main path's shapes, bit-checked, timed in
    turns with the baseline when given.  Returns one dict per shape."""
    gen = torch.Generator(device=ctx.device).manual_seed(88)
    l, sp = ctx.Lq, ctx.sp_limbs()
    grp = tuple(ctx.groups[0])
    other = tuple(i for i in ctx.ext_limbs(l) if i not in grp)
    cases = [
        _fbc_case(ctx, baseline, gen, f"K3 {len(sp)}->{l} x32 centred (mod-down, R=16)",
                  sp, ctx.q_limbs(l), 32, True),
        _fbc_case(ctx, baseline, gen, f"K3 {len(sp)}->{l} x2 centred (mod-down, R=1)",
                  sp, ctx.q_limbs(l), 2, True),
        _fbc_case(ctx, baseline, gen, f"K3 {len(grp)}->{len(other)} x16 (digit)",
                  grp, other, 16, False),
        _decompose_case(ctx, baseline, gen, f"K8 alone R=16 x {l} limbs (relinearization)", 16, l),
        _decompose_case(ctx, baseline, gen, f"K8 alone R=15 x {l} limbs (giant steps)", 15, l),
        _decompose_case(ctx, baseline, gen, f"K8 alone R=1 x {l} limbs", 1, l),
    ]
    out = []
    for label, new, old, want, nbytes in cases:
        err = int((new().long() - want.long()).abs().max())
        base_err = None if old is None else int((old().long() - want.long()).abs().max())
        if err or base_err:
            raise AssertionError(f"fbc_bench {label}: max_abs_err {err}, baseline {base_err}")
        torch.cuda.synchronize()
        if old is None:
            ms, base_ms = (event_ms(new, 20) + event_ms(new, 20)) / 2, None
        else:
            ks = [event_ms(new, 20), event_ms(old, 20), event_ms(old, 20), event_ms(new, 20)]
            ms, base_ms = (ks[0] + ks[3]) / 2, (ks[1] + ks[2]) / 2
        bound = bound_ms(nbytes, 0)[0]
        out.append({"what": label, "ms": ms, "baseline_ms": base_ms, "bound_ms": bound,
                    "bound_by": "bytes", "share_of_bound": bound / ms,
                    "baseline_share": None if base_ms is None else bound / base_ms,
                    "max_abs_err": err, "baseline_max_abs_err": base_err})
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, default=None,
                    help="a directory with another basis_convert.cu, decompose.cu, fbc.cuh "
                         "and modmath.cuh to build alone and time beside K3 and K8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("fbc_bench: needs a CUDA device")
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

"""K9's decryption MAC pass (``csrc/tensor.cu``) alone, without K1's
inverse after it, at the shapes the receivers give it, beside another
build of it (an earlier design) in turns.

    python3 -m image_matching_tpu_torch.utils.dec_bench [--baseline DIR]

Shapes at production parameters (N = 2^15, HyDia's chain of 14 q limbs):
[1, 2, 2, N] (the membership result), [64, 2, 2, N] from 64 separate
ciphertexts and as the streamed 2^20 index holds its flags (views of 4
stacks of 16, as the compare circuit returns them), [1, 3, 14, N] (the kernel
table's row) and [64, 2, SCORES_L, N] from 64 separate ciphertexts (the
streamed 2^20 similarity scores that ``decrypt_scores`` takes).  This
tree's pass runs through ``ctx._decrypt_mac`` on the list; the earlier
design (``DIR``: its ``tensor.cu`` and ``modmath.cuh``, built alone) takes
one tensor with a batch stride, so it runs on a stacked copy made once,
outside the window.  Each is held bit-exact against ``decrypt_mac_plain``,
then timed kernel, baseline, baseline, kernel, twice: windows of 20 calls
behind a sleep on the card (device time), then on the host clock (what a
call costs the caller's thread: this tree's wrapper with its checks and
address list, the earlier entry point called directly).  Bound: the larger of the bytes
(every component and the key's l rows read once, the output written once)
over 3.35 TB/s and the 32-bit operations over 67 T/s.  ``chip_smoke.py``
calls ``measure`` where ``build/dec_prev/`` holds the earlier sources.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

import torch

from ..ckks import context as tc
from .benchkit import ADD, MUL, bound, build_alone, call, host_ms, in_turns, rand_rows

SOURCES = ("tensor.cu", "modmath.cuh")
BASELINE_ENTRIES = {"imtpu_decrypt_mac": "ppiiipppiii"}  # the earlier design's entry point
SCORES_L = 12  # a streamed HyDia 2^20 similarity score's limbs (slice_profile)
# (label, ciphertexts, components, limbs, ciphertexts an allocation: the
# compare circuit returns its flags as views of stacks of 16)
SHAPES = (("membership [1,2,2,N]", 1, 2, 2, 1),
          ("index flags [64,2,2,N], 64 ciphertexts", 64, 2, 2, 1),
          ("index flags [64,2,2,N], views of 4 stacks of 16 (the path's)", 64, 2, 2, 16),
          ("table row [1,3,14,N]", 1, 3, 14, 1),
          (f"scores [64,2,{SCORES_L},N], 64 ciphertexts", 64, 2, SCORES_L, 1))


def build_baseline(src_dir: Path):
    """The earlier K9 built alone, its header from ``src_dir``."""
    return build_alone(src_dir, SOURCES, "dec", BASELINE_ENTRIES)


def mac_work(B, k, l, n):
    """(bytes, operations) of the MAC pass over B ciphertexts of k
    components and l limbs."""
    res = B * l * n
    return ((B * k + 1) * l * n + res) * 4, res * ((k - 1) * (MUL + ADD) + (k > 2) * MUL + MUL)


def cases(ctx, lib, gen):
    """(label, kernel, baseline, plain, bytes, operations) at SHAPES."""
    n, out = ctx.n, []
    for label, B, k, l, per in SHAPES:
        blocks = [b for _ in range(B // per) for b in rand_rows(ctx, gen, (per, k), range(l))]
        old = None
        if lib is not None:
            stack = torch.stack(blocks)
            res = torch.empty((B, l, n), dtype=torch.int32, device=ctx.device)

            def old(stack=stack, res=res, B=B, k=k, l=l):
                return call(lib, "imtpu_decrypt_mac", res, stack.data_ptr(), stack.stride(0),
                            stack.stride(1), k, ctx.s_eval.data_ptr(), ctx.q32.data_ptr(),
                            ctx.qneg32.data_ptr(), B, l, n)
        out.append((label, lambda b=blocks: ctx._decrypt_mac(b), old,
                    lambda b=blocks: tc.decrypt_mac_plain(ctx, torch.stack(b)),
                    *mac_work(B, k, l, n)))
    return out


def measure(ctx, baseline=None) -> List[Dict]:
    """The MAC pass at SHAPES, bit-checked, timed in turns with the
    baseline when given.  Returns one dict per shape."""
    gen = torch.Generator(device=ctx.device).manual_seed(77)
    out = []
    for label, new, old, want, nbytes, ops in cases(ctx, baseline, gen):
        w = want()
        err = int((new().long() - w.long()).abs().max())
        base_err = None if old is None else int((old().long() - w.long()).abs().max())
        del w
        if err or base_err:
            raise AssertionError(f"dec_bench {label}: max_abs_err {err}, baseline {base_err}")
        ms, base_ms = in_turns(new, old)
        host, base_host = in_turns(new, old, host_ms)
        bms, by = bound(nbytes, ops)
        out.append({"what": f"K9 decrypt MAC {label}", "ms": ms, "baseline_ms": base_ms,
                    "bound_ms": bms, "bound_by": by, "share_of_bound": bms / ms,
                    "baseline_share": None if base_ms is None else bms / base_ms,
                    "host_ms_a_call": host, "baseline_host_ms_a_call": base_host,
                    "max_abs_err": err, "baseline_max_abs_err": base_err})
    torch.cuda.empty_cache()
    return out


def context():
    """HyDia's context at production parameters."""
    from ..ckks.params import SchemeParams, compute_required_depth
    from ..matching.config import MatchConfig

    cfg = MatchConfig()
    return tc.CkksContext(SchemeParams.create(mult_depth=compute_required_depth(
        5, cfg.comp_depth, cfg.alpha_depth)), seed=1, device="cuda")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, default=None,
                    help="a directory with another tensor.cu and modmath.cuh to build alone "
                         "and time beside K9's decrypt MAC")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dec_bench: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    ctx = context()
    base = build_baseline(args.baseline) if args.baseline else None
    print(smi, flush=True)
    for r in measure(ctx, base):
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()

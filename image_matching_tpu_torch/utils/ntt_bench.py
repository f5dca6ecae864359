"""K1 (the NTT, ``csrc/ntt.cu``) on the card at the row counts the main
path gives it, against its plain version and, when given, another build of
``ntt.cu`` (an earlier design) in turns on the same inputs.

    python3 -m image_matching_tpu_torch.utils.ntt_bench [--baseline PATH/ntt.cu] [--sweep]

For each shape of SHAPES (rows of one limb chain at N = 2^15; forward and
inverse; plain loads and a per-row Galois gather of the rotations
1..batch) it checks the kernel bit-exact against ``ntt_fwd_plain`` /
``ntt_inv_plain`` (and the baseline, when given), then times kernel,
baseline, baseline, kernel with CUDA events (each window queued behind a
sleep on the card, so it holds device time), and prints one line per shape
with each pass's device time (the profiler's K1 kernels, by name) and the
bound: the larger of the bytes moved (rows read and written once, the
twiddle rows and any permutation read once) over 3.35 TB/s and the
butterflies' 32-bit operations over 67 T/s.  ``--sweep`` also times every
shape of SWEEP_SHAPES at each R' of SWEEP_RB (the batch rows a row-pass block walks,
``ops/ntt.py`` ``rows_per_block``), forced.  ``chip_smoke.py`` calls
``measure`` in its kernel phase.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..ops import kernels
from ..ops.ntt import NttPlan, ntt_fwd_plain, ntt_inv_plain, permute_rows, rows_per_block
from .benchkit import bound, build_alone, event_ms, ntt_ops

# (label, batch, limbs): rows = batch x limbs of the production chain (14 q
# limbs, then 6 special); 2 is a rescale's top limb, 28 a ciphertext, 160 =
# [8, 20] a decomposed digit stack, 180 = [30, 6] and 420 = [30, 14] a
# giant-step mod-down's special and q limbs, 448 a compare stack of 16
# scores, 900 = [45, 20] and 960 = [48, 20] the giant steps' and the
# relinearizations' ModUp
SHAPES = [("2 rows [2,1]", 2, (0,)), ("28 rows [2,14]", 2, tuple(range(14))),
          ("160 rows [8,20]", 8, tuple(range(20))), ("180 rows [30,6]", 30, tuple(range(14, 20))),
          ("420 rows [30,14]", 30, tuple(range(14))), ("448 rows [32,14]", 32, tuple(range(14))),
          ("900 rows [45,20]", 45, tuple(range(20))), ("960 rows [48,20]", 48, tuple(range(20)))]
# the sweep's shapes besides: the compare circuit's few-limb stacks
SWEEP_SHAPES = SHAPES + [("32 rows [32,1]", 32, (0,)), ("64 rows [32,2]", 32, (0, 1)),
                         ("64 rows [16,4]", 16, tuple(range(4))),
                         ("128 rows [32,4]", 32, tuple(range(4))),
                         ("128 rows [16,8]", 16, tuple(range(8))),
                         ("192 rows [32,6]", 32, tuple(range(6)))]
SWEEP_RB = (1, 2, 4, 8, 16)
_K1_NAME = re.compile(r"\b(ntt_\w*?_kernel)\b")


class Baseline(NamedTuple):
    """Another ntt.cu built alone: its library, and whether its imtpu_ntt
    takes R' (a design from before the batched row pass does not)."""
    lib: object
    takes_rb: bool


def bound_ms(rows: int, limbs: int, n: int, perm_rows: int = 0):
    """(ms, "bytes" or "operations") for `rows` transforms of N = n over
    `limbs` twiddle rows, with `perm_rows` permutations read."""
    return bound((2 * rows * n + 2 * limbs * n + perm_rows * n) * 4, ntt_ops(rows, n))


def build_baseline(src: Path) -> Baseline:
    """Another ntt.cu built alone into its own library (its includes from
    its own directory first, then the port's csrc/), loaded with its own
    ``imtpu_ntt``, bound with as many arguments as its source declares."""
    src = Path(src)
    decl = re.search(r"int imtpu_ntt\((.*?)\)", src.read_text(), re.S).group(1)
    sig = kernels._ENTRIES["imtpu_ntt"][:decl.count(",")]  # the arguments before the stream
    lib = build_alone(src.parent, (src.name,), "ntt", {"imtpu_ntt": sig})
    return Baseline(lib, len(sig) == len(kernels._ENTRIES["imtpu_ntt"]))


def k1_call(plan: NttPlan, a: torch.Tensor, limbs, inverse: bool,
            perm: Optional[torch.Tensor], rb: Optional[int] = None,
            baseline: Optional[Baseline] = None) -> torch.Tensor:
    """imtpu_ntt (the port's, or the baseline's) with the arguments
    NttPlan._launch gives K1 for a contiguous [B, L, N] input, R' forced
    to ``rb`` (default: ``rows_per_block``)."""
    out = torch.empty_like(a)
    batch, L = a.shape[0], len(limbs)
    idx = plan.limb_index(limbs)
    tw, tw_sh = (plan.ipsis, plan.ipsis_sh) if inverse else (plan.psis, plan.psis_sh)
    pb = plan.n if perm is not None and perm.dim() == 2 and perm.shape[0] > 1 else 0
    args = [kernels.ptr(a), a[0].numel(), kernels.ptr(perm), pb, idx.data_ptr(), batch * L, L,
            plan.logn, tw.data_ptr(), tw_sh.data_ptr(), plan.q.data_ptr(),
            plan.ninv.data_ptr(), plan.ninv_sh.data_ptr(), int(inverse)]
    if baseline is None or baseline.takes_rb:
        args.append(rows_per_block(batch, L, plan.logn) if rb is None else rb)
    if baseline is None:
        kernels.launch("imtpu_ntt", "ntt_inv" if inverse else "ntt_fwd", out, *args)
        return out
    rc = baseline.lib.imtpu_ntt(out.data_ptr(), *args,
                                torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"baseline imtpu_ntt: CUDA error {rc}")
    return out


def pass_ms(fn, iters: int = 20) -> Dict[str, float]:
    """Device ms a call of ``fn`` spends in each K1 kernel, by its name
    (``ntt_cols_kernel``, ``ntt_rows_kernel``, ``ntt_rows_batch_kernel``),
    from ``torch.profiler`` over ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms: Dict[str, float] = {}
    for e in prof.key_averages():
        m = _K1_NAME.search(e.key)
        if m and e.device_type == torch.autograd.DeviceType.CUDA:
            ms[m.group(1)] = ms.get(m.group(1), 0.0) + e.self_device_time_total / 1e3 / iters
    return ms


def _inputs(plan: NttPlan, gen, batch: int, limbs):
    """Uniform residues [batch, L, N] of the limbs' primes and one
    rotation's automorphism per batch row, as a hoisted rotation stack
    gathers them (the Galois element 5^r of a left rotation by r)."""
    n = plan.n
    q = plan.q[plan.limb_index(limbs).long()].long()[:, None]
    a = (torch.randint(0, 1 << 62, (batch, len(limbs), n), generator=gen,
                       device=plan.device) % q).int()
    perm = torch.from_numpy(np.stack([plan.auto_perm(pow(5, r, 2 * n))
                                      for r in range(1, batch + 1)])).to(plan.device)
    return a, perm


def measure(plan: NttPlan, baseline: Optional[Baseline] = None,
            iters: int = 20) -> List[Dict]:
    """Every shape of SHAPES, forward and inverse, without and with a
    per-row permutation: bit-exact checks, then times in turns (kernel,
    baseline, baseline, kernel; the mean of each side), each pass's device
    time on both sides and the plain version's time.  Returns one dict per
    case."""
    gen = torch.Generator(device=plan.device).manual_seed(99)
    rows_out = []
    for label, batch, limbs in SHAPES:
        L = len(limbs)
        idx = plan.limb_index(limbs).long()
        a, perm = _inputs(plan, gen, batch, limbs)
        for p in (None, perm):
            for inverse in (False, True):
                fn = plan.inv if inverse else plan.fwd

                def plain():
                    x = permute_rows(a, p)
                    return (ntt_inv_plain(x, plan.ipsis[idx], plan.q[idx], plan.ninv[idx])
                            if inverse else ntt_fwd_plain(x, plan.psis[idx], plan.q[idx]))

                def mine():
                    return fn(a, limbs, p)

                def base():
                    return k1_call(plan, a, limbs, inverse, p, baseline=baseline)

                want = plain()
                err = int((mine().long() - want.long()).abs().max())
                base_err = None
                if baseline is not None:
                    base_err = int((base().long() - want.long()).abs().max())
                for _ in range(3):  # warm-up
                    mine()
                torch.cuda.synchronize()
                k1 = [event_ms(mine, iters)]
                base_ms = []
                if baseline is not None:
                    base_ms = [event_ms(base, iters), event_ms(base, iters)]
                    k1.append(event_ms(mine, iters))
                pms = event_ms(plain, 2)
                bms, by = bound_ms(batch * L, L, plan.n, 0 if p is None else batch)
                rows_out.append({
                    "shape": label, "rows": batch * L, "direction": "inv" if inverse else "fwd",
                    "perm": p is not None, "rb": rows_per_block(batch, L, plan.logn),
                    "max_abs_err": err, "baseline_max_abs_err": base_err,
                    "ms": sum(k1) / len(k1),
                    "baseline_ms": sum(base_ms) / len(base_ms) if base_ms else None,
                    "pass_ms": pass_ms(mine, iters),
                    "baseline_pass_ms": pass_ms(base, iters) if baseline is not None else None,
                    "plain_ms": pms, "bound_ms": bms, "bound_by": by})
                del want
        del a, perm
    return rows_out


def sweep(plan: NttPlan, iters: int = 20) -> List[Dict]:
    """Every shape of SWEEP_SHAPES at each R' of SWEEP_RB (no larger than its
    batch), forced: forward, inverse, inverse through a per-row
    permutation; each checked bit-exact against R' = 1 first.  Returns one
    dict per (shape, case) with the ms of each R'."""
    gen = torch.Generator(device=plan.device).manual_seed(98)
    out = []
    for label, batch, limbs in SWEEP_SHAPES:
        a, perm = _inputs(plan, gen, batch, limbs)
        for inverse, p in ((False, None), (True, None), (True, perm)):
            want = k1_call(plan, a, limbs, inverse, p, rb=1)
            ms = {}
            for rb in SWEEP_RB:
                if rb > batch:
                    continue
                call = lambda: k1_call(plan, a, limbs, inverse, p, rb=rb)  # noqa: E731
                assert torch.equal(call(), want), (label, inverse, p is not None, rb)
                ms[rb] = sum(event_ms(call, iters) for _ in range(2)) / 2
            out.append({"shape": label, "direction": "inv" if inverse else "fwd",
                        "perm": p is not None, "chosen_rb": rows_per_block(batch, len(limbs),
                                                                          plan.logn),
                        "ms_by_rb": ms})
        del a, perm
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another ntt.cu to build alone and time beside K1")
    ap.add_argument("--sweep", action="store_true",
                    help="also time every shape at each R' of SWEEP_RB, forced")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ntt_bench: needs a CUDA device")
    from ..ckks.params import SchemeParams, compute_required_depth, root_of_unity
    from ..matching.config import MatchConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    params = SchemeParams.create(mult_depth=compute_required_depth(5, MatchConfig().comp_depth))
    chain = params.q_primes + params.sp_primes
    plan = NttPlan(params.ring_dim, chain, [root_of_unity(q, 2 * params.ring_dim)
                                            for q in chain], device="cuda")
    base = build_baseline(args.baseline) if args.baseline else None
    kernels.lib()
    print(smi, flush=True)
    for r in measure(plan, base):
        print(json.dumps(r), flush=True)
        assert r["max_abs_err"] == 0 and r["baseline_max_abs_err"] in (None, 0), r
    if args.sweep:
        for r in sweep(plan):
            print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()

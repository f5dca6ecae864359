"""K1 (the NTT, ``csrc/ntt.cu``) on the card at the row counts the main
path gives it, against its plain version and, when given, another build of
``ntt.cu`` (an earlier design) in turns on the same inputs.

    python3 -m image_matching_tpu_torch.utils.ntt_bench [--baseline PATH/ntt.cu]

For each shape (rows of one limb chain at N = 2^15: 2, 28, 160 = [8, 20],
448 = [32, 14]; forward and inverse; plain loads and a per-row Galois
gather of the rotations 1..batch) it checks the kernel bit-exact against ``ntt_fwd_plain`` /
``ntt_inv_plain`` (and the baseline, when given), then times kernel,
baseline, baseline, kernel with CUDA events (each window queued behind a
sleep on the card, so it holds device time), and prints one line per shape
with the bound: the larger of the bytes moved (rows read and written once,
the twiddle rows and any permutation read once) over 3.35 TB/s and the
butterflies' 32-bit operations over 67 T/s.  ``chip_smoke.py`` calls
``measure`` in its kernel phase.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import kernels
from ..ops.ntt import NttPlan, ntt_fwd_plain, ntt_inv_plain, permute_rows
from .benchkit import bound, build_alone, event_ms, ntt_ops

# (label, batch, limbs): rows = batch x limbs of the production chain; 2
# is a rescale's top limb, 28 a ciphertext, 160 = [8, 20] a decomposed digit stack,
# 448 a compare stack of 16 scores
SHAPES = [("2 rows [2,1]", 2, 1), ("28 rows [2,14]", 2, 14), ("160 rows [8,20]", 8, 20),
          ("448 rows [32,14]", 32, 14)]


def bound_ms(rows: int, limbs: int, n: int, perm_rows: int = 0):
    """(ms, "bytes" or "operations") for `rows` transforms of N = n over
    `limbs` twiddle rows, with `perm_rows` permutations read."""
    return bound((2 * rows * n + 2 * limbs * n + perm_rows * n) * 4, ntt_ops(rows, n))


def build_baseline(src: Path):
    """Another ntt.cu built alone into its own library (its includes from
    its own directory first, then the port's csrc/), loaded with its own
    ``imtpu_ntt``."""
    src = Path(src)
    return build_alone(src.parent, (src.name,), "ntt",
                       {"imtpu_ntt": kernels._ENTRIES["imtpu_ntt"]})


def _baseline_call(lib, plan: NttPlan, a: torch.Tensor, limbs, inverse: bool,
                   perm: Optional[torch.Tensor]) -> torch.Tensor:
    """The baseline's imtpu_ntt with the arguments NttPlan._launch gives
    K1 (a contiguous [B, L, N] input)."""
    out = torch.empty_like(a)
    idx = plan.limb_index(limbs)
    tw, tw_sh = (plan.ipsis, plan.ipsis_sh) if inverse else (plan.psis, plan.psis_sh)
    pb = plan.n if perm is not None and perm.dim() == 2 and perm.shape[0] > 1 else 0
    rc = lib.imtpu_ntt(out.data_ptr(), a.data_ptr(), a[0].numel(), kernels.ptr(perm), pb,
                       idx.data_ptr(), a.numel() // plan.n, len(limbs), plan.logn,
                       tw.data_ptr(), tw_sh.data_ptr(), plan.q.data_ptr(), plan.ninv.data_ptr(),
                       plan.ninv_sh.data_ptr(), int(inverse),
                       torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"baseline imtpu_ntt: CUDA error {rc}")
    return out


def measure(plan: NttPlan, baseline=None, iters: int = 20) -> List[Dict]:
    """Every shape of SHAPES, forward and inverse, without and with a
    per-row permutation: bit-exact checks, then times in turns (kernel,
    baseline, baseline, kernel; the mean of each side) and the plain
    version's.  Returns one dict per case."""
    dev = plan.device
    gen = torch.Generator(device=dev).manual_seed(99)
    n = plan.n
    rows_out = []
    for label, batch, L in SHAPES:
        limbs = tuple(range(L))
        idx = plan.limb_index(limbs).long()
        q = plan.q[idx].long()[:, None]
        a = (torch.randint(0, 1 << 62, (batch, L, n), generator=gen, device=dev) % q).int()
        # one rotation's automorphism per batch row, as a hoisted rotation
        # stack gathers them (the Galois element 5^r of a left rotation by r)
        perm = torch.from_numpy(np.stack([plan.auto_perm(pow(5, r, 2 * n))
                                          for r in range(1, batch + 1)])).to(dev)
        for p in (None, perm):
            for inverse in (False, True):
                fn = plan.inv if inverse else plan.fwd

                def plain():
                    x = permute_rows(a, p)
                    return (ntt_inv_plain(x, plan.ipsis[idx], plan.q[idx], plan.ninv[idx])
                            if inverse else ntt_fwd_plain(x, plan.psis[idx], plan.q[idx]))

                want = plain()
                got = fn(a, limbs, p)
                err = int((got.long() - want.long()).abs().max())
                base_err = None
                if baseline is not None:
                    base_err = int((_baseline_call(baseline, plan, a, limbs, inverse, p).long()
                                    - want.long()).abs().max())
                for _ in range(3):  # warm-up
                    fn(a, limbs, p)
                torch.cuda.synchronize()
                k1 = [event_ms(lambda: fn(a, limbs, p), iters)]
                base = []
                if baseline is not None:
                    call = lambda: _baseline_call(baseline, plan, a, limbs, inverse, p)  # noqa: E731
                    base = [event_ms(call, iters), event_ms(call, iters)]
                    k1.append(event_ms(lambda: fn(a, limbs, p), iters))
                pms = event_ms(plain, 2)
                bms, by = bound_ms(batch * L, L, n, 0 if p is None else batch)
                rows_out.append({
                    "shape": label, "rows": batch * L, "direction": "inv" if inverse else "fwd",
                    "perm": p is not None, "max_abs_err": err, "baseline_max_abs_err": base_err,
                    "ms": sum(k1) / len(k1), "baseline_ms": sum(base) / len(base) if base else None,
                    "plain_ms": pms, "bound_ms": bms, "bound_by": by})
                del want, got
        del a, perm
    return rows_out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another ntt.cu to build alone and time beside K1")
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


if __name__ == "__main__":
    main()

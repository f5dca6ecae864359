"""The streamed HyDia membership's contraction on the card: its 64 groups
through K2's seeded variant (``senders.ct_dot_seeded``: c0 read where it
lies, c1 drawn in registers) against the route that materialises each
group's [512, 2, 14, N] stack (K5 writes c1 into it, c0 is copied into
it, K2 reads it back), in turns on the same inputs.

    python3 -m image_matching_tpu_torch.utils.dot_bench [--baseline PATH/ct_dot.cu]

At production parameters (N = 2^15, 14 limbs, dim 512 in 16 blocks of
K = 32, two distinct c0 buffers standing for the store's resident groups)
it checks one group bit-exact across the routes, then times seeded,
stacked, stacked, seeded with CUDA events (each window queued behind a
sleep on the card, so it holds device time), and prints one line per
route with its seconds per 64 groups.  With ``--baseline``, another
``ct_dot.cu`` (an earlier design, built alone with the ``modmath.cuh``
beside it, through its ``imtpu_ct_dot(out, A, B, K, nb, l, n, LA, LB, q,
qneg, stream)``) is held bit-exact and timed beside K2 at K = 32 x 16
blocks and K = 512, and the stacked route is timed with it too.
``chip_smoke.py`` calls ``measure`` in its kernel phase.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

import torch

from ..matching import senders
from .benchkit import build_alone, event_ms

GROUPS, DIM, N1 = 64, 512, 32  # 2^20 vectors, BSGS n1 = 32, n2 = 16 blocks
SEED = 1234


def build_baseline(src: Path):
    """Another ct_dot.cu built alone into its own library, its includes
    from its own directory first, then the port's csrc/."""
    src = Path(src)
    return build_alone(src.parent, (src.name,), "ct_dot", {"imtpu_ct_dot": "pppiiiiiipp"})


def _baseline_dot(lib, ctx, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """The baseline's contraction of A [K, 2, L, N] with B [nb, K, 2, L, N]
    (both contiguous, one limb count)."""
    K, _, L, n = A.shape
    nb = B.shape[0]
    out = torch.empty((nb, 3, L, n), dtype=torch.int32, device=A.device)
    rc = lib.imtpu_ct_dot(out.data_ptr(), A.data_ptr(), B.data_ptr(), K, nb, L, n, L, L,
                          ctx.q32.data_ptr(), ctx.qneg32.data_ptr(),
                          torch.cuda.current_stream(A.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"baseline imtpu_ct_dot: CUDA error {rc}")
    return out


def _residues(ctx, shape, gen):
    q = ctx.q64[: shape[-2], None]
    return (torch.randint(0, 1 << 62, shape, generator=gen, device=ctx.device) % q).int()


def measure(ctx, baseline=None) -> List[Dict]:
    """The 64-group contraction by each route (in turns, bit-checked on one
    group), and with a baseline K2 alone beside it.  Returns one dict per
    measurement."""
    dev, n, L = ctx.device, ctx.n, ctx.Lq
    gen = torch.Generator(device=dev).manual_seed(77)
    Q = _residues(ctx, (N1, 2, L, n), gen)
    c0s = [_residues(ctx, (DIM, L, n), gen) for _ in range(2)]
    stack = torch.empty((DIM, 2, L, n), dtype=torch.int32, device=dev)
    nb = DIM // N1

    def stacked_group(g, dot):
        stack[:, 0].copy_(c0s[g % 2])
        ctx.expand_c1(SEED, g, DIM, L, out=stack[:, 1])
        return dot(ctx, Q, stack.view(nb, N1, 2, L, n))

    def seeded_group(g):
        return senders.ct_dot_seeded(ctx, Q, c0s[g % 2], SEED, g, nb)

    routes = {"seeded": lambda: [seeded_group(g) for g in range(GROUPS)],
              "stacked": lambda: [stacked_group(g, senders.ct_dot) for g in range(GROUPS)]}
    want = seeded_group(GROUPS - 1)
    checks = {"stacked": stacked_group(GROUPS - 1, senders.ct_dot)}
    if baseline is not None:
        def old_dot(c, A, B):
            return _baseline_dot(baseline, c, A, B)
        routes["stacked, baseline K2"] = lambda: [stacked_group(g, old_dot) for g in range(GROUPS)]
        checks["stacked, baseline K2"] = stacked_group(GROUPS - 1, old_dot)
    for name, got in checks.items():
        if not torch.equal(got, want):
            raise AssertionError(f"dot_bench: the {name} route differs from the seeded one")
    del want, checks
    for fn in routes.values():  # warm-up
        fn()
    torch.cuda.synchronize()
    names = list(routes)
    order = names + names[::-1]  # seeded, stacked, ..., stacked, seeded
    times: Dict[str, List[float]] = {k: [] for k in names}
    for name in order:  # each group's kernels outlast its wrappers' host time
        times[name].append(event_ms(routes[name], 1))
    out = [{"what": f"64-group contraction, {name}", "seconds": [t / 1e3 for t in ts],
            "mean_s": sum(ts) / len(ts) / 1e3} for name, ts in times.items()]
    del stack, c0s
    if baseline is not None:
        out += _k2_beside(ctx, baseline, gen)
    return out


def _k2_beside(ctx, baseline, gen) -> List[Dict]:
    """K2 and the baseline alone, bit-checked, in turns (K2, baseline,
    baseline, K2; ms per call over windows of 20 calls), at HyDia's and
    HERS's shapes."""
    n, L = ctx.n, ctx.Lq
    out = []
    for label, K, nb in (("K=32 x 16 blocks", 32, 16), ("K=512", 512, 1)):
        A = _residues(ctx, (K, 2, L, n), gen)
        B = _residues(ctx, (nb, K, 2, L, n), gen)
        want = senders.ct_dot(ctx, A, B)
        if not torch.equal(_baseline_dot(baseline, ctx, A, B), want):
            raise AssertionError(f"dot_bench: the baseline K2 differs at {label}")

        def new():
            return senders.ct_dot(ctx, A, B)

        def old():
            return _baseline_dot(baseline, ctx, A, B)

        new(), old()
        torch.cuda.synchronize()
        ks = [event_ms(new, 20), event_ms(old, 20), event_ms(old, 20), event_ms(new, 20)]
        out.append({"what": f"K2 {label}", "ms": (ks[0] + ks[3]) / 2,
                    "baseline_ms": (ks[1] + ks[2]) / 2})
        del A, B, want
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, default=None,
                    help="another ct_dot.cu to build alone and time beside K2")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dot_bench: needs a CUDA device")
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

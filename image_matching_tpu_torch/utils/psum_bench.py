"""K12 (``csrc/psum_mod.cu``), the modular sum of shard partials, alone on
the card, beside another build of it (an earlier design) in turns.

    python3 -m image_matching_tpu_torch.utils.psum_bench [--baseline DIR]

Buffers of [2, 2, N] blocks (N = 2^15, HyDia's two flag limbs): P = 4 x 16
rows (the one-card streamed path: 2^20 over 4 shards), 4 x 1 and 8 x 1 rows
(shard partials), 1 x 16 rows, and the ``all_gather`` shape: 4 one-row
views of one gathered stack.  Each design is held bit-exact against
``psum_mod_plain`` and timed twice, each time kernel, baseline, baseline,
kernel, twice (four windows of 20 calls a side):
  (a) device time: CUDA events around 20 calls queued behind a sleep on
      the card; the earlier design's device table of addresses is built
      once, outside the window;
  (b) the whole wrapper call on the host clock (20 calls, no sync inside,
      the card idle before them); the earlier design's wrapper copies its
      table to the card from pageable memory on every call, which waits
      for the stream to drain.
Bound: the larger of the bytes (every input row read once, the output
written once) over 3.35 TB/s and the adds over 67 T/s.  ``DIR`` holds the
earlier ``psum_mod.cu`` and ``modmath.cuh``, built alone into a library of
their own (their entry point takes a device table of P addresses and P row
counts).  ``chip_smoke.py`` calls ``measure`` where ``build/psum_prev/``
holds them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

import torch

from ..parallel import sharded
from .benchkit import ADD, bound, build_alone, call, host_ms, in_turns

SOURCES = ("psum_mod.cu", "modmath.cuh")
BASELINE_ENTRIES = {"imtpu_psum_mod": "ppiiiip"}  # the earlier design's entry point
LIMBS = 2  # the membership flag's limbs at production parameters
CASES = (("P=4 x 16 rows", [16] * 4), ("P=4 x 1 row", [1] * 4), ("P=8 x 1 row", [1] * 8),
         ("P=1 x 16 rows", [16]), ("all_gather: 4 one-row views of one stack", None))


def build_baseline(src_dir: Path):
    """The earlier K12 built alone, its header from ``src_dir``."""
    return build_alone(src_dir, SOURCES, "psum", BASELINE_ENTRIES)


def flag_primes():
    """The flag's primes and N at production parameters (HyDia's chain)."""
    from ..ckks.params import SchemeParams, compute_required_depth
    from ..matching.config import MatchConfig

    p = SchemeParams.create(mult_depth=compute_required_depth(5, MatchConfig().comp_depth))
    return p.q_primes[:LIMBS], p.ring_dim


def _parts(counts, primes, n, gen, device):
    q = torch.tensor(primes, dtype=torch.int64, device=device)[:, None]

    def rows(R):
        return (torch.randint(0, 1 << 62, (R, 2, len(primes), n), generator=gen,
                              device=device) % q).int()
    if counts is None:  # all_gather's list: [1, ...] views of one stack
        return list(rows(4)[:, None])
    return [rows(R) for R in counts]


def measure(baseline=None, device="cuda") -> List[Dict]:
    """K12 at CASES, bit-checked, timed in turns with the baseline when
    given.  Returns one dict per case."""
    device = torch.device(device)
    primes, n = flag_primes()
    l = len(primes)
    q = torch.tensor(primes, dtype=torch.int64, device=device)[:, None]
    q32 = torch.tensor(primes, dtype=torch.int32, device=device)
    gen = torch.Generator(device=device).manual_seed(4321)
    out = []
    for label, counts in CASES:
        parts = _parts(counts, primes, n, gen, device)
        block = tuple(parts[0].shape[1:])
        total = parts[0][0].numel()
        R = sum(p.shape[0] for p in parts)
        want = sharded.psum_mod_plain(parts, q)

        def new():
            return sharded.psum_mod_kernel(parts, primes)
        err = int((new().long() - want.long()).abs().max())
        old = old_wrapper = base_err = None
        if baseline is not None:
            spec = [p.data_ptr() for p in parts] + [p.shape[0] for p in parts]
            table = torch.tensor(spec, dtype=torch.int64, device=device)
            res = torch.empty(block, dtype=torch.int32, device=device)

            def old():
                return call(baseline, "imtpu_psum_mod", res, table.data_ptr(), len(parts),
                            total, l, n, q32.data_ptr())

            def old_wrapper():  # the earlier wrapper: a table copied on every call
                t = torch.tensor(spec, dtype=torch.int64, device=device)
                return call(baseline, "imtpu_psum_mod",
                            torch.empty(block, dtype=torch.int32, device=device),
                            t.data_ptr(), len(parts), total, l, n, q32.data_ptr())
            base_err = int((old().long() - want.long()).abs().max())
        if err or base_err:
            raise AssertionError(f"psum_bench {label}: max_abs_err {err}, baseline {base_err}")
        ms, base_ms = in_turns(new, old)
        host, base_host = in_turns(new, old_wrapper, host_ms)
        bms, by = bound((R + 1) * total * 4, R * total * ADD)
        out.append({"what": f"K12 {label}, [2,{l},N]", "ms": ms, "baseline_ms": base_ms,
                    "bound_ms": bms, "bound_by": by, "share_of_bound": bms / ms,
                    "baseline_share": None if base_ms is None else bms / base_ms,
                    "host_ms_a_call": host, "baseline_host_ms_a_call": base_host,
                    "max_abs_err": err, "baseline_max_abs_err": base_err})
        del parts, want
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, default=None,
                    help="a directory with another psum_mod.cu and modmath.cuh to build "
                         "alone and time beside K12")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("psum_bench: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    base = build_baseline(args.baseline) if args.baseline else None
    print(smi, flush=True)
    for r in measure(base):
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()

"""The control of a cell's check: the program on its own lower-precision
path, a CKKS scale of fewer bits than the configuration states
(``SchemeParams.create(scale_bits=..., first_mod_bits=...)``, the first
modulus lowered by as many bits, the special primes as many as that scale
needs), run as a benchmark run is, at the cell's own size and load, and
judged by the same comparison and limits.

    python3 -m portbench.control --workload <cell> --scale-bits <b> --seed <n> --seconds <s>

It prints the run's result line, which has to read ``correct`` false.  The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import sys

from . import bench, run


def lowered(cell: bench.Cell, scale_bits: int) -> bench.Cell:
    """The cell with its scale, and its first modulus by as many bits,
    lowered to ``scale_bits``."""
    g = cell.config["guarantees"]
    if not scale_bits < g["scale_bits"]:
        raise ValueError(f"the control's scale ({scale_bits} bits) has to lie below the "
                         f"configuration's ({g['scale_bits']})")
    low = dataclasses.replace(cell, config=copy.deepcopy(cell.config))
    lg = low.config["guarantees"]
    lg["first_mod_bits"] -= g["scale_bits"] - scale_bits
    lg["scale_bits"] = scale_bits
    del lg["special_limbs"]  # their count follows the scale (``SchemeParams.create``)
    return low


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--scale-bits", type=int, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0,), default=0)
    ap.add_argument("--benchmark", default=str(bench.ROOT / "BENCHMARK.json"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    run.set_environment(bench.ROOT)
    cell = bench.load(args.workload, bench.ROOT / args.benchmark)
    run.say(f"# control: {cell.name} at a scale of {args.scale_bits} bits "
            f"(stated {cell.config['guarantees']['scale_bits']})")
    return run.run(args, lowered(cell, args.scale_bits))


if __name__ == "__main__":
    sys.exit(main())

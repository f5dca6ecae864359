"""The card's peaks and the bytes a kernel has to move, for the per-layer
roofline shares (the byte arithmetic of the program's kernel benches,
copied here so that the yardstick stays with the benchmark).

A share is the least time the card could take over the time the kernel
took: bytes counted once each way over the published HBM rate.  Nothing
is clipped: a share above 100 % says the bytes are counted too high or
the time leaves out part of the work.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM5 80 GB, published HBM3 rate
WORD = 4                   # bytes of a residue (int32)
_K1 = re.compile(r"^ntt_\w*_kernel$")


def is_ntt(kernel: str) -> bool:
    """Whether a kernel (by its short name) is one of K1's passes."""
    return bool(_K1.match(kernel))


def ntt_bytes(rows: int, limbs: int, n: int) -> int:
    """Bytes of one K1 transform of ``rows`` rows of N = n residues over
    ``limbs`` distinct limbs: its input read once, its output written once
    and the limbs' twiddle tables (a table and its Shoup companion) read
    once."""
    return WORD * n * (2 * rows + 2 * limbs)


def ntt_bound_s(launches: Dict[Tuple[int, int], int], n: int) -> float:
    """Least seconds for K1 launches given as (rows, limbs) -> count."""
    return sum(ntt_bytes(r, l, n) * c for (r, l), c in launches.items()) / HBM_BYTES_PER_S


def ntt_kernels_per_launch(n: int) -> int:
    """Device kernels one K1 launch runs: a column pass and a row pass
    above N = 2^8, the row pass alone at N = 2^8 (``csrc/ntt.cu``)."""
    return 2 if n > 1 << 8 else 1

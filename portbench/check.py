"""The comparison that decides a run's ``correct``.

Each kept answer, read as its decrypted slot values, is compared with the
reference's answer to the same query:

- ``flag_gap``: the largest gap, over the kept index answers and all their
  slots that hold a gallery entry, between a served flag and the
  reference's flag of that entry;
- ``member_gap``: the largest gap, over the kept membership answers and all
  their slots, between the served sum and the reference's sum of flags.

An index answer of the wrong number of slots reads an infinite gap, and a
kind with no kept answer reads NaN, which fails every limit.  An answer
whose own gap passes its kind's limit is a failed request.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import torch


NUMBER = {"index": "flag_gap", "membership": "member_gap"}


def gaps(read: Iterable[Tuple[str, int, torch.Tensor]], ref, slots: int
         ) -> Tuple[Dict[str, float], List[Tuple[str, float]]]:
    """``read``: (kind, pool query, decrypted slot values, float64) of each
    kept answer; ``ref``: the reference's ``Answers``; ``slots``: slots a
    ciphertext.  -> the numbers compared, and (number, gap) of each answer."""
    each = []
    for kind, q, vals in read:
        if kind == "index":
            want = ref.index(q)
            n = want.shape[0]
            if vals.shape[0] != slots * math.ceil(n / slots):
                g = math.inf
            else:
                g = float((vals[:n].to(want.device) - want).abs().max())
        elif kind == "membership":
            g = float((vals.to(torch.float64) - ref.membership(q)).abs().max())
        else:
            raise ValueError(f"unknown answer kind {kind!r}")
        each.append((NUMBER[kind], g))
    numbers = {name: max((g for k, g in each if k == name), default=math.nan)
               for name in NUMBER.values()}
    return numbers, each


def failed(each: List[Tuple[str, float]], limits: Dict[str, float]) -> int:
    """Answers whose gap passes the limit of their number."""
    return sum(1 for name, g in each if not g <= limits[name])

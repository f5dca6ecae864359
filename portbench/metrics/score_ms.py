"""Device milliseconds a request spends in the group score: the device
operations launched inside the program's ``imtpu.score`` spans
(``senders.diag_group_score``: relinearization, the giant-step rotations
and the rescale of each group's score).

This file also holds what the readers of the program's spans share: the
requests the slice's ``imtpu.membership`` and ``imtpu.index`` spans count,
and the union of a span's intervals.  They read nothing where the program
has no such spans, or where those spans count other requests than the
slice's."""

import bisect

REQUEST_SPANS = ("imtpu.membership", "imtpu.index")


def served(s):
    """The slice's requests by the program's request spans, or None."""
    n = sum(1 for h in s.host if h.name in REQUEST_SPANS)
    return n if n and n == s.requests else None


def union(s, name):
    """The union of the host spans named ``name``, clipped to the slice:
    disjoint (start, end) in order."""
    out = []
    for a, b in sorted((max(h.start, s.lo), min(h.end, s.hi)) for h in s.host
                       if h.name == name):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def read(s):
    n = served(s)
    spans = union(s, "imtpu.score")
    if n is None or not spans:
        return None
    starts = [a for a, _ in spans]

    def inside(o):
        t = o.start if o.launch is None else o.launch
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t < spans[i][1]
    t = s.device_s(inside)
    return t / n * 1e3 if t > 0 else None

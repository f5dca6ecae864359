"""Milliseconds a request in which the device ran nothing while the host
was inside the program's ``imtpu.group`` spans (``_StreamedSender``: each
streamed group's contraction and score): the host pacing the card in the
group loop.  The gaps between the slice's device operations
(``stats.gaps``), intersected with the union of the spans.

Read in the traced slice, so the profiler's own host cost inflates it,
and not rescaled to untraced time as ``device_idle_pct`` is: compare it
only traced run against traced run."""

from portbench import stats
from portbench.metrics.score_ms import served, union


def idle_ms(s, name):
    """Device idle ms a request inside the spans named ``name``, or None
    (also where the slice holds no device operation)."""
    n = served(s)
    spans = union(s, name)
    if n is None or not spans or not s.ops:
        return None
    idle, i = 0.0, 0
    for g0, g1 in stats.gaps(((o.start, o.end) for o in s.ops), s.lo, s.hi):
        while i < len(spans) and spans[i][1] <= g0:
            i += 1
        j = i
        while j < len(spans) and spans[j][0] < g1:
            idle += min(g1, spans[j][1]) - max(g0, spans[j][0])
            j += 1
    return idle / n * 1e3


def read(s):
    return idle_ms(s, "imtpu.group")

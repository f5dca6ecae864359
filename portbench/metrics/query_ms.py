"""Device milliseconds a request spends preparing the query: the device
operations launched inside the program's ``imtpu.query`` spans
(``_StreamedSender._similarity_stream``: HERS's stack of its query
ciphertexts, HyDia's baby-step rotations), before the first group.

Read as ``score_ms`` is, with its request count and span union: nothing
where the program has no such span, or where the slice's
``imtpu.membership`` and ``imtpu.index`` spans count other requests than
the slice's."""

import bisect

from portbench.metrics.score_ms import served, union


def read(s):
    n = served(s)
    spans = union(s, "imtpu.query")
    if n is None or not spans:
        return None
    starts = [a for a, _ in spans]

    def inside(o):
        t = o.start if o.launch is None else o.launch
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t < spans[i][1]
    t = s.device_s(inside)
    return t / n * 1e3 if t > 0 else None

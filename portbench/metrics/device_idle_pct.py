"""Share of a request's time in which no operation (kernel or copy) ran on
the device, with the profiler's own host cost left out:
100 x (1 - union of the slice's device intervals / the seconds the slice's
requests take untraced, from the same run's untraced requests of each
kind).  The profiler slows the host, so the traced slice's own wall time
would count its cost as idle."""


def read(s):
    busy = s.busy_s
    if busy <= 0 or not s.untraced_s:
        return None
    return 100.0 * (1.0 - busy / s.untraced_s)

"""Milliseconds a request in which the device ran nothing while the host
was inside the program's ``imtpu.compare`` spans (``Sender``'s compare
circuits): the host pacing the card in the compare.  Read as
``stream_idle_ms`` is, in the traced slice, so the profiler's own host
cost inflates it: compare it only traced run against traced run."""

from portbench.metrics.stream_idle_ms import idle_ms


def read(s):
    return idle_ms(s, "imtpu.compare")

"""Kernel launches a request makes: the program's launch counters
(``ops/kernels.py``, ``kernels.counts()``) over the whole window, divided
by the window's requests."""


def read(s):
    n = sum(s.counts.values())
    return n / s.window_requests if n and s.window_requests else None

"""Device milliseconds a request spends in the streamed store's seeded
contraction (``senders.ct_dot_seeded``: K2's seeded variant, c0 read where
it lies, c1 drawn in registers)."""

from portbench.trace import short_name


def read(s):
    t = s.device_s(lambda o: short_name(o.name) == "ct_dot_seeded_kernel")
    return s.per_request_ms(t) if t > 0 else None

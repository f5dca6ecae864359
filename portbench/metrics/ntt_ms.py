"""Device milliseconds a request spends in the NTT (K1, ``ops/ntt.py``:
its column and row passes)."""

from portbench.roofline import is_ntt
from portbench.trace import short_name


def read(s):
    t = s.device_s(lambda o: is_ntt(short_name(o.name)))
    return s.per_request_ms(t) if t > 0 else None

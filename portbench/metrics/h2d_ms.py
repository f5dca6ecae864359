"""Device milliseconds a request spends in host-to-device copies: the
query's ciphertexts from the host receive buffer, and any host-tier group
of the store."""


def read(s):
    t = s.device_s(lambda o: o.name.startswith("Memcpy HtoD"))
    return s.per_request_ms(t) if t > 0 else None

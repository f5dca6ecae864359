"""Device milliseconds a request spends in the compare circuit: the device
operations launched inside the harness's ``portbench.compare`` ranges,
which wrap the sender's ``_compare_many`` in traced runs."""


def read(s):
    t = s.device_s(s.launched_in("portbench.compare"))
    return s.per_request_ms(t) if t > 0 else None

"""Device milliseconds a request spends in the evaluator's key-switching
kernels (``ckks/context.py``): the key multiply-accumulate (K4), the fast
base conversion (K3), the digit decomposition (K8) and the division by P
(K7's sub-scale pass, which a rescale also runs)."""

from portbench.trace import short_name

KERNELS = {"ks_mac_kernel", "fbc_kernel", "decompose_kernel", "sub_scale_kernel"}


def read(s):
    t = s.device_s(lambda o: short_name(o.name) in KERNELS)
    return s.per_request_ms(t) if t > 0 else None

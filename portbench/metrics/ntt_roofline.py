"""K1's share of its roofline in the traced slice: the bytes of the
slice's K1 launches (each its [rows, N] input read once, its output written
once and its limbs' twiddle tables once) at the published HBM rate, over
K1's device time.  It reads nothing where the launches that the harness
counted by (rows, limbs) disagree with ``NttPlan.rows_hist`` or with the
profiler's K1 kernels."""

import sys

from portbench import roofline
from portbench.trace import short_name


def read(s):
    k1 = [o for o in s.ops if roofline.is_ntt(short_name(o.name))]
    launched = sum(s.ntt_launches.values())
    if not k1 or not launched:
        return None
    expect = launched * roofline.ntt_kernels_per_launch(s.ring_dim)
    if launched != sum(s.ntt_rows_hist.values()) or len(k1) != expect:
        print(f"ntt_roofline: {launched} K1 launches counted, "
              f"{sum(s.ntt_rows_hist.values())} in rows_hist, {len(k1)} K1 kernels "
              f"profiled (expected {expect}): not read", file=sys.stderr)
        return None
    return 100.0 * roofline.ntt_bound_s(s.ntt_launches, s.ring_dim) / sum(o.seconds for o in k1)

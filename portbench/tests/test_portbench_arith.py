"""The benchmark's arithmetic on hand-worked cases: the percentile, the rate,
the union of busy intervals and its gaps, K1's byte bound, the end-to-end
metrics over a hand-made window, the warm-up's stopping rule, and the
per-layer readers over a hand-made slice."""

import importlib.util
import statistics
from pathlib import Path

import pytest

from portbench import roofline, run, stats, trace

METRICS = Path(__file__).resolve().parents[1] / "metrics"
closed_loop = run.bench._load_module(METRICS.parent / "drivers" / "closed_loop.py",
                                     "t_closed_loop")


def reader(name):
    spec = importlib.util.spec_from_file_location(f"t_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_percentile_interpolates_between_order_statistics():
    v = [5.0, 1.0, 4.0, 2.0, 3.0]  # sorted 1..5; rank 0.9 * 4 = 3.6
    assert stats.percentile(v, 90) == pytest.approx(4.6)
    assert stats.percentile(v, 50) == 3.0
    assert stats.percentile(v, 100) == 5.0
    assert stats.percentile([7.0], 90) == 7.0
    vals = [0.31, 0.35, 0.36, 0.36, 0.37, 0.41, 0.58]
    want = statistics.quantiles(vals, n=10, method="inclusive")[8]
    assert stats.percentile(vals, 90) == pytest.approx(want)


def test_rate_is_all_work_over_all_time():
    assert stats.rate(110, 40.0) == pytest.approx(2.75)
    with pytest.raises(ValueError):
        stats.rate(3, 0.0)


def test_union_and_gaps():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (9.0, 12.0)]
    # clipped to [0.5, 10): [0.5, 3) + [5, 6) + [9, 10) = 2.5 + 1 + 1
    assert stats.union_length(iv, 0.5, 10.0) == pytest.approx(4.5)
    assert stats.gaps(iv, 0.5, 10.0) == [(3.0, 5.0), (6.0, 9.0)]
    assert stats.gaps([], 0.0, 1.0) == [(0.0, 1.0)]
    assert stats.union_length([], 0.0, 1.0) == 0.0


def _window():
    """Six requests, membership and index in turn (latencies in s)."""
    lat = [0.30, 0.50, 0.32, 0.52, 0.34, 0.70]
    out, t = [], 100.0
    for r, x in enumerate(lat):
        out.append(closed_loop.Done(r, ("membership", "index")[r % 2], r % 3, t, t + x))
        t += x
    return out


def test_end_to_end_metrics_over_a_window():
    done = _window()
    assert run.end_to_end("setup_s", 12.5, 2.68, done) == 12.5
    assert run.end_to_end("queries_per_s", 12.5, 2.68, done) == pytest.approx(6 / 2.68)
    # memberships 0.30, 0.32, 0.34: rank 0.9 x 2 = 1.8
    assert run.end_to_end("membership_p90_s", 0, 1, done) == pytest.approx(0.32 + 0.8 * 0.02)
    assert run.end_to_end("index_p90_s", 0, 1, done) == pytest.approx(0.52 + 0.8 * 0.18)
    with pytest.raises(ValueError):
        run.end_to_end("search_p90_s", 0, 1, done)  # a kind the window never served
    with pytest.raises(KeyError):
        run.end_to_end("tokens_per_s", 0, 1, done)


def test_untraced_seconds_of_a_slice():
    done = _window()
    # requests 2 and 3 traced: a membership at the mean of 0.30 and 0.34,
    # an index at the mean of 0.50 and 0.70
    assert run.untraced_s(done, 2, 2) == pytest.approx(0.32 + 0.60)
    assert run.untraced_s(done[:4], 2, 2) == pytest.approx(0.30 + 0.50)
    assert run.untraced_s(done[2:4], 2, 2) is None  # no untraced request of a kind


class _Server:
    """Counts requests; the device allocates on the requests in ``grow``."""

    def __init__(self, grow):
        self.grow, self.sent, self.allocs = grow, [], 0

    def request(self, kind, q):
        if len(self.sent) in self.grow:
            self.allocs += 1
        self.sent.append((kind, q))


def test_warm_up_runs_until_the_allocator_settles():
    mix = {"cycle": ["membership", "index"], "pool": {"queries": 4},
           "warmup": {"settle": 4, "max": 40}}
    srv = _Server({0, 1, 5})
    made = closed_loop.warm_up(srv, mix, lambda: srv.allocs)
    # the last allocation at request 5; then 4 quiet requests, to a whole cycle
    assert made == [1, 1, 0, 0, 0, 1, 0, 0, 0, 0]
    # request r sends query (r + r // 2) % 4: each query comes as each kind
    assert srv.sent[:8] == [("membership", 0), ("index", 1), ("membership", 3), ("index", 0),
                            ("membership", 2), ("index", 3), ("membership", 1), ("index", 2)]
    srv = _Server(set(range(100)))
    assert len(closed_loop.warm_up(srv, mix, lambda: srv.allocs)) == 40  # capped
    srv = _Server(set(range(100)))
    assert closed_loop.warm_up(srv, mix, None) == [0, 0]  # nothing counted: one cycle
    mix["pool"]["queries"] = 3  # (r + r // 2) % 3 never sends query 2
    with pytest.raises(ValueError):
        closed_loop.warm_up(srv, mix, None)


def test_ntt_byte_bound():
    n = 32768
    # 28 rows over 14 limbs: in + out 2 x 28 x N words, twiddles 2 x 14 x N
    assert roofline.ntt_bytes(28, 14, n) == 4 * n * (56 + 28) == 11_010_048
    launches = {(28, 14): 10, (2, 2): 3}
    want = (10 * 11_010_048 + 3 * 4 * n * 8) / 3.35e12
    assert roofline.ntt_bound_s(launches, n) == pytest.approx(want)
    assert roofline.ntt_kernels_per_launch(n) == 2
    assert roofline.ntt_kernels_per_launch(256) == 1
    assert roofline.is_ntt("ntt_cols_kernel") and roofline.is_ntt("ntt_rows_kernel")
    assert not roofline.is_ntt("ct_dot_seeded_kernel")


def hand_slice():
    """Two requests in [0, 1) s: K1 (two kernels a launch), a contraction,
    a key switch, a copy, one kernel launched inside a compare range."""
    k = "void (anonymous namespace)::{}<false, 4, 3>(unsigned int*, int)"
    ops = [
        trace.Op("Memcpy HtoD (Pinned -> Device)", 0.00, 0.01, 0.000),
        trace.Op(k.format("ntt_cols_kernel"), 0.02, 0.10, 0.010),
        trace.Op(k.format("ntt_rows_kernel"), 0.10, 0.20, 0.011),
        trace.Op(k.format("ct_dot_seeded_kernel"), 0.20, 0.50, 0.012),
        trace.Op(k.format("ks_mac_kernel"), 0.55, 0.60, 0.520),
        trace.Op(k.format("decompose_kernel"), 0.60, 0.62, 0.530),
        trace.Op(k.format("tensor_kernel"), 0.70, 0.90, 0.650),
    ]
    host = [
        trace.Span("portbench.slice", 0.0, 1.0),
        trace.Span("portbench.request", 0.0, 0.5),
        trace.Span("portbench.request", 0.5, 1.0),
        trace.Span("portbench.compare", 0.6, 0.7),
        trace.Span("cudaStreamSynchronize", 0.62, 0.69),
        trace.Span("cudaLaunchKernel", 0.650, 0.651),
    ]
    return trace.Slice(ops=ops, host=host, lo=0.0, hi=1.0, requests=2,
                       counts={"ntt_fwd": 30, "ct_dot_seeded": 10}, window_requests=4,
                       ntt_launches={(28, 14): 1}, ntt_rows_hist={28: 1}, ring_dim=32768,
                       untraced_s=0.95)


def test_readers_on_a_hand_made_slice():
    s = hand_slice()
    assert s.busy_s == pytest.approx(0.01 + 0.48 + 0.07 + 0.20)
    assert s.window_s == 1.0
    # busy 0.76 s against the 0.95 s the two requests take untraced
    assert reader("device_idle_pct")(s) == pytest.approx(100 * (1 - 0.76 / 0.95))
    s.untraced_s = None
    assert reader("device_idle_pct")(s) is None
    s.untraced_s = 0.95
    assert reader("contract_ms")(s) == pytest.approx(300 / 2)
    assert reader("ntt_ms")(s) == pytest.approx(180 / 2)
    assert reader("keyswitch_ms")(s) == pytest.approx(70 / 2)
    assert reader("h2d_ms")(s) == pytest.approx(10 / 2)
    assert reader("compare_ms")(s) == pytest.approx(200 / 2)
    assert reader("launches_per_query")(s) == pytest.approx(40 / 4)
    bound = roofline.ntt_bound_s({(28, 14): 1}, 32768)
    assert reader("ntt_roofline")(s) == pytest.approx(100 * bound / 0.18)
    assert s.device_ops(2) == [["ct_dot_seeded_kernel", pytest.approx(0.3)],
                               ["tensor_kernel", pytest.approx(0.2)]]
    gaps = dict((k, v) for k, v in s.idle_gaps())
    # [0.01, 0.02), [0.5, 0.55) and [0.9, 1.0) inside a request with no call
    # open; [0.62, 0.7) inside the compare range, waiting on the stream
    assert gaps["portbench.request > -"] == pytest.approx(0.01 + 0.05 + 0.10)
    assert gaps["portbench.compare > cudaStreamSynchronize"] == pytest.approx(0.08)
    assert gaps["portbench.request > -"] + sum(
        v for k, v in gaps.items() if k != "portbench.request > -") == pytest.approx(0.24)


def test_readers_read_nothing_where_nothing_is_there():
    empty = trace.Slice(ops=[], host=[trace.Span("portbench.slice", 0.0, 1.0)], lo=0.0, hi=1.0,
                        requests=1)
    for name in ("contract_ms", "h2d_ms", "keyswitch_ms", "compare_ms", "ntt_ms",
                 "ntt_roofline", "device_idle_pct", "launches_per_query"):
        assert reader(name)(empty) is None, name


def test_roofline_reads_nothing_when_the_counts_disagree():
    s = hand_slice()
    s.ntt_rows_hist = {28: 2}
    assert reader("ntt_roofline")(s) is None
    s = hand_slice()
    s.ops = s.ops[:2] + s.ops[3:]  # one of K1's two kernels missing from the trace
    assert reader("ntt_roofline")(s) is None


def test_short_names():
    assert trace.short_name("void (anonymous namespace)::ks_mac_kernel<3>(int*)") == \
        "ks_mac_kernel"
    assert trace.short_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH (Device -> Pinned)"
    assert len(trace.short_name("x" * 200)) == 80


def test_slice_from_events_drops_annotations_and_links_launches():
    ev = [
        ("portbench.slice", False, 1.0, 2.0, 0),
        ("portbench.compare", False, 1.1, 1.5, 0),
        ("cudaLaunchKernel", False, 1.2, 1.21, 7),
        ("portbench.compare", True, 1.1, 1.6, 0),  # the range's mark on the device
        ("void ks_mac_kernel<1>(int*)", True, 1.3, 1.4, 7),
        ("void ntt_rows_kernel<0>(int*)", True, 0.5, 0.6, 8),  # before the slice
    ]
    s = trace.from_events(ev, requests=1)
    assert [o.name for o in s.ops] == ["void ks_mac_kernel<1>(int*)"]
    assert s.ops[0].launch == 1.2
    assert s.device_s(s.launched_in("portbench.compare")) == pytest.approx(0.1)
    assert s.busy_s == pytest.approx(0.1)
    with pytest.raises(RuntimeError):
        trace.from_events(ev[1:], requests=1)

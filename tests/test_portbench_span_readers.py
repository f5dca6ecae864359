"""The benchmark's readers of the port's spans (``portbench/metrics/``:
``score_ms``, ``stream_idle_ms``, ``compare_idle_ms``, ``query_ms``) on a
slice built by ``portbench.trace.from_events`` from hand-made events, with
hand-worked values, and reading nothing where the spans are missing or
count other requests than the slice's."""

import importlib.util
from pathlib import Path

import pytest

from portbench import trace

METRICS = Path(__file__).resolve().parents[1] / "portbench" / "metrics"
READERS = ("score_ms", "stream_idle_ms", "compare_idle_ms", "query_ms")

# Two requests in a slice of [0, 1) s.  Host spans (name, start, end):
SPANS = [
    ("portbench.slice", 0.0, 1.0),
    ("portbench.request", 0.0, 0.46),
    ("imtpu.membership", 0.0, 0.45),
    ("imtpu.query", 0.0, 0.02),
    ("imtpu.group", 0.02, 0.10),
    ("imtpu.score", 0.05, 0.10),
    ("imtpu.group", 0.10, 0.18),
    ("imtpu.score", 0.13, 0.18),
    ("imtpu.compare", 0.20, 0.40),
    ("portbench.request", 0.46, 1.0),
    ("imtpu.index", 0.47, 0.95),
    ("imtpu.query", 0.47, 0.50),
    ("imtpu.group", 0.50, 0.60),
    ("imtpu.score", 0.55, 0.60),
    ("imtpu.compare", 0.60, 0.90),
]
# Device operations (name, start, end, launch time):
OPS = [
    ("void ks_mac_kernel<1>(int*)", 0.00, 0.04, 0.01),     # the query's baby steps
    ("void ct_dot_seeded_kernel(int*)", 0.04, 0.08, 0.03),  # group 0's contraction
    ("void sub_scale_kernel(int*)", 0.08, 0.10, 0.06),      # group 0's score
    ("void ntt_rows_kernel<0>(int*)", 0.12, 0.18, 0.14),    # group 1's score, after a gap
    ("void tensor_kernel(int*)", 0.21, 0.30, 0.205),        # the compare
    ("void ntt_cols_kernel<0>(int*)", 0.35, 0.45, 0.34),    # the compare, after a gap
    ("void ks_mac_kernel<1>(int*)", 0.48, 0.50, 0.475),    # the index's query
    ("void ct_dot_seeded_kernel(int*)", 0.52, 0.55, 0.51),  # group 0 of the index
    ("void fbc_kernel(int*)", 0.56, 0.65, 0.555),           # its score, after a gap
    ("void tensor_kernel(int*)", 0.65, 0.80, 0.61),         # the compare
    ("void modarith_kernel(int*)", 0.85, 0.95, 0.82),       # the compare, after a gap
]


def reader(name):
    spec = importlib.util.spec_from_file_location(f"t_span_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def hand_slice(spans=SPANS, requests=2):
    events = [(n, False, s, e, 0) for n, s, e in spans]
    for cid, (name, s, e, launch) in enumerate(OPS, start=1):
        events.append(("cudaLaunchKernel", False, launch, launch + 0.001, cid))
        events.append((name, True, s, e, cid))
    return trace.from_events(events, requests=requests)


def test_score_ms_is_the_work_launched_inside_score_spans():
    # 0.02 + 0.06 + 0.09 s launched inside a score span, over two requests;
    # group 0's contraction and the query's baby steps are outside
    assert reader("score_ms")(hand_slice()) == pytest.approx((0.02 + 0.06 + 0.09) / 2 * 1e3)


def test_query_ms_is_the_work_launched_inside_query_spans():
    # the membership's baby steps (0.04 s, launched at 0.01) and the
    # index's query (0.02 s, launched at 0.475), over two requests; the
    # baby steps run on past their span's end and count whole
    assert reader("query_ms")(hand_slice()) == pytest.approx((0.04 + 0.02) / 2 * 1e3)


def test_query_ms_reads_nothing_without_query_spans():
    # a program without the span (the parent of its first reader) reads
    # nothing, while the other spans still read
    spans = [sp for sp in SPANS if sp[0] != "imtpu.query"]
    assert reader("query_ms")(hand_slice(spans)) is None
    assert reader("score_ms")(hand_slice(spans)) == reader("score_ms")(hand_slice())


def test_query_ms_reads_nothing_where_no_work_was_launched_in_its_spans():
    spans = [sp for sp in SPANS if sp[0] != "imtpu.query"] + [("imtpu.query", 0.46, 0.47)]
    assert reader("query_ms")(hand_slice(spans)) is None


def test_stream_idle_ms_is_the_device_idle_inside_group_spans():
    # gaps [0.10, 0.12) in group 1, [0.50, 0.52) of [0.45, 0.52) in the
    # index's group 0, [0.55, 0.56) in it; [0.18, 0.21) and the rest are not
    assert reader("stream_idle_ms")(hand_slice()) == pytest.approx(
        (0.02 + 0.02 + 0.01) / 2 * 1e3)


def test_compare_idle_ms_is_the_device_idle_inside_compare_spans():
    # [0.20, 0.21) of the gap [0.18, 0.21), [0.30, 0.35) and [0.80, 0.85)
    assert reader("compare_idle_ms")(hand_slice()) == pytest.approx(
        (0.01 + 0.05 + 0.05) / 2 * 1e3)


def test_spans_clipped_to_the_slice_and_overlapping_spans_counted_once():
    spans = SPANS + [("imtpu.compare", 0.38, 0.42), ("imtpu.compare", 0.95, 1.5)]
    # [0.38, 0.42) adds nothing new: the device ran; [0.95, 1.5) clipped to
    # [0.95, 1.0), idle there
    assert reader("compare_idle_ms")(hand_slice(spans)) == pytest.approx(
        (0.01 + 0.05 + 0.05 + 0.05) / 2 * 1e3)


@pytest.mark.parametrize("name", READERS)
def test_no_request_span_reads_nothing(name):
    parent = [sp for sp in SPANS if not sp[0].startswith("imtpu.")]
    assert reader(name)(hand_slice(parent)) is None
    no_requests = [sp for sp in SPANS if sp[0] not in ("imtpu.membership", "imtpu.index")]
    assert reader(name)(hand_slice(no_requests)) is None


@pytest.mark.parametrize("name", READERS)
def test_no_device_operation_reads_nothing(name):
    s = hand_slice()
    s.ops = []
    assert reader(name)(s) is None


@pytest.mark.parametrize("name", READERS)
def test_request_spans_that_count_other_requests_read_nothing(name):
    assert reader(name)(hand_slice(requests=3)) is None
    one = [sp for sp in SPANS if sp[0] != "imtpu.index"]
    assert reader(name)(hand_slice(one)) is None

"""The served request's spans (``image_matching_tpu_torch/utils/spans.py``)
on the streamed HyDia store of tests/test_torch_streaming.py (ring 512, dim
64, 300 vectors in 2 host-tier groups), and the query's span on streamed
HERS too, the port alone: off, a shared no-op; on, the spans of one
request counted, nested and apart as the benchmark's readers assume, the
results unchanged, and the request ids in the Chrome trace."""

import json
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from image_matching_tpu_torch.ckks.context import CkksContext
from image_matching_tpu_torch.ckks.params import SchemeParams, compute_required_depth
from image_matching_tpu_torch.matching import senders, streaming
from image_matching_tpu_torch.matching.config import MatchConfig
from image_matching_tpu_torch.matching.protocol import MatchingProtocol
from image_matching_tpu_torch.utils import io as dio
from image_matching_tpu_torch.utils import spans

DIM, NVEC = 64, 300
CFG = MatchConfig(vector_dim=DIM, chunk_len=16, comp_depth=8, alpha_depth=2)
PARAMS = SchemeParams.create(
    ring_dim=512, mult_depth=compute_required_depth(5, CFG.comp_depth), security="none")


@pytest.fixture(scope="module")
def served():
    """The streamed HyDia protocol, both groups in the host tier, and one
    encrypted query."""
    query, db = dio.gen_dataset(NVEC, DIM, seed=1)
    proto = MatchingProtocol.setup(5, db, CFG, ctx=CkksContext(PARAMS, seed=7, device="cpu"),
                                   streamed=True, resident_budget=0, engine="device")
    return proto, proto.encrypt_query(query)


@pytest.fixture(scope="module")
def served_hers():
    """The streamed HERS protocol on the same data and layout (approach 4
    needs the depth of approach 5), and its query of DIM ciphertexts."""
    query, db = dio.gen_dataset(NVEC, DIM, seed=1)
    proto = MatchingProtocol.setup(4, db, CFG, ctx=CkksContext(PARAMS, seed=7, device="cpu"),
                                   streamed=True, resident_budget=0, engine="device")
    return proto, proto.encrypt_query(query)


def _traced(fn, path):
    """fn() under a CPU profiler recording shapes -> (its result, the
    imtpu.* events of the Chrome trace it exports to ``path``, in order)."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return out, sorted((e for e in events if e.get("name", "").startswith(spans.PREFIX)),
                       key=lambda e: e["ts"])


def _named(events, name):
    return [e for e in events if e["name"] == spans.PREFIX + name]


def _within(inner, outer):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


@pytest.fixture(scope="module")
def three(served, tmp_path_factory):
    """A membership, an index and a membership, traced: their answers and
    the trace's imtpu.* events."""
    proto, q = served
    return _traced(lambda: (proto.membership(q), proto.index(q), proto.membership(q)),
                   tmp_path_factory.mktemp("trace") / "trace.json")


def test_without_a_profiler_a_span_is_one_shared_no_op():
    first = spans.span("membership", {"request": 0, "approach": 5, "cts": 1})
    assert spans.span("group", {"g": 3, "tier": "resident"}) is first
    assert spans.span("score") is first
    with first:
        with spans.span("compare", {"scores": 16}):
            pass


def test_group_tiers():
    store = streaming.SeededStore(None, 0, 1.0, 0)
    store.groups = [torch.zeros(2), torch.zeros(2)]
    store.resident = [True, False]
    assert streaming._group_tier(store, 0, store.groups[0]) == "resident"
    assert streaming._group_tier(store, 0, store.groups[0].clone()) == "peer"
    assert streaming._group_tier(store, 1, store.groups[1]) == "host"
    assert streaming._group_tier(store, 2, torch.zeros(2)) == "pad"


def test_a_profiler_leaves_the_answers_bit_identical(served, three):
    proto, q = served
    (traced_m, traced_i, _), events = three
    assert _named(events, "membership") and _named(events, "index")
    plain_m, plain_i = proto.membership(q), proto.index(q)
    assert torch.equal(plain_m.data, traced_m.data) and plain_m.scale == traced_m.scale
    assert len(plain_i) == len(traced_i) == proto.sender.store.num_groups
    for a, b in zip(plain_i, traced_i):
        assert torch.equal(a.data, b.data) and a.scale == b.scale


@pytest.mark.parametrize("chunk", ["16", "1"])
def test_one_membership_holds_its_groups_scores_and_compares(served, chunk, monkeypatch,
                                                             tmp_path):
    """16: both scores in one stacked compare; 1: one single-score compare
    a group, each run between two groups."""
    monkeypatch.setenv("IMTPU_COMPARE_CHUNK", chunk)
    proto, q = served
    groups = proto.sender.store.num_groups
    _, events = _traced(lambda: proto.membership(q), tmp_path / "trace.json")
    (req,) = _named(events, "membership")
    assert not _named(events, "index")
    group, score, compare = (_named(events, n) for n in ("group", "score", "compare"))
    assert len(group) == len(score) == groups
    assert len(compare) == math.ceil(groups / senders.compare_chunk())
    assert all(_within(g, req) for g in group)
    assert all(_within(sc, g) for sc, g in zip(score, group))
    for c in compare:
        assert _within(c, req)
        assert c["args"]["scores"] == min(groups, int(chunk))
        for g in group:
            assert c["ts"] + c["dur"] <= g["ts"] or g["ts"] + g["dur"] <= c["ts"]


def test_the_chrome_trace_carries_rising_request_ids(served, three, tmp_path):
    proto, q = served
    _, events = three
    reqs = [e for e in events if e["name"] in ("imtpu.membership", "imtpu.index")]
    assert [e["name"] for e in reqs] == ["imtpu.membership", "imtpu.index", "imtpu.membership"]
    ids = [e["args"]["request"] for e in reqs]
    assert ids == list(range(ids[0], ids[0] + 3))
    assert all(e["args"]["approach"] == 5 and e["args"]["cts"] == len(q) for e in reqs)
    assert [(e["args"]["g"], e["args"]["tier"]) for e in _named(events, "group")] == \
        [(0, "host"), (1, "host")] * 3
    # an untraced request takes an id too
    _, before = _traced(lambda: proto.membership(q), tmp_path / "before.json")
    proto.index(q)
    _, after = _traced(lambda: proto.membership(q), tmp_path / "after.json")
    assert _named(after, "membership")[0]["args"]["request"] == \
        _named(before, "membership")[0]["args"]["request"] + 2


@pytest.mark.parametrize("fixture", ["served_hers", "served"])
def test_each_request_prepares_its_query_in_one_span_before_its_groups(fixture, request,
                                                                      tmp_path):
    """Approaches 4 and 5: one ``imtpu.query`` span a request, inside it,
    closed before its first ``imtpu.group`` opens."""
    proto, q = request.getfixturevalue(fixture)
    _, events = _traced(lambda: (proto.membership(q), proto.index(q)), tmp_path / "t.json")
    reqs = [e for e in events if e["name"] in ("imtpu.membership", "imtpu.index")]
    queries, groups = _named(events, "query"), _named(events, "group")
    assert len(reqs) == len(queries) == 2
    for req, qs in zip(reqs, queries):
        assert _within(qs, req) and qs["args"]["cts"] == len(q)
        mine = [g for g in groups if _within(g, req)]
        assert len(mine) == proto.sender.store.num_groups
        assert qs["ts"] + qs["dur"] <= min(g["ts"] for g in mine)

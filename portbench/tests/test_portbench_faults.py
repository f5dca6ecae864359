"""The check has to catch the faults a served cell can have: each rehearsal
below drives a whole run (the look for a card skipped: ``--device cpu``)
with the timed path broken underneath, and ``correct`` has to come out
false.  The exchange between chips has no fault here: a cell runs on one.

Also the control: the program at a lower CKKS scale than the configuration
states fails the tiny cells' limits."""

import contextlib
import io
import json

import pytest

import _rehearse as rh
from image_matching_tpu_torch.matching import senders, streaming
from portbench import bench, control, run


def _unchanged(monkeypatch):
    """A step that returns its state unchanged: the compare circuit hands
    back its scores."""
    monkeypatch.setattr(senders.Sender, "_compare_many", lambda self, scores: list(scores))


def _half(monkeypatch):
    """Half of the gallery left out, the rest standing in for it: only the
    first half of the groups is streamed and compared, and their flags
    count twice."""
    stream = streaming._stream_groups

    def first_half(store, ctx, ids=None):
        ids = list(range(store.num_groups)) if ids is None else list(ids)
        return stream(store, ctx, ids[: max(1, len(ids) // 2)])

    orig = streaming._StreamedSender._stream_and_compare
    monkeypatch.setattr(streaming, "_stream_groups", first_half)
    monkeypatch.setattr(streaming._StreamedSender, "_stream_and_compare",
                        lambda self, q: 2 * orig(self, q))


def _altered(monkeypatch):
    """An answer altered where it is produced: the first group's flags are
    shifted by 0.5 as the compare circuit returns them."""
    orig = senders.Sender._compare_many

    def shifted(self, scores):
        flags = orig(self, scores)
        return [self.ctx.add_scalar(flags[0], 0.5)] + flags[1:]
    monkeypatch.setattr(senders.Sender, "_compare_many", shifted)


def _result(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(argv)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["state_unchanged", "half_left_out", "answer_altered"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    for var in ("IMTPU_STORE_DIR", "TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "USE_FLAX"):
        monkeypatch.setenv(var, "")
    fault(monkeypatch)
    res = _result(["--benchmark", str(rh.REPO / rh.TINY), "--workload", "tiny-hydia-mix",
                   "--seed", "2147483711", "--seconds", "1", "--trace", "0", "--device", "cpu"])
    assert res["correct"] is False, res["check"]
    assert res["failed"] >= 1


@pytest.mark.parametrize("workload", ["tiny-hydia-mix", "tiny-hers-mix"])
def test_the_control_fails_the_tiny_cells(workload, monkeypatch):
    """The program at a 26-bit scale (30 stated), run as a benchmark run
    is: ``correct`` false on every seed."""
    for var in ("IMTPU_STORE_DIR", "TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "USE_FLAX"):
        monkeypatch.setenv(var, "")
    for seed in (1, 2, 3000000001):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = control.main(["--benchmark", str(rh.REPO / rh.TINY), "--workload", workload,
                               "--scale-bits", "26", "--seed", str(seed), "--seconds", "1",
                               "--device", "cpu"])
        res = json.loads(buf.getvalue().strip().splitlines()[-1])
        assert rc == 0 and res["correct"] is False, res["check"]


def test_the_control_lowers_the_scale_alone():
    cell = bench.load("tiny-hydia-mix", rh.REPO / rh.TINY)
    low = control.lowered(cell, 26)
    g, lg = cell.config["guarantees"], low.config["guarantees"]
    assert (lg["scale_bits"], lg["first_mod_bits"]) == (26, 26)
    moved = ("scale_bits", "first_mod_bits", "special_limbs")
    assert "special_limbs" not in lg
    assert {k: v for k, v in lg.items() if k not in moved} == \
        {k: v for k, v in g.items() if k not in moved}
    assert g["scale_bits"] == 30
    with pytest.raises(ValueError):
        control.lowered(cell, 30)

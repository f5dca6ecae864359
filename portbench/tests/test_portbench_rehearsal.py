"""CPU rehearsals of whole runs at a tiny ring, from the test-only
configurations beside these tests: the result line, the import check,
disk hygiene, a cell added by files alone, and a checkout without the
program."""

import contextlib
import io
import json
import os
from pathlib import Path

import pytest

import _rehearse as rh
from portbench import run

KEYS = {"correct", "attempted", "failed", "metrics", "device", "check"}
FORBIDDEN = {"jax", "jaxlib", "flax", "image_matching_tpu"}


def _files(root: Path, skip=("__pycache__", ".git", ".pytest_cache", "chiprun_out")):
    out = set()
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d not in skip]
        out.update(os.path.relpath(os.path.join(dirpath, f), root) for f in files)
    return out


def test_rehearsal_prints_a_well_formed_line_and_leaves_nothing_behind(tmp_path):
    root = rh.checkout(tmp_path / "checkout")
    before = _files(root)
    repo_before = _files(rh.REPO)
    shm_before = set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()
    rc, res, err, mods = rh.run(root, tmp_path / "homes", "--benchmark", rh.TINY,
                                "--workload", "tiny-hydia-mix", "--seed", "3000000019",
                                "--seconds", "1", "--trace", "0")
    assert rc == 0, err[-3000:]
    assert KEYS <= set(res) and res["correct"] is True, res
    assert list(res)[-1] == "check"
    assert set(res["metrics"]) == {"setup_s", "queries_per_s", "membership_p90_s",
                                   "index_p90_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert res["attempted"] >= 2 and res["failed"] == 0  # one whole cycle at least
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    # the numbers compared end standard error, each beside its limit
    tail = [ln for ln in err.strip().splitlines() if not ln.startswith("MODULES ")][-2:]
    assert [ln.split()[:2] for ln in tail] == [["check", "flag_gap"], ["check", "member_gap"]]
    assert all(ln.split()[3] == "limit" for ln in tail)
    # the whole top-level names of the modules left loaded
    assert mods and "image_matching_tpu_torch" in mods and not FORBIDDEN & set(mods)
    # no enrollment cache; new files only in the checkout's build directory
    new = _files(root) - before
    assert not any(".dbcache" in p for p in _files(root) | new)
    assert all(p.startswith("build" + os.sep) for p in new), sorted(new)
    assert _files(rh.REPO) - repo_before <= {p for p in _files(rh.REPO) if "__pycache__" in p}
    if os.path.isdir("/dev/shm"):
        assert set(os.listdir("/dev/shm")) <= shm_before


METRIC = '''"""Compare ranges a request opens in the traced slice (host side)."""


def read(s):
    n = sum(1 for h in s.host if h.name == "portbench.compare")
    return n / s.requests if n else None
'''


def test_a_cell_added_by_files_alone(tmp_path):
    """A configuration, a traffic mix and a per-layer metric, each a new file,
    and entries for them: the new cell runs and reports the new metric,
    and no file that was there changes."""
    root = rh.checkout(tmp_path / "checkout")
    snapshot = {p: (root / p).read_bytes() for p in _files(root)}
    bench_path = root / rh.TINY
    bench = json.loads(bench_path.read_text())
    cfg = json.loads((root / "portbench/tests/tiny/tiny-hydia.json").read_text())
    cfg["name"] = "tiny-hydia-quiet"
    cfg["data"]["noise"] = 0.2
    (root / "portbench/tests/tiny/tiny-hydia-quiet.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "portbench/traffic/gate-mix-p16.json").read_text())
    mix["pool"].update(queries=4, matches=2)
    mix["cycle"] = ["index", "membership"]
    (root / "portbench/traffic/gate-mix-p4.json").write_text(json.dumps(mix))
    (root / "portbench/metrics/compares_per_query.py").write_text(METRIC)
    new_bench = dict(bench)
    new_bench["configs"] = bench["configs"] + [
        {"name": "tiny-hydia-quiet", "source": "test only", "reduced": [], "why": "test",
         "file": "portbench/tests/tiny/tiny-hydia-quiet.json"}]
    new_bench["workloads"] = bench["workloads"] + [
        {"name": "tiny-quiet-p4", "config": "tiny-hydia-quiet", "traffic": "gate-mix-p4",
         "chips": 1, "why": "test"}]
    new_bench["per_layer"] = bench["per_layer"] + [
        {"name": "compares_per_query", "unit": "ranges", "better": "lower",
         "source": "program_span", "layer": "compare circuit", "moves": "queries_per_s"}]
    (root / "added.json").write_text(json.dumps(new_bench))
    rc, res, err, _ = rh.run(root, tmp_path / "homes", "--benchmark", "added.json",
                             "--workload", "tiny-quiet-p4", "--seed", "77", "--seconds", "1",
                             "--trace", "1")
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, res
    assert res["metrics"]["compares_per_query"]["value"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0
    for p, data in snapshot.items():
        assert (root / p).read_bytes() == data, p


def test_a_checkout_without_the_program_fails_and_prints_no_result(tmp_path):
    root = rh.checkout(tmp_path / "bare", program=False)
    rc, res, err, _ = rh.run(root, tmp_path / "homes", "--workload", "hydia-s20-mix",
                             "--seed", "1", "--seconds", "1", "--trace", "0")
    assert rc != 0 and res is None


@pytest.mark.cuda
def test_traced_tiny_run_on_the_card_counts_k1_alike(cuda_card):
    """On the card: K1's launches counted from ``NttPlan.rows_hist`` equal
    the profiler's K1 kernels over the slice (the roofline is read only
    then), and the run is correct."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(["--benchmark", str(rh.REPO / rh.TINY), "--workload", "tiny-hydia-mix",
                       "--seed", "5", "--seconds", "1", "--trace", "1"])
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0 and res["correct"] is True
    assert 0 < res["metrics"]["ntt_roofline"]["value"] <= 100
    assert res["device"]["busy_s"] > 0


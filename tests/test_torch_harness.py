"""Port parity of the harnesses at tests/test_matching.py scale: ring 512,
dim 64, comparison depth 8 (each harness's MatchConfig replaced by that
test configuration in both packages).

The latency CLI's CSV header and row format byte for byte against the
JAX CLI's, and its HyDia decisions equal on the same `.dat`; one row with
membership True and the planted vector 0 for approaches 1-4; the accuracy
harness's plaintext counts and near-threshold census equal to the JAX
harness's on an identity set with borderline entries, in memory and
streamed over a gallery that leaves the last group padded, and with the
JAX encryption noise injected its encrypted counts and score-parity error
equal too; the figures' ciphertext sizes and sign-approximation table
equal, and the plots written (matplotlib only where it is installed)."""

import functools
import re

import numpy as np
import pytest
import torch

from image_matching_tpu.ckks.params import SchemeParams
from image_matching_tpu.harness import accuracy as jacc
from image_matching_tpu.harness import figures as jfig
from image_matching_tpu.harness import latency as jlat
from image_matching_tpu.matching.config import MatchConfig
from image_matching_tpu.utils import io as jio
from image_matching_tpu.utils import native as jnative
from image_matching_tpu_torch.harness import accuracy as tacc
from image_matching_tpu_torch.harness import figures as tfig
from image_matching_tpu_torch.harness import latency as tlat
from image_matching_tpu_torch.harness import run_artifact
from image_matching_tpu_torch.matching import streaming as tstreaming
from image_matching_tpu_torch.utils import native as tnative

from _torch_parity import jax_noise, jax_seeded_noise, port_cfg

# 286 vectors: two groups of 256 slots, the second padded (in memory and
# streamed), in the latency and the accuracy tests alike, so the JAX
# package compiles their circuits once
DIM, RING, NVEC = 64, 512, 286
CFG = MatchConfig(vector_dim=DIM, chunk_len=16, comp_depth=8, alpha_depth=2)
TCFG = port_cfg(CFG)
SIGMA = SchemeParams().sigma
NAMES = ["Baseline", "GROTE", "Blind", "HERS", "Diagonal"]


@pytest.fixture
def small_cfg(monkeypatch):
    """Both packages' harnesses on the test configuration."""
    for mod, cfg in ((jlat, CFG), (jacc, CFG), (tlat, TCFG), (tacc, TCFG)):
        monkeypatch.setattr(mod, "MatchConfig", lambda vector_dim, cfg=cfg: cfg)


@pytest.fixture
def dat(tmp_path):
    query, db = jio.gen_dataset(NVEC, DIM, seed=1)
    path = tmp_path / "d.dat"
    jio.write_dataset(str(path), query, db)
    return str(path)


def _rows(path):
    with open(path) as f:
        lines = f.read().splitlines(keepends=True)
    return lines[0], [re.match(r'^(.*),"(.*)"\n$', line).groups() for line in lines[1:]]


def test_csv_headers_byte_equal():
    assert tlat.CSV_HEADER.encode() == jlat.CSV_HEADER.encode()
    assert tacc.CSV_HEADER.encode() == jacc.CSV_HEADER.encode()


def test_latency_hydia_row_matches_jax(small_cfg, dat, tmp_path):
    """The same row format and decisions as the JAX CLI, a torch.profiler
    Chrome trace where asked for."""
    jcsv, tcsv = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    jrow = jlat.run(dat, 5, jcsv, RING, DIM)
    trow = tlat.run(dat, 5, tcsv, RING, DIM, profile_dir=str(tmp_path / "prof"), device="cpu")
    assert (trow["membership_result"], trow["index_result"]) == \
        (jrow["membership_result"], jrow["index_result"]) == (True, [0])
    (jhead, jlines), (thead, tlines) = _rows(jcsv), _rows(tcsv)
    assert thead == jhead == tlat.CSV_HEADER and len(tlines) == len(jlines) == 1
    jf, tf = jlines[0][0].split(","), tlines[0][0].split(",")
    assert len(tf) == len(jf) == 11
    for i in (0, 1, 3, 5, 8, 10):  # name, size, counts, membership
        assert tf[i] == jf[i]
    for i in (2, 4, 6, 7, 9):  # seconds, 6 decimals
        assert re.fullmatch(r"\d+\.\d{6}", tf[i])
    assert tlines[0][1] == jlines[0][1] == "0"
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert trow["scheme"].startswith("CKKS-RNS: ring dim 512")


@pytest.mark.parametrize("approach", [1, 2, 3, 4])
def test_latency_row_per_approach(small_cfg, dat, tmp_path, approach):
    """One row appended below an existing header: membership True, the
    planted vector 0 in the index."""
    csv = tmp_path / "t.csv"
    csv.write_text(tlat.CSV_HEADER)
    row = tlat.run(dat, approach, str(csv), RING, DIM, device="cpu")
    head, lines = _rows(csv)
    assert head == tlat.CSV_HEADER and len(lines) == 1
    fields = lines[0][0].split(",")
    assert fields[0] == NAMES[approach - 1] and fields[1] == str(NVEC) and fields[10] == "1"
    assert row["membership_result"] is True and 0 in row["index_result"]
    assert lines[0][1] == " ".join(map(str, row["index_result"]))


def test_entry_points_raise_without_a_gpu(dat):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tlat.run(dat, 5, "", RING, DIM)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tacc.run(0, 5, "", RING, DIM, n_ids=4)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        run_artifact.run(4, RING, DIM, "")


@pytest.mark.parametrize("streamed", [False, True], ids=["in_memory", "streamed"])
def test_accuracy_matches_jax(small_cfg, monkeypatch, tmp_path, streamed):
    """70 identities x 4 + 3 queries x 2 borderline entries = NVEC."""
    # the JAX package's CPU backend reports no device memory, so its
    # streamed store takes the host C++ engine where the library loads;
    # the port's CPU default is the device engine: give the port the same
    # engine
    if streamed and jnative.available():
        if not tnative.available():
            pytest.skip("native library not built")
        monkeypatch.setattr(tstreaming, "enroll_diag_streamed",
                            functools.partial(tstreaming.enroll_diag_streamed, engine="native"))
    kw = dict(ring_dim=RING, vector_dim=DIM, n_ids=70, per_id=4, seed=2, n_queries=3,
              parity=True, streamed=streamed, borderline=2)
    jcsv, tcsv = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    jrows = jacc.run(0, 5, jcsv, **kw)
    trows = tacc.run(0, 5, tcsv, device="cpu", ctx_kw={
        "noise": jax_noise(SIGMA), "seeded_noise": jax_seeded_noise(SIGMA)}, **kw)
    assert len(trows) == len(jrows) == 3
    for j, t in zip(jrows, trows):
        assert t == j, (j, t)
        assert t["plain_tp"] == 4 and t["plain_fn"] == 0 and t["near_count"] >= 1
        assert t["max_score_err"] <= 1e-4
    with open(jcsv) as jf, open(tcsv) as tf:
        assert tf.read() == jf.read()


def test_ciphertext_bytes_equal():
    for name in NAMES:
        for ring in (1024, 32768):
            assert tfig.ciphertext_bytes(name, ring) == jfig.ciphertext_bytes(name, ring)


def test_sign_approx_table_equal(tmp_path):
    jx, jc = jfig.sign_approx_table(str(tmp_path / "j" / "s.csv"))
    tx, tc = tfig.sign_approx_table(str(tmp_path / "t" / "s.csv"))
    np.testing.assert_array_equal(jx, tx)
    np.testing.assert_array_equal(jc, tc)
    assert (tmp_path / "t" / "s.csv").read_bytes() == (tmp_path / "j" / "s.csv").read_bytes()


def test_figures_written(tmp_path):
    pytest.importorskip("matplotlib")
    csv = tmp_path / "latency.csv"
    lines = [tlat.CSV_HEADER]
    for a, name in enumerate(NAMES):
        for n in (1024, 4096):
            lines.append(f"{name},{n},0.01,1,{0.1 * (a + 1) * n / 1024:.6f},1,0.002,"
                         f"{0.2 * (a + 1) * n / 1024:.6f},{1 + a % 2},0.003,1,\"0\"\n")
    csv.write_text("".join(lines))
    out = tmp_path / "fig"
    tfig.generate(str(csv), str(out))
    tfig.sign_approx_plot(str(out / "sign_approx.png"))
    for name in ("membership_scalability", "identification_scalability",
                 "membership_bandwidth", "identification_bandwidth", "sign_approx"):
        assert (out / f"{name}.png").stat().st_size > 0, name

"""The benchmark's HERS cell, ``hers-s20-mix`` (configuration
``hers-streamed-2p20``, traffic ``gate-mix-p4-b16``): the cell as the
harness loads it, a CPU rehearsal of its layout at ring 512 whose sound run
passes the check and whose 26-bit control fails it, and the port's
streamed HERS against the plain reference on the traffic's seeded data."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import bench, data
from portbench.reference.matching import Answers
from portbench.tests import _rehearse as rh

REPO = Path(__file__).resolve().parents[1]
TINY_HERS = REPO / "portbench" / "tests" / "tiny" / "tiny-hers.json"
TRAFFIC = REPO / "portbench" / "traffic" / "gate-mix-p4-b16.json"
CONTROL = ("import sys\n"
           "from portbench import control\n"
           "sys.exit(control.main(sys.argv[1:]))\n")

# The rehearsal's limits, from the tiny layout on the CPU under
# gate-mix-p4-b16 with a one-second window (seeds 3000000001-008 sound,
# 3000000001-006 at a 26-bit scale): sound max flag_gap 9.81e-6 and
# member_gap 2.99e-5; control min 4.27e-5 and 1.40e-4.  Each limit lies
# about halfway between the two on a log scale.
LIMITS = {"flag_gap": 2e-5, "member_gap": 8e-5}
SEED = 3000000001


def test_the_cell_loads_as_hydia_s_deployment_with_approach_4():
    cell = bench.load("hers-s20-mix", REPO / "BENCHMARK.json")
    hydia = bench.load("hydia-s20-mix", REPO / "BENCHMARK.json")
    assert cell.chips == 1
    g, h = cell.config["guarantees"], hydia.config["guarantees"]
    assert g["approach"] == 4 and h["approach"] == 5
    assert {k: v for k, v in g.items() if k != "approach"} == \
        {k: v for k, v in h.items() if k != "approach"}
    d = cell.config["data"]
    assert d["identities"] * d["per_identity"] == g["gallery_vectors"] == 1 << 20
    pool = cell.traffic["pool"]
    assert (pool["queries"], pool["matches"], pool["borderline"]) == (4, 2, 16)
    assert pool["borderline_band"] == hydia.traffic["pool"]["borderline_band"]
    # every per-layer reader of HyDia's cell reads the HERS cell too
    assert [m.name for m in cell.per_layer] == [m.name for m in hydia.per_layer]
    assert "query_ms" in [m.name for m in cell.per_layer]
    assert [m.name for m in cell.end_to_end] == [m.name for m in hydia.end_to_end]


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    """A checkout whose own benchmark file adds the tiny HERS layout under
    gate-mix-p4-b16, with the limits above."""
    tmp = tmp_path_factory.mktemp("hers_cell")
    root = rh.checkout(tmp / "checkout")
    bench_file = json.loads((root / rh.TINY).read_text())
    cfg = json.loads(TINY_HERS.read_text())
    cfg["name"] = "tiny-hers-b16"
    cfg["check"]["limits"] = LIMITS
    (root / "tiny-hers-b16.json").write_text(json.dumps(cfg))
    bench_file["configs"].append({"name": "tiny-hers-b16", "source": "test only",
                                  "file": "tiny-hers-b16.json", "reduced": [],
                                  "why": "CPU rehearsal"})
    bench_file["workloads"].append({"name": "tiny-hers-b16", "config": "tiny-hers-b16",
                                    "traffic": "gate-mix-p4-b16", "chips": 1,
                                    "why": "CPU rehearsal"})
    (root / "hers.json").write_text(json.dumps(bench_file))
    return root, tmp / "homes"


@pytest.mark.parametrize("scale_bits", [None, 26])
def test_the_sound_run_passes_and_the_26_bit_control_fails(rehearsal, monkeypatch, scale_bits):
    root, homes = rehearsal
    args = ["--benchmark", "hers.json", "--workload", "tiny-hers-b16", "--seed", str(SEED),
            "--seconds", "1"]
    if scale_bits is None:
        args += ["--trace", "0"]
    else:
        monkeypatch.setattr(rh, "WRAPPER", CONTROL)
        args += ["--scale-bits", str(scale_bits)]
    rc, res, err, _ = rh.run(root, homes, *args)
    assert rc == 0, err[-3000:]
    assert res["correct"] is (scale_bits is None), res["check"]
    if scale_bits is None:
        assert res["failed"] == 0 and res["attempted"] >= 2
    else:
        # the control fails by both limits at this layout
        assert all(c["value"] > c["limit"] for c in res["check"].values()), res["check"]


def test_streamed_hers_agrees_with_the_plain_reference():
    """The port's streamed HERS (ring 512, dim 64, 2 groups) on the
    traffic's data: every query's index flags and membership sum against
    the reference.  Where the rehearsal above checks the answers its
    served loop kept, through the harness in another process, this calls
    the port's protocol in process and checks every answer of every pool
    query, so a failure here lies in the port and not in the harness; and
    it checks that the plants put flags on the compare's step.  The
    tolerances are the rehearsal's limits: above the 30-bit scale's CKKS
    noise at this layout (sound gaps up to 9.81e-6 and 2.99e-5), below a
    26-bit scale's (4.27e-5 and 1.40e-4)."""
    from image_matching_tpu_torch.ckks.params import SchemeParams, compute_required_depth
    from image_matching_tpu_torch.matching.config import MatchConfig
    from image_matching_tpu_torch.matching.protocol import MatchingProtocol
    from image_matching_tpu_torch.matching.receivers import decrypt_all

    cfg = json.loads(TINY_HERS.read_text())
    g = cfg["guarantees"]
    pool = json.loads(TRAFFIC.read_text())["pool"]
    d = data.make(cfg, pool, SEED, "cpu")
    mcfg = MatchConfig(vector_dim=g["vector_dim"], chunk_len=g["chunk_len"],
                       match_threshold=g["match_threshold"], comp_depth=g["comp_depth"])
    params = SchemeParams.create(
        ring_dim=g["ring_dim"], mult_depth=compute_required_depth(4, g["comp_depth"]),
        scale_bits=g["scale_bits"], first_mod_bits=g["first_mod_bits"], dnum=g["dnum"],
        security=g["security"], sigma=g["sigma"])
    proto = MatchingProtocol.setup(4, d.gallery.numpy(), mcfg, params, seed=SEED,
                                   device="cpu", streamed=True)
    ref = Answers(d.gallery, d.queries, g["match_threshold"], g["comp_depth"])
    n = g["gallery_vectors"]
    assert proto.sender.store.num_groups == 2
    for q in range(d.queries.shape[0]):
        cts = proto.encrypt_query(d.queries[q].numpy())
        flags = np.concatenate(decrypt_all(proto.ctx, proto.index(cts)))[:n]
        want = ref.index(q).numpy()
        assert np.abs(flags - want).max() <= LIMITS["flag_gap"]
        total = decrypt_all(proto.ctx, [proto.membership(cts)])[0]
        assert np.abs(total - ref.membership(q)).max() <= LIMITS["member_gap"]
    # the planted entries put flags on the step: some neither 0 nor 2
    steep = ((ref.flags > 0.1) & (ref.flags < 1.9)).sum()
    assert steep > 0

"""Latency harness: the `ImageMatching` CLI equivalent (reference
src/main.cpp), producing the same latency.csv schema
(reference tools/setup_experiment.sh:1-16); the port of
image_matching_tpu/harness/latency.py.

Usage:  python -m image_matching_tpu_torch.harness.latency <dataset.dat> <approach 1-5>
        [--csv latency.csv] [--ring-dim 32768] [--vector-dim 512]
        [--device cuda] [--profile-dir DIR]

Runs on the card unless ``--device cpu`` is given; without a GPU the
default raises.  ``--profile-dir`` writes a ``torch.profiler`` Chrome trace
(``trace.json``) of the run there, shapes recorded, so that the served
requests' ``imtpu.*`` spans carry their args (``utils/spans.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch

from ..ckks.params import SchemeParams, compute_required_depth
from ..matching.config import MatchConfig
from ..matching.protocol import MatchingProtocol, APPROACH_NAMES
from ..ops import kernels
from ..utils import io as dio

CSV_HEADER = (
    "Experimental Approach,Database Size (vectors),Query Encryption (seconds),"
    "Query Size (ciphertexts),Membership Computation (seconds),"
    "Membership Result Size (ciphertexts),Membership Decryption (seconds),"
    "Index Computation (seconds),Index Result Size (ciphertexts),"
    "Index Decryption (seconds),Decrypted Membership Result,Decrypted Index Result\n"
)


def _block(device: torch.device):
    """Wait for the work queued on ``device`` (the context's card, not the
    current one); nothing to wait for on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def scheme_params(approach: int, cfg: MatchConfig, ring_dim: int,
                  scale_bits: int) -> SchemeParams:
    """The approach's parameters: its depth from computeRequiredDepth,
    128-bit classic security from ring 32768 up, none below (tests)."""
    depth = compute_required_depth(approach, cfg.comp_depth, cfg.alpha_depth)
    return SchemeParams.create(
        ring_dim=ring_dim, mult_depth=depth, scale_bits=scale_bits,
        security="128c" if ring_dim >= 32768 else "none",
    )


@contextlib.contextmanager
def _profiled(profile_dir: str, device: torch.device):
    """A torch.profiler trace of the block, shapes recorded (the spans'
    args), written as a Chrome trace to ``profile_dir/trace.json``;
    nothing when ``profile_dir`` is empty."""
    if not profile_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def run(dataset: str, approach: int, csv_path: str = "latency.csv",
        ring_dim: int = 32768, vector_dim: int = 512, seed: int = 0,
        scale_bits: int = 30, profile_dir: str = "", device="cuda") -> dict:
    dev = kernels.resolve_device(device)
    cfg = MatchConfig(vector_dim=vector_dim)
    print(f"Experimental approach: {APPROACH_NAMES[approach]}")
    query, db = dio.read_dataset(dataset, vector_dim)
    n = db.shape[0]

    params = scheme_params(approach, cfg, ring_dim, scale_bits)
    print(f"CKKS scheme set up (depth = {params.mult_depth}, batch size = {params.slots})")
    row = {"approach": APPROACH_NAMES[approach], "n": n}
    with _profiled(profile_dir, dev):
        t0 = time.time()
        proto = MatchingProtocol.setup(approach, db, cfg, params=params, seed=seed,
                                       device=dev)
        _block(dev)
        print(f"[Enroller] setup + enrollment: {time.time() - t0:.2f} s")
        row["scheme"] = proto.ctx.scheme_summary()

        t0 = time.time()
        qcts = proto.encrypt_query(query)
        _block(dev)
        row["query_enc_s"] = time.time() - t0
        row["query_cts"] = len(qcts)
        print(f"[Receiver] query encrypted: {row['query_enc_s']:.3f} s")

        t0 = time.time()
        mem = proto.membership(qcts)
        _block(dev)
        row["membership_s"] = time.time() - t0
        row["membership_cts"] = 1
        print(f"[Sender] membership scenario: {row['membership_s']:.3f} s")

        t0 = time.time()
        mem_result = proto.decrypt_membership(mem)
        row["membership_dec_s"] = time.time() - t0
        row["membership_result"] = mem_result
        print(f"[Receiver] membership decrypted: {mem_result}")

        t0 = time.time()
        idx = proto.index(qcts)
        _block(dev)
        row["index_s"] = time.time() - t0
        row["index_cts"] = len(idx)
        print(f"[Sender] index scenario: {row['index_s']:.3f} s")

        t0 = time.time()
        idx_result = proto.decrypt_index(idx)
        row["index_dec_s"] = time.time() - t0
        row["index_result"] = idx_result
        print(f"[Receiver] index decrypted: {idx_result}")

    if csv_path:
        newfile = not os.path.exists(csv_path)
        with open(csv_path, "a") as f:
            if newfile:
                f.write(CSV_HEADER)
            f.write(
                f"{row['approach']},{n},{row['query_enc_s']:.6f},{row['query_cts']},"
                f"{row['membership_s']:.6f},{row['membership_cts']},"
                f"{row['membership_dec_s']:.6f},{row['index_s']:.6f},"
                f"{row['index_cts']},{row['index_dec_s']:.6f},"
                f"{int(row['membership_result'])},"
                f"\"{' '.join(map(str, idx_result))}\"\n"
            )
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset")
    ap.add_argument("approach", type=int, choices=range(1, 6))
    ap.add_argument("--csv", default="latency.csv")
    ap.add_argument("--ring-dim", type=int, default=32768)
    ap.add_argument("--vector-dim", type=int, default=512)
    ap.add_argument("--scale-bits", type=int, default=30)
    ap.add_argument("--profile-dir", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    args = ap.parse_args()
    run(args.dataset, args.approach, args.csv, args.ring_dim, args.vector_dim,
        scale_bits=args.scale_bits, profile_dir=args.profile_dir, device=args.device)


if __name__ == "__main__":
    main()

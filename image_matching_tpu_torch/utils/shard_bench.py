"""Membership over a mesh of cards against the same shards on one card
and against one device, in one process, in turns.

    python3 -m image_matching_tpu_torch.utils.shard_bench [--log2n 20] [--shards 4] [--reps 3]

Sets up HyDia (approach 5) at production parameters with the streamed
store at 2^log2n vectors on cuda:0 (the derived device-memory budget),
then, --reps times, times one membership (host clock to a synchronize of
every card) single-device, over --shards shards on cuda:0, and over
cuda:0..k-1 (k = min(--shards, card count), when 2 or more cards exist),
checking each sharded membership bit-equal to the single-device one.  A
scenario that records per-card windows (issuing thread start, issue end,
card done) prints those of its last call.  It uses only the entry points
that the sharded scenarios have had since they were ported, so the same
file also measures an earlier tree of the package when copied into it.
"""

import argparse
import json
import subprocess
import sys
import time

import torch

from ..matching.config import MatchConfig
from ..matching.protocol import MatchingProtocol
from ..parallel import sharded
from .io import gen_dataset


def _timed(fn, cards):
    for c in range(cards):
        torch.cuda.synchronize(c)
    t = time.perf_counter()
    out = fn()
    for c in range(cards):
        torch.cuda.synchronize(c)
    return out, time.perf_counter() - t


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2n", type=int, default=20)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("shard_bench: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cards = torch.cuda.device_count()
    query, db = gen_dataset(1 << args.log2n, 512, seed=0)
    t = time.perf_counter()
    proto = MatchingProtocol.setup(5, db, MatchConfig(), seed=0, device="cuda:0", streamed=True)
    qcts = proto.encrypt_query(query)
    print(f"setup {time.perf_counter() - t:.1f} s", flush=True)
    single = proto.membership(qcts)
    assert proto.decrypt_membership(single) is True
    meshes = {f"{args.shards} shards on one card": ["cuda:0"] * args.shards}
    k = min(args.shards, cards)
    if k >= 2:
        meshes[f"{args.shards} shards on {k} cards"] = [
            f"cuda:{i % k}" for i in range(args.shards)]
    scens = {label: sharded.ShardedStreamedScenario(proto.sender, sharded.make_mesh(devices=d))
             for label, d in meshes.items()}
    times = {"single device": []}
    times.update({label: [] for label in scens})
    for label, scen in scens.items():  # first calls: warm-up of each mesh
        out, _ = _timed(lambda: scen.membership(qcts), cards)
        assert torch.equal(out.data.to("cuda:0"), single.data), f"{label}: not bit-equal"
    for _ in range(args.reps):
        times["single device"].append(_timed(lambda: proto.membership(qcts), cards)[1])
        for label, scen in scens.items():
            out, s = _timed(lambda: scen.membership(qcts), cards)
            assert torch.equal(out.data.to("cuda:0"), single.data), f"{label}: not bit-equal"
            times[label].append(s)
    print("membership seconds " + json.dumps(times), flush=True)
    for label, scen in scens.items():
        windows = getattr(scen, "windows", None)
        print(f"{label}: per-card windows of the last call "
              + (json.dumps(windows) if windows else "not recorded"), flush=True)


if __name__ == "__main__":
    main()

"""Where the time goes in the port's matching paths on one GPU.

    python3 -m image_matching_tpu_torch.utils.slice_profile [--approach 5] [--log2n 16] [--streamed]
        [--shards N]

Sets up HyDia (approach 5), HERS (--approach 4), Baseline (1), GROTE (2) or
Blind-Match (3) at production parameters (an in-memory DB, or for 4 and 5
with --streamed the seed-compressed store under the derived device-memory
budget) step by step, timing keygen, enrollment, rotation keys and the
query's encryption; times similarity, compare and the final EvalSum of
membership, plus whole membership and index calls, three times each after
a first call; then runs
torch.profiler over one membership and one similarity (and with --shards N
one membership of the sharded scenario over a mesh naming the card N
times) and reports device kernel time, busy share (kernel time over the
profiled wall time) and the time and launches of each hand-written kernel;
before that, the receiver's decryption of the membership, the index flags
and the scores (host clock up to the returned result), the index flags'
coefficients without the slots' decode (all at once, then one at a time)
and K9's MAC launches by shape, the launches of one membership by kernel and K1's launches by
row count (``NttPlan.rows_hist``), K4's, K7's and K11's launches by shape
(``kernels.shape_hist``), and digests of the membership ciphertext
and the index flags, which two trees that compute bit-equal results print
alike.  Each profile also counts the memory copies by kind (a pageable
host-to-device copy blocks the host until the stream drains).  After the
setup it prints the launches by shape of the encryption kernels (K6, the
streamed enrollment; K10, the in-memory enrollment and the query).
With --streamed a complete c0 cache of the same key (``IMTPU_STORE_DIR``,
default ``<repo>/.dbcache``; ``harness/enroll_cache.py`` writes one) is
loaded in place of the enrollment, and the store's progress lines go to
stderr.
Prints the summary and writes it with the profiler tables to --out.
"""

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from ..ckks.context import CkksContext
from ..ckks.params import SchemeParams, compute_required_depth
from ..matching import enrollers, protocol, receivers, senders, streaming
from ..matching.config import MatchConfig
from ..ops import kernels
from ..parallel import sharded
from .io import gen_dataset

OURS = ("ntt_rows_kernel", "ntt_cols_kernel", "ntt_kernel", "ct_dot_kernel",
        "ct_dot_seeded_kernel", "fbc_kernel", "ks_mac_kernel", "expand_c1_kernel",
        "seeded_pre_kernel", "seeded_c0_kernel", "rescale_lift_kernel", "sub_scale_kernel",
        "decompose_kernel", "tensor_kernel", "decrypt_mac_kernel", "pk_pre_kernel",
        "pk_mac_kernel", "modarith_kernel", "mod_sum_kernel", "psum_mod_kernel")


def timed(out, label, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    out[label] = time.perf_counter() - t
    return r


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def run(approach: int, log2n: int, streamed: bool, shards: int, say, log):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    say(f"{smi}; torch {torch.__version__}")
    cfg = MatchConfig()
    params = SchemeParams.create(
        mult_depth=compute_required_depth(approach, cfg.comp_depth, cfg.alpha_depth))
    query, db = gen_dataset(1 << log2n, cfg.vector_dim, seed=0)
    kernels.lib()
    kernels.shape_hist.clear()
    setup = {}
    ctx = timed(setup, "ctx_keygen_s", lambda: CkksContext(params, seed=0, device="cuda"))
    hers = approach == 4
    if streamed:
        enroll = streaming.enroll_hers_streamed if hers else streaming.enroll_diag_streamed
        store = timed(setup, "enroll_s", lambda: enroll(ctx, cfg, db, verbose=True))
        sender = (streaming.StreamedHersSender if hers else streaming.StreamedDiagonalSender)(
            ctx, cfg, store)
        say(f"store: {store.num_groups} groups, {store.resident_count()} resident, "
            f"{store.host_count()} in host memory")
    else:
        enroll = getattr(enrollers, protocol.ENROLLERS[approach])
        sender = senders.make_sender(approach, ctx, cfg,
                                     timed(setup, "enroll_s", lambda: enroll(ctx, cfg, db)))
    receiver = receivers.make_receiver(approach, ctx, cfg, db.shape[0])
    timed(setup, "pow2_keys_s", ctx.gen_power_of_two_rotation_keys)
    timed(setup, "sender_keys_s",
          lambda: ctx.gen_rotation_keys(sender.required_rotations(), force=True))
    qcts = timed(setup, "encrypt_query_s", lambda: receiver.encrypt_query(query))
    enc = sorted(kernels.shape_hist.items(), key=lambda kv: -kv[1])
    say("setup and query encryption: K6 and K10 launches by (pass, B, l, k, form) "
        + json.dumps([[list(k), v] for k, v in enc]))
    timed(setup, "first_membership_s", lambda: sender.run_membership(qcts))
    say("setup " + json.dumps(setup))
    for rep in range(3):
        r = {}
        scores = timed(r, "similarity_s", lambda: sender.compute_similarity(qcts))
        flags = timed(r, "compare_s", lambda: sender._compare_many(scores))
        out = timed(r, "reduce_s", lambda: sender._membership_reduce(flags))
        timed(r, "membership_s", lambda: sender.run_membership(qcts))
        timed(r, "index_s", lambda: sender.run_index(qcts))
        say(f"rep {rep} " + json.dumps(r))
    flags = sender.run_index(qcts)
    scores = sender.compute_similarity(qcts)
    # the receiver's decryption, each on the host clock up to its result
    kernels.shape_hist.clear()
    dec = {}
    member = timed(dec, "decrypt_membership_s", lambda: receiver.decrypt_membership(out))
    found = timed(dec, "decrypt_index_s", lambda: receiver.decrypt_index(flags))
    timed(dec, "decrypt_scores_s", lambda: receiver.decrypt_scores(scores))
    del scores
    say("decryption: K9 MAC launches by (pass, B, l, k, form) " + json.dumps(
        [[list(k), v] for k, v in sorted(kernels.shape_hist.items(), key=lambda kv: -kv[1])]))
    # the index's coefficients without the slots' decode: the flags at once
    # (MAC, K1, one copy, the CRT on the host), then one at a time
    timed(dec, "index_coeffs_s", lambda: ctx._decrypt_many(flags))
    timed(dec, "index_coeffs_one_by_one_s", lambda: [ctx.decrypt_coeffs(f) for f in flags])
    say(f"membership decrypts to {member}; index {found[:10]} ({len(found)} found); "
        "receiver " + json.dumps(dec))
    say(f"sha256 of the membership ciphertext {_digest(out.data)}, of the index flags "
        f"{_digest(torch.cat([f.data.flatten() for f in flags]))} (equal across trees: "
        "bit-equal)")
    hist = ctx.plan.rows_hist
    hist.clear()
    kernels.shape_hist.clear()
    before = kernels.counts()
    timed({}, "membership_s", lambda: sender.run_membership(qcts))
    launched = {k: v - before[k] for k, v in kernels.counts().items() if v > before[k]}
    say(f"one membership: {sum(launched.values())} kernel launches {json.dumps(launched)}; "
        f"K1 launches by rows {json.dumps(dict(sorted(hist.items())))}")
    shapes = sorted(kernels.shape_hist.items(), key=lambda kv: -kv[1])
    say("one membership: K4, K7 and K11 launches by (pass, B, l, k, form) "
        + json.dumps([[list(k), v] for k, v in shapes]))

    profiled = [("membership", lambda: sender.run_membership(qcts)),
                ("similarity", lambda: sender.compute_similarity(qcts))]
    if shards:
        scen = (sharded.ShardedStreamedScenario if streamed else sharded.ShardedScenario)(
            sender, sharded.make_mesh(devices=[ctx.device] * shards))
        label = f"membership over {shards} shards"
        for rep in range(3):
            r = {}
            sm = timed(r, f"{label}_s", lambda: scen.membership(qcts))
            say(f"rep {rep} " + json.dumps(r))
        same = torch.equal(sm.data, out.data)
        say(f"{label} decrypts to {receiver.decrypt_membership(sm)}; bit-equal to one "
            f"device: {same}")
        profiled.append((label, lambda: scen.membership(qcts)))
    for label, fn in profiled:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        ka = prof.key_averages()
        dev = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
        copies = {e.key: e.count for e in ka if "Memcpy" in e.key}
        busy = sum(e.self_device_time_total for e in dev) / 1e6
        ours = {k: (sum(e.self_device_time_total for e in dev if k in e.key) / 1e6,
                    sum(e.count for e in dev if k in e.key)) for k in OURS}
        say(f"[{label}] profiled wall {wall:.4f} s, device kernel time {busy:.4f} s, "
            f"busy share {busy / wall:.3f}, kernel launches {sum(e.count for e in dev)}, "
            f"(seconds, launches) of ours {json.dumps(ours)}; memory copies by kind "
            f"{json.dumps(copies)}")
        log.write(ka.table(sort_by="self_cuda_time_total", row_limit=30,
                           max_name_column_width=60) + "\n")
    say(f"peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--approach", type=int, choices=(1, 2, 3, 4, 5), default=5,
                    help="1 Baseline, 2 GROTE, 3 Blind-Match, 4 HERS, 5 HyDia")
    ap.add_argument("--log2n", type=int, default=16, help="gallery size 2^log2n")
    ap.add_argument("--streamed", action="store_true",
                    help="serve the gallery from the streamed, seed-compressed store")
    ap.add_argument("--shards", type=int, default=0,
                    help="also profile one membership sharded over this many shards on the card")
    ap.add_argument("--out", default="build/slice_profile.log")
    args = ap.parse_args()
    if args.streamed and args.approach not in (4, 5):
        ap.error("--streamed serves approaches 4 and 5 only")
    if not torch.cuda.is_available():
        sys.exit("slice_profile: needs a CUDA device")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as log:
        def say(msg):
            print(msg, flush=True)
            log.write(msg + "\n")

        run(args.approach, args.log2n, args.streamed, args.shards, say, log)


if __name__ == "__main__":
    main()

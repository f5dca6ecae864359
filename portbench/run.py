"""One run of one cell of the port's benchmark (``BENCHMARK.json``).

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run makes its gallery and query pool
from the seed, sets the port up through ``MatchingProtocol.setup(...,
streamed=True)``, checks the configuration's guarantees against the port's
context, encrypts the pool, warms up on the mix's own sequence of requests
until the device's allocator has settled, serves the mix for
``--seconds``, then checks the answers that the timed requests returned
against the plain reference (``portbench/reference``)
and prints one JSON line: ``correct``, ``attempted``, ``failed``,
``metrics`` (the end-to-end metrics, or with ``--trace 1`` the per-layer
metrics read from a profiled slice of the window), ``device``,
``breakdown`` with ``--trace 1``, and ``check``, the numbers compared
beside their limits, which also end standard error.

It exits with another code than 0, and prints no result, where no CUDA
device is available (2), where the window leaves ``jax``, ``jaxlib``,
``flax`` or ``image_matching_tpu`` loaded (3), where the port departs
from a stated guarantee (4), and on any error (1).  ``--device cpu`` and
``--benchmark`` are for the CPU rehearsals of ``portbench/tests``.

End-to-end metrics: ``setup_s``, ``queries_per_s`` (requests completed
over the window's seconds) and ``<kind>_p<q>_s``, the q-th percentile of
the latency of every request of that kind completed in the window.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from . import bench, check, stats, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "image_matching_tpu")
COMPARE_RANGE = "portbench.compare"
PERCENTILE = re.compile(r"^(\w+?)_p(\d+)_s$")


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is a forbidden one."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_environment(root: Path) -> None:
    """No on-disk enrollment caches (``IMTPU_STORE_DIR=""``: no gallery
    fingerprint, nothing written or read); compile caches at fixed paths
    inside the checkout.  The port's kernel library builds into
    ``build/imtpu_torch/`` of the checkout by itself."""
    os.environ["IMTPU_STORE_DIR"] = ""
    cache = root / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


class Outbox:
    """Where answers land in host memory: kept answers (a reservoir sample
    of each kind's answers, drawn from the seed, ``keep[kind]`` of them)
    each in a slot of their own, the others in one scratch buffer a kind.
    Buffers are page-locked on CUDA and made at a kind's first answer."""

    def __init__(self, keep: Dict[str, int], seed: int, pin: bool):
        self.keep, self.pin = keep, pin
        self.rng = random.Random(seed)
        self.seen: Dict[str, int] = defaultdict(int)
        self.scratch: Dict[str, object] = {}
        self.slots: Dict[str, list] = {}
        self.kept: Dict[str, list] = {}

    def _alloc(self, kind: str, like):
        import torch

        def one():
            return torch.empty(like.shape, dtype=like.dtype, pin_memory=self.pin)
        self.scratch[kind] = one()
        self.slots[kind] = [one() for _ in range(self.keep.get(kind, 0))]
        self.kept[kind] = [None] * len(self.slots[kind])

    def take(self, kind: str, like, record: Optional[dict]):
        """The buffer for an answer shaped as ``like``; ``record`` (None:
        a warm-up answer, never kept) describes it if it is kept."""
        if kind not in self.scratch:
            self._alloc(kind, like)
        if record is None:
            return self.scratch[kind]
        i = self.seen[kind]
        self.seen[kind] += 1
        k = len(self.slots[kind])
        j = i if i < k else self.rng.randrange(i + 1)
        if j >= k:
            return self.scratch[kind]
        self.kept[kind][j] = record
        return self.slots[kind][j]

    def answers(self):
        """(record, host buffer) of every kept answer."""
        for kind, recs in self.kept.items():
            for rec, buf in zip(recs, self.slots[kind]):
                if rec is not None:
                    yield rec, buf


class Server:
    """The served side of a request: the query's ciphertexts copied from
    the host receive buffer to the card, ``MatchingProtocol.membership`` or
    ``.index``, the answer's ciphertexts copied back to host memory."""

    def __init__(self, proto, pool, scales, device, outbox: Outbox):
        self.proto, self.pool, self.scales = proto, pool, scales
        self.device, self.outbox = device, outbox
        self.warm = True

    def request(self, kind: str, q: int):
        import torch
        from torch.profiler import record_function

        from image_matching_tpu_torch.ckks.context import Ciphertext

        with record_function("portbench.h2d"):
            data = self.pool[q].to(self.device, non_blocking=True)
        cts = [Ciphertext(data[i], self.scales[q]) for i in range(data.shape[0])]
        with record_function("portbench.serve"):
            if kind == "membership":
                ans = self.proto.membership(cts)
                out, scales = ans.data, [ans.scale]
            elif kind == "index":
                ans = self.proto.index(cts)
                out, scales = torch.stack([c.data for c in ans]), [c.scale for c in ans]
            else:
                raise ValueError(f"unknown request kind {kind!r}")
        with record_function("portbench.d2h"):
            rec = None if self.warm else {"kind": kind, "query": q, "scales": scales}
            self.outbox.take(kind, out, rec).copy_(out, non_blocking=True)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()


class Untraced:
    def before(self, r):
        pass

    def after(self, r):
        pass

    def pending(self) -> bool:
        return False


class Traced:
    """Profiles requests ``skip`` to ``skip + requests - 1`` of the window
    with ``torch.profiler`` (host and CUDA), inside a ``portbench.slice``
    range, each request in a ``portbench.request`` range, the sender's
    compare circuit in ``portbench.compare`` ranges, and K1's launches
    counted by (rows, limbs) beside the program's ``NttPlan.rows_hist``."""

    def __init__(self, proto, spec: dict, device):
        import torch
        from torch.profiler import ProfilerActivity

        self.proto, self.device = proto, device
        self.skip, self.n = spec["skip"], spec["requests"]
        self.activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            self.activities.append(ProfilerActivity.CUDA)
        self.prof = None
        self.done = False
        self.ranges = []
        self.ntt = defaultdict(int)
        self.rows_before: Dict[int, int] = {}
        self.rows_hist: Dict[int, int] = {}
        sender = proto.sender
        compare = sender._compare_many

        def traced_compare(scores):
            with torch.profiler.record_function(COMPARE_RANGE):
                return compare(scores)
        sender._compare_many = traced_compare

    def _count_ntt(self, on: bool):
        plan = self.proto.ctx.plan
        if not on:
            del plan._launch  # the class's method again
            return
        launch = plan._launch

        def counted(a, limbs, inverse, perm):
            self.ntt[(a.numel() // a.shape[-1], a.shape[-2])] += 1
            return launch(a, limbs, inverse, perm)
        plan._launch = counted

    def before(self, r):
        from torch.profiler import profile, record_function

        if r == self.skip:
            self.prof = profile(activities=self.activities)
            self.prof.__enter__()
            self.ranges.append(record_function(trace.SLICE).__enter__())
            self.rows_before = dict(self.proto.ctx.plan.rows_hist)
            self._count_ntt(True)
        if self.prof is not None and not self.done:
            self.ranges.append(record_function("portbench.request").__enter__())

    def after(self, r):
        if self.prof is None or self.done:
            return
        self.ranges.pop().__exit__(None, None, None)
        if r == self.skip + self.n - 1:
            self._count_ntt(False)
            hist = self.proto.ctx.plan.rows_hist
            self.rows_hist = {k: v - self.rows_before.get(k, 0) for k, v in hist.items()
                              if v > self.rows_before.get(k, 0)}
            self.ranges.pop().__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            self.done = True

    def pending(self) -> bool:
        return not self.done


class Watch:
    """What the window did beside serving, for the record on standard
    error: the CUDA caching allocator's device allocations, frees and
    retries in it (an allocation there is warm-up the set-up missed), and
    every request's latency."""

    STATS = ("num_alloc_retries", "num_device_alloc", "num_device_free",
             "num_sync_all_streams")

    def __init__(self, device):
        self.device = device
        self.mem0 = self._mem()

    def allocations(self) -> int:
        return self._mem()["num_device_alloc"]

    def _mem(self):
        import torch
        if self.device.type != "cuda":
            return {}
        st = torch.cuda.memory_stats(self.device)
        return {k: st.get(k, 0) for k in self.STATS}

    def report(self, done):
        mem = {k: v - self.mem0.get(k, 0) for k, v in self._mem().items()}
        say(f"# window allocator: {mem}")
        say("# latencies ms: " + " ".join(f"{d.kind[0]}{d.latency * 1e3:.1f}" for d in done))


def card(device) -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def setup(cell: bench.Cell, seed: int, device):
    """Everything before the window: the kernel library, the data, the
    protocol and its keys, the guarantees, the encrypted pool, the
    warm-up.  -> (server, data)"""
    import torch

    from image_matching_tpu_torch.ckks.params import SchemeParams, compute_required_depth
    from image_matching_tpu_torch.matching.config import MatchConfig
    from image_matching_tpu_torch.matching.protocol import MatchingProtocol
    from image_matching_tpu_torch.matching.streaming import _StreamedSender
    from image_matching_tpu_torch.ops import kernels

    from . import data as datamod

    g = cell.config["guarantees"]
    if device.type == "cuda":
        t = time.perf_counter()
        kernels.lib()
        say(f"# kernel library ready in {time.perf_counter() - t:.1f} s "
            f"(built in this process: {kernels.build_seconds is not None})")
    t = time.perf_counter()
    data = datamod.make(cell.config, cell.traffic["pool"], seed, device)
    say(f"# data: gallery {tuple(data.gallery.shape)}, pool of {data.queries.shape[0]} "
        f"({int(data.is_match.sum())} matches) in {time.perf_counter() - t:.1f} s")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cfg = MatchConfig(vector_dim=g["vector_dim"], chunk_len=g["chunk_len"],
                      match_threshold=g["match_threshold"], comp_depth=g["comp_depth"])
    params = SchemeParams.create(
        ring_dim=g["ring_dim"], mult_depth=compute_required_depth(g["approach"], g["comp_depth"]),
        scale_bits=g["scale_bits"], first_mod_bits=g["first_mod_bits"], dnum=g["dnum"],
        security=g["security"], sigma=g["sigma"])
    t = time.perf_counter()
    proto = MatchingProtocol.setup(g["approach"], data.gallery.numpy(), cfg, params,
                                   seed=seed % (1 << 63), device=device,
                                   streamed=g["streamed"])
    say(f"# protocol set up (keys, enrollment, rotation keys) in "
        f"{time.perf_counter() - t:.1f} s")
    p, store = proto.ctx.params, getattr(proto.sender, "store", None)
    found = {
        "approach": proto.approach, "streamed": isinstance(proto.sender, _StreamedSender),
        "gallery_vectors": proto.sender.num_vectors, "ring_dim": p.ring_dim,
        "vector_dim": proto.cfg.vector_dim, "match_threshold": proto.cfg.match_threshold,
        "comp_depth": proto.cfg.comp_depth, "chunk_len": proto.cfg.chunk_len,
        "scale_bits": p.scale_bits, "first_mod_bits": p.first_mod_bits, "dnum": p.dnum,
        "security": p.security, "sigma": p.sigma, "q_limbs": p.num_limbs,
        "special_limbs": p.num_special,
        "resident_groups": store.resident_count() if store else None,
        "host_groups": store.host_count() if store else None,
    }
    logqp = sum(math.log2(q) for q in p.q_primes + p.sp_primes)
    say("# guarantees read back from the port: " + json.dumps(found)
        + f"; log2(QP) {logqp:.1f}")
    off = {k: (v, found.get(k)) for k, v in g.items() if found.get(k) != v}
    if off:
        say(f"portbench: the port departs from the configuration's guarantees "
            f"(stated, found): {off}")
        raise SystemExit(4)
    t = time.perf_counter()
    pin = device.type == "cuda"
    pool, scales = [], []
    for q in data.queries.numpy():
        cts = proto.encrypt_query(q)
        stacked = torch.stack([c.data for c in cts])
        host = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=pin)
        host.copy_(stacked)
        pool.append(host)
        scales.append(cts[0].scale)
        del cts, stacked
    say(f"# pool encrypted: {len(pool)} queries of {pool[0].shape[0]} ciphertexts "
        f"({pool[0].numel() * 4 / 1e6:.1f} MB each) in {time.perf_counter() - t:.1f} s")
    keep = cell.config["check"]["keep"]
    server = Server(proto, pool, scales, device, Outbox(keep, seed, pin))
    t = time.perf_counter()
    made = cell.driver.warm_up(server, cell.traffic,
                               Watch(device).allocations if device.type == "cuda" else None)
    server.warm = False
    say(f"# warm-up: {len(made)} requests in {time.perf_counter() - t:.1f} s, "
        f"{sum(made)} device allocations; by request: {' '.join(map(str, made))}")
    return server, data


def end_to_end(name: str, setup_s: float, window_s: float, done) -> float:
    """An end-to-end metric's value over the window's requests ``done``."""
    if name == "setup_s":
        return setup_s
    if name == "queries_per_s":
        return stats.rate(len(done), window_s)
    m = PERCENTILE.match(name)
    if m is None:
        raise KeyError(f"no end-to-end metric {name!r}")
    kind, q = m.group(1), int(m.group(2))
    return stats.percentile([d.latency for d in done if d.kind == kind], q)


def untraced_s(done, skip: int, n: int) -> Optional[float]:
    """The seconds that the traced requests ``skip`` to ``skip + n - 1``
    take untraced: for each, the mean latency of the window's untraced
    requests of its kind.  None where a kind has no untraced request."""
    by = defaultdict(list)
    for d in done:
        if not skip <= d.r < skip + n:
            by[d.kind].append(d.latency)
    inside = [d.kind for d in done if skip <= d.r < skip + n]
    if not inside or any(not by[k] for k in inside):
        return None
    return sum(sum(by[k]) / len(by[k]) for k in inside)


def run(args, cell: Optional[bench.Cell] = None) -> int:
    """One run of ``args.workload`` (or of ``cell``, where given)."""
    import torch

    if cell is None:
        cell = bench.load(args.workload, Path(args.benchmark))
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            say(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
                f"available: {torch.cuda.is_available()}, "
                f"count {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    say(f"# {cell.name} seed {args.seed} seconds {args.seconds} trace {args.trace}; "
        f"{card(device)}; torch {torch.__version__}")
    server, data = setup(cell, args.seed, device)

    from image_matching_tpu_torch.ops import kernels

    hooks = Traced(server.proto, cell.traffic["trace"], device) if args.trace else Untraced()
    counts0 = kernels.counts()
    watch = Watch(device)
    setup_s = time.perf_counter() - T_START
    t0, done = cell.driver.serve(server, cell.traffic, args.seconds, hooks)
    window_s = done[-1].arrived - t0
    counts = {k: v - counts0[k] for k, v in kernels.counts().items() if v > counts0[k]}
    watch.report(done)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    bad = forbidden_modules()
    if bad:
        say(f"portbench: the window left {bad} loaded")
        return 3
    lat = [d.latency for d in done]
    say(f"# window: {len(done)} requests in {window_s:.3f} s; latency s min "
        f"{min(lat):.4f} median {stats.percentile(lat, 50):.4f} p90 "
        f"{stats.percentile(lat, 90):.4f} max {max(lat):.4f}; kernel launches "
        f"{sum(counts.values())}; peak device memory {peak} B")
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": peak}
    metrics, breakdown = {}, None
    if args.trace:
        sl = trace.from_profiler(
            hooks.prof, requests=hooks.n, counts=counts, window_requests=len(done),
            ntt_launches=dict(hooks.ntt), ntt_rows_hist=hooks.rows_hist,
            ring_dim=cell.config["guarantees"]["ring_dim"],
            untraced_s=untraced_s(done, hooks.skip, hooks.n))
        for m in cell.per_layer:
            v = m.read(sl)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
        dev_info["busy_s"] = sl.busy_s
        dev_info["window_s"] = sl.window_s
        breakdown = {"device_ops": sl.device_ops(), "idle_gaps": sl.idle_gaps()}
        linked = sum(1 for o in sl.ops if o.launch is not None)
        say(f"# traced slice: {sl.requests} requests, {sl.window_s:.4f} s, device busy "
            f"{sl.busy_s:.4f} s, {linked} of {len(sl.ops)} device operations linked to "
            f"their launch; per layer {json.dumps(metrics)}")
    else:
        metrics = {m.name: {"value": end_to_end(m.name, setup_s, window_s, done),
                            "unit": m.unit} for m in cell.end_to_end}
    hooks = None  # the traced hooks hold the protocol: freed with it
    numbers, each = finish(server, data, cell, device)
    lim = cell.config["check"]["limits"]
    correct = all(numbers[k] <= lim[k] for k in lim)
    bad = forbidden_modules()
    if bad:
        say(f"portbench: the run left {bad} loaded")
        return 3
    result = {"correct": correct, "attempted": len(done), "failed": check.failed(each, lim),
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: {"value": numbers[k], "limit": lim[k]} for k in lim}
    for k in lim:
        say(f"check {k} {numbers[k]!r} limit {lim[k]!r}")
    print(json.dumps(result), flush=True)
    return 0


def finish(server: Server, data, cell, device):
    """After the window: the kept answers decrypted by the client's side of
    the port, the program's state freed, then the plain reference worked
    out from the run's own data, and the numbers compared.  -> the
    numbers, and (number, gap) of each kept answer."""
    import numpy as np
    import torch

    from image_matching_tpu_torch.ckks.context import Ciphertext
    from image_matching_tpu_torch.matching.receivers import decrypt_all

    from .reference.matching import Answers

    t = time.perf_counter()
    ctx = server.proto.ctx
    read = []
    for rec, buf in server.outbox.answers():
        d = buf.to(device)
        if rec["kind"] == "index":
            cts = [Ciphertext(d[i], s) for i, s in enumerate(rec["scales"])]
        else:
            cts = [Ciphertext(d, rec["scales"][0])]
        vals = np.concatenate(decrypt_all(ctx, cts))
        read.append((rec["kind"], rec["query"], torch.from_numpy(vals)))
    slots = ctx.slots
    server.proto = ctx = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    g = cell.config["guarantees"]
    ref = Answers(data.gallery.to(device), data.queries.to(device), g["match_threshold"],
                  g["comp_depth"])
    numbers, each = check.gaps(read, ref, slots)
    say(f"# check: {sum(1 for r in read if r[0] == 'membership')} memberships and "
        f"{sum(1 for r in read if r[0] == 'index')} indexes decrypted in {t1 - t:.1f} s, "
        f"reference in {time.perf_counter() - t1:.1f} s")
    return numbers, each


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--benchmark", default=str(bench.ROOT / "BENCHMARK.json"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    set_environment(bench.ROOT)
    return run(args)


if __name__ == "__main__":
    sys.exit(main())

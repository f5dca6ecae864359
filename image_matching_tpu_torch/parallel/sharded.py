"""Multi-device execution: the encrypted DB's group axis sharded over a
mesh of devices (port of image_matching_tpu/parallel/sharded.py).

Each shard holds a contiguous block of the DB's groups (or, streamed, owns
a contiguous block of the store's group ids), computes its scores and
compare flags on its own device with a replica of the context, and the
membership reduction is a modular sum of the shards' flags on the root
device, ``mesh.devices[0]``, followed by EvalSum there.  The modular sum
is kernel K12 (``csrc/psum_mod.cu``) for CUDA tensors and
``psum_mod_plain`` for CPU tensors; partials on another card are copied
to the root first (over NVLink where the cards can reach each other's
memory, else through the host), and a mesh whose process group spans
several processes gathers the per-process sums with
``torch.distributed.all_gather`` and reduces them once more.

A mesh is a list of devices and may name one device several times: on
one card, ``make_mesh(devices=["cuda:0"] * 4)`` runs four shards one
after another with the partition, padding and reduction of four devices.
Shards that share a device share one context replica and one issuing
thread; each distinct device has its own thread (``per_device``), so the
cards work at once.

The sum of canonical residues mod q does not depend on the order or the
grouping of its terms, and the compare circuit works on each score on its
own, so the sharded membership ciphertext equals the single-device one
residue for residue wherever the padding adds nothing: always in the
streamed scenario, whose padding flags are exact zeros, and in memory
when the shard count divides the group count.  In memory, as in the JAX
package, the padding groups' flags are ~0 and are summed.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..ckks.context import Ciphertext, CkksContext
from ..matching import senders, streaming
from ..ops import kernels
from ..ops import modmath as mm

# the route of each card-to-card copy of a partial sum: "peer" (direct,
# over NVLink where present) or "host" (through host memory)
copy_routes = {"peer": 0, "host": 0}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One device per shard (a device may repeat) and, for a mesh spread
    over several processes, the process group joining them."""

    devices: Tuple[torch.device, ...]
    group: Optional[Any] = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def root(self) -> torch.device:
        return self.devices[0]

    def distinct(self) -> List[torch.device]:
        return list(dict.fromkeys(self.devices))


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None,
              group: Optional[Any] = None) -> Mesh:
    """A mesh over ``devices`` (repeats allowed), or over the first
    ``n_devices`` CUDA devices (all of them by default).  A device that is
    missing raises: the mesh never falls back to the CPU."""
    if devices is None:
        kernels.resolve_device("cuda")  # raises without a GPU
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if not 1 <= n <= count:
            raise ValueError(f"make_mesh: {n} devices asked for, {count} CUDA device(s) present")
        devices = [f"cuda:{i}" for i in range(n)]
    elif n_devices is not None and n_devices != len(devices):
        raise ValueError(f"make_mesh: n_devices={n_devices} but {len(devices)} devices given")
    if not devices:
        raise ValueError("make_mesh: no devices")
    return Mesh(tuple(kernels.canonical_device(d) for d in devices), group)


def psum_mod_plain(parts: Sequence[torch.Tensor], q: torch.Tensor) -> torch.Tensor:
    """Plain version of K12: the sum over every row of every part
    ([R_p, ..., l, N] each) taken in int64, then ``% q`` (int64 [l, 1])."""
    acc = None
    for p in parts:
        s = p.long().sum(0)
        acc = s if acc is None else acc + s
    return (acc % q).int()


PSUM_CAP = 64  # buffers a K12 launch takes (csrc/psum_mod.cu K12_CAP)


@functools.lru_cache(maxsize=None)
def _limb_consts(primes: Tuple[int, ...]):
    """K12's per-limb constants as a host array (uint32 [4, l]): q,
    -q^-1 mod 2^32, R mod q and R^2 mod q."""
    cs = [mm.host_mont_constants(q) for q in primes]
    vals = list(primes) + [c[0] for c in cs] + [c[1] for c in cs] + [c[2] for c in cs]
    return (ctypes.c_uint32 * len(vals))(*vals)


def psum_mod_kernel(parts: Sequence[torch.Tensor], primes: Sequence[int]) -> torch.Tensor:
    """K12: the sum mod q of every row of every part, all on one CUDA
    device, each part [R_p, ..., l, N] contiguous, read in place -> [..., l,
    N].  The parts' addresses and row counts go to the kernel by value, no
    device table and no host sync; a list of more than ``PSUM_CAP`` parts
    is summed in chunks, each chunk's sum one more one-row part."""
    block = tuple(parts[0].shape[1:])
    l, n = block[-2], block[-1]
    if len(primes) != l or any(tuple(p.shape[1:]) != block for p in parts):
        raise ValueError(f"psum_mod: parts {[tuple(p.shape) for p in parts]} "
                         f"over {len(primes)} limbs")
    kernels.check_cuda("psum_mod", *parts)
    consts = _limb_consts(tuple(int(q) for q in primes))

    def launch(ps):
        out = torch.empty(block, dtype=torch.int32, device=ps[0].device)
        addrs = (ctypes.c_int64 * len(ps))(*[p.data_ptr() for p in ps])
        rows = (ctypes.c_int64 * len(ps))(*[p.shape[0] for p in ps])
        kernels.launch("imtpu_psum_mod", "psum_mod", out, ctypes.addressof(addrs),
                       ctypes.addressof(rows), len(ps), out.numel(), l, n,
                       ctypes.addressof(consts))
        return out
    parts = list(parts)
    while len(parts) > PSUM_CAP:  # the head's sum joins the rest as one more row
        parts = parts[PSUM_CAP:] + [launch(parts[:PSUM_CAP])[None]]
    return launch(parts)


_side_streams: Dict[torch.device, Any] = {}


def copy_to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A copy of CUDA tensor t on another CUDA device, made on a side
    stream of that device: after the work queued on t's device, before
    the work queued next on either device.  Direct where the destination
    can reach t's memory (peer access, NVLink), else through the host."""
    src = t.device
    peer = torch.cuda.can_device_access_peer(device.index, src.index)
    copy_routes["peer" if peer else "host"] += 1
    side = _side_streams.get(device)
    if side is None:
        side = _side_streams[device] = torch.cuda.Stream(device)
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(src))
    side.wait_event(ready)
    side.wait_stream(torch.cuda.current_stream(device))  # out's memory may be in use there
    with torch.cuda.stream(side):
        out.copy_(t if peer else t.cpu(), non_blocking=peer)
    done = torch.cuda.Event()
    done.record(side)
    torch.cuda.current_stream(device).wait_event(done)
    torch.cuda.current_stream(src).wait_event(done)  # t is not reused before it is read
    return out


def psum_mod(parts: Sequence[torch.Tensor], primes: Sequence[int], out_device,
             group: Optional[Any] = None) -> torch.Tensor:
    """Modular all-reduce of shard partials: ``parts`` [R_p, ..., l, N]
    (R_p rows each, e.g. a shard's local flags) of residues mod the limbs'
    ``primes``, on any devices -> their sum mod q, [..., l, N], on
    ``out_device``.  On CUDA, each other device's parts are summed there
    (K12) and copied over; K12 then sums the parts on ``out_device`` and
    the copied partials in one launch.  CPU parts take ``psum_mod_plain``.
    Where ``group`` spans several processes, every process's sum is
    gathered (``all_gather``: NCCL on CUDA, gloo on the CPU) and reduced
    once more, so every process holds the total."""
    out_dev = kernels.canonical_device(out_device)
    if out_dev.type == "cpu":
        if any(p.is_cuda for p in parts):
            raise ValueError("psum_mod: CUDA parts need a CUDA out_device")
        q = torch.tensor(primes, dtype=torch.int64)[:, None]
        reduce = lambda ps: psum_mod_plain(ps, q)  # noqa: E731
        total = reduce(parts)
    else:
        reduce = lambda ps: psum_mod_kernel(ps, primes)  # noqa: E731
        by_dev: Dict[torch.device, List[torch.Tensor]] = {}
        for p in parts:
            by_dev.setdefault(kernels.canonical_device(p.device), []).append(p.contiguous())
        local = by_dev.pop(out_dev, [])
        for ps in by_dev.values():
            partial = ps[0] if len(ps) == 1 and ps[0].shape[0] == 1 else reduce(ps)[None]
            local.append(copy_to_device(partial, out_dev))
        total = reduce(local)
    if group is not None:
        import torch.distributed as dist

        world = dist.get_world_size(group)
        if world > 1:
            gathered = [torch.empty_like(total) for _ in range(world)]
            dist.all_gather(gathered, total, group=group)
            total = reduce([g[None] for g in gathered])
    return total


def _replicas(ctx: CkksContext, mesh: Mesh) -> Dict[torch.device, CkksContext]:
    return {dev: ctx.replica(dev) for dev in mesh.distinct()}


def per_device(devices: Sequence[torch.device], fn: Callable[[torch.device], Any],
               windows: Optional[Dict[str, Dict[str, float]]] = None) -> Dict[torch.device, Any]:
    """{dev: fn(dev)} for each distinct device.  One device runs fn on the
    calling thread.  Several each get an issuing thread of their own (ctypes
    launches and torch's device ops release the interpreter lock), with
    their device current: the JAX package runs its shards as one program
    over every device at once.  The kernel library is loaded before the
    threads start; each device's replica, its caches and its streams are
    touched by its own thread only.  A worker's exception is raised here,
    after every worker has ended.  With ``windows`` each device's work is
    timed on the host clock from the call's start: when its thread began
    issuing, when it had issued everything and when its card had run it
    (the thread waits for its card there), keyed by the device's name."""
    devices = list(dict.fromkeys(devices))
    if len(devices) == 1:
        return {devices[0]: fn(devices[0])}
    if any(d.type == "cuda" for d in devices):
        kernels.lib()
    t0 = time.perf_counter()

    def work(dev):
        ctx = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        with ctx:
            start = time.perf_counter()
            out = fn(dev)
            issued = time.perf_counter()
            if windows is not None:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                windows[str(dev)] = {"issue_start_s": start - t0, "issue_end_s": issued - t0,
                                     "done_s": time.perf_counter() - t0}
        return out

    with ThreadPoolExecutor(max_workers=len(devices)) as ex:
        futs = {dev: ex.submit(work, dev) for dev in devices}
    return {dev: f.result() for dev, f in futs.items()}


def _moved(cts: Sequence[Ciphertext], device: torch.device) -> List[Ciphertext]:
    return [Ciphertext(c.data.to(device), c.scale) for c in cts]


def _reduce_flags(ctx: CkksContext, stacks: List[torch.Tensor], scale: float,
                  group: Optional[Any]) -> Ciphertext:
    """Membership on the root: the modular sum of the shards' flag stacks
    [R_d, 2, l, N], then EvalSum over the slots."""
    l = stacks[0].shape[-2]
    summed = psum_mod(stacks, ctx.all_primes[:l], ctx.device, group)
    return ctx.eval_sum(Ciphertext(summed, scale), ctx.slots)


def _check_scales(ctx: CkksContext, flags: Sequence[Ciphertext]) -> float:
    for f in flags[1:]:
        ctx._check_scales(flags[0].scale, f.scale)
    return flags[0].scale


class ShardedScenario:
    """A sender's membership and index scenarios with its in-memory DB's
    group axis (``db.data`` axis 0) sharded over a mesh.  Works for the
    diagonal (HyDia) and HERS layouts, whose groups are independent; for
    Baseline and Blind-Match index decoding each shard's scores must pack
    into whole ciphertexts, and GROTE's group testing is global (the JAX
    module's scope).

    A group count that the shard count does not divide is padded at the
    end with all-zero groups: a zero ciphertext is a valid encryption of 0,
    its scores sit far below the threshold, its flags are ~0, and its slot
    positions lie past num_vectors, which receivers already filter.  The
    blocks are placed on their devices once, here; a block lying whole on
    its device is a view, not a copy.  The sender is not modified: each
    shard computes through a shallow view of it."""

    def __init__(self, sender: senders.Sender, mesh: Mesh):
        self.sender, self.mesh = sender, mesh
        self.ctxs = _replicas(sender.ctx, mesh)
        data = sender.db.data
        G, n = data.shape[0], mesh.size
        self.per = -(-G // n)
        self.shards: List[senders.Sender] = []
        for d, dev in enumerate(mesh.devices):
            lo, hi = min(d * self.per, G), min((d + 1) * self.per, G)
            block = data[lo:hi]
            if hi - lo < self.per:
                pad = torch.zeros((self.per - (hi - lo),) + tuple(data.shape[1:]),
                                  dtype=data.dtype, device=data.device)
                block = torch.cat([block, pad])
            self.shards.append(senders.shard_view(sender, self.ctxs[dev], block.to(dev)))

    def _flags(self, query_cts: List[Ciphertext]) -> List[List[Ciphertext]]:
        """Each shard's compare flags, computed on its device (its scores
        in stacks of ``compare_chunk()``), in mesh order; the shards of one
        device run in order on its issuing thread (``per_device``)."""
        def run(dev):
            q = _moved(query_cts, dev)
            return {d: shard._compare_many(shard.compute_similarity(q))
                    for d, (sdev, shard) in enumerate(zip(self.mesh.devices, self.shards))
                    if sdev == dev}

        self.windows: Dict[str, Dict[str, float]] = {}
        by_dev = per_device(self.mesh.devices, run, self.windows)
        flags = {d: f for res in by_dev.values() for d, f in res.items()}
        return [flags[d] for d in range(self.mesh.size)]

    def membership(self, query_cts: List[Ciphertext]) -> Ciphertext:
        """Sum of every shard's flags (K12 on the root), then EvalSum."""
        flags = self._flags(query_cts)
        root = self.ctxs[self.mesh.root]
        scale = _check_scales(root, [f for fl in flags for f in fl])
        return _reduce_flags(root, [torch.stack([f.data for f in fl]) for fl in flags],
                             scale, self.mesh.group)

    def index(self, query_cts: List[Ciphertext]) -> List[Ciphertext]:
        """The flags of every group, padding included, in global group
        order, on the root device."""
        root = self.mesh.root
        return [Ciphertext(f.data.to(root), f.scale)
                for fl in self._flags(query_cts) for f in fl]


class ShardedStreamedScenario:
    """A streamed sender's store (``matching/streaming.py``) served over a
    mesh: shard d owns group ids [d*per, (d+1)*per), per = ceil(G / n),
    and ids past the store are padding groups, exact encryptions of 0
    (zero c0 and c1, no contraction launched).  Each distinct device has
    one prefetcher (``streaming._stream_groups``), so shards that share a
    card run one after another on it; each device runs its ids from its
    own issuing thread.  A group already on a shard's device is used in
    place, one resident on another card is copied card to card, a
    host-tier group is prefetched.  The compare
    circuit runs on each device over a stack of ``compare_chunk()`` scores
    as soon as the stack exists, the remainder at the end.

    Membership leaves the padding groups out: the JAX module zeroes their
    flags before the sum, so they add nothing there either, and the
    membership ciphertext equals the single-device one residue for
    residue.  Index returns all per * n flags, padding included, on the
    root device, in order k = d*per + s (the group id)."""

    def __init__(self, sender, mesh: Mesh):
        self.sender, self.mesh = sender, mesh
        self.ctxs = _replicas(sender.ctx, mesh)
        self.views = {dev: senders.shard_view(sender, ctx) for dev, ctx in self.ctxs.items()}

    def _partition(self) -> Tuple[int, int, int]:
        n, G = self.mesh.size, self.sender.store.num_groups
        return -(-G // n), n, G

    def _run(self, query_cts: List[Ciphertext], compare: bool,
             with_pads: bool) -> Dict[int, Ciphertext]:
        """The score of every group id of every shard (padding ids only
        when ``with_pads``), or with ``compare`` its compare flag, each
        device's scores taken in stacks of ``compare_chunk()`` as its
        stream yields them: {group id: ciphertext}.  Each distinct device
        runs its ids from its own issuing thread (``per_device``)."""
        per, n, G = self._partition()
        ids: Dict[torch.device, List[int]] = {dev: [] for dev in self.ctxs}
        for d, dev in enumerate(self.mesh.devices):
            ids[dev] += [k for k in range(d * per, (d + 1) * per) if with_pads or k < G]
        live = [dev for dev in ids if ids[dev]]

        def run(dev):
            view = self.views[dev]
            Q = view._query_stack(_moved(query_cts, dev))
            scores = view._scores(Q, streaming._stream_groups(self.sender.store,
                                                              self.ctxs[dev], ids[dev]))
            return streaming.compare_in_chunks(view, scores) if compare else list(scores)

        self.windows: Dict[str, Dict[str, float]] = {}
        return {k: c for res in per_device(live, run, self.windows).values() for k, c in res}

    def _sharded_scores(self, query_cts: List[Ciphertext]) -> Tuple[torch.Tensor, float, int]:
        """The score of every group id, padding included, stacked on the
        root in order k = d*per + s: ([per*n, 2, l, N], scale, per*n)."""
        per, n, _ = self._partition()
        res = self._run(query_cts, compare=False, with_pads=True)
        scores = torch.stack([res[k].data.to(self.mesh.root) for k in range(per * n)])
        return scores, res[0].scale, per * n

    def _flags(self, query_cts: List[Ciphertext], with_pads: bool) -> Dict[int, Ciphertext]:
        return self._run(query_cts, compare=True, with_pads=with_pads)

    def membership(self, query_cts: List[Ciphertext]) -> Ciphertext:
        """Each shard's flags of its real groups summed with the others'
        (K12 on the root), then EvalSum."""
        per, n, G = self._partition()
        flags = self._flags(query_cts, with_pads=False)
        root = self.ctxs[self.mesh.root]
        scale = _check_scales(root, [flags[k] for k in sorted(flags)])
        stacks = [torch.stack([flags[k].data for k in range(d * per, min((d + 1) * per, G))])
                  for d in range(n) if d * per < G]
        return _reduce_flags(root, stacks, scale, self.mesh.group)

    def index(self, query_cts: List[Ciphertext]) -> List[Ciphertext]:
        per, n, _ = self._partition()
        flags = self._flags(query_cts, with_pads=True)
        root = self.mesh.root
        return [Ciphertext(flags[k].data.to(root), flags[k].scale) for k in range(per * n)]

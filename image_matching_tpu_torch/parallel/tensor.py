"""Intra-ciphertext tensor parallelism: the slot / coefficient axis of every
polynomial sharded over a mesh (port of image_matching_tpu/parallel/tensor.py).

Shard s of D holds positions [s N/D, (s+1) N/D) of every [..., l, N]
array: ciphertexts, plaintexts, the DB stack, the relinearization and
rotation keys and their permutations.  The JAX package lets XLA's SPMD
partitioner place the collectives; here they are placed by hand, and the
rest of the evaluator runs unchanged:

  * every op but two works coefficient by coefficient and runs on each
    shard's slice alone: the residue arithmetic (K11), the tensor product
    (K9), K2's contraction, fast base conversion (K3), the digit
    decomposition (K8), K7's lift and sub-scale, the key MAC (K4) without
    a permutation, the row sums;
  * the NTT (K1) mixes positions across shards.  Its forward transform
    splits at K1's own column / row boundary on the card (N = 2^a x 256):
    an all-to-all gives shard s the columns [s 256/D, (s+1) 256/D) with
    all 2^a elements of each, K1's column pass runs on that block, a
    second all-to-all restores contiguous ownership, and K1's row pass
    runs on the shard's sub-blocks with their global offset into the
    twiddles (``NttPlan.launch_pass``).  On the CPU the plain version
    splits where the butterfly distance falls to N/D: an all-to-all over
    the offsets inside a shard, the first log2 D stages, an all-to-all
    back, the other stages (``ntt_fwd_stages``).  The inverse mirrors
    both;
  * a rotation's automorphism maps each output slot to a source slot
    anywhere in N.  The source is all-gathered, and the three kernels that
    fuse the gather read it at full width through the permutation rows of
    the shard's own slots (global indices): K1's inverse row pass (the
    decomposition's first transform), K4's digit loads and K7's
    sub-scale addend (c0).

The shards run the unchanged context and sender code as SPMD in threads,
one thread a shard (so shards that share one card, or the CPU, each have
their own), each on a ``ShardContext``: a copy of the full context holding
its slices, whose NTT and gathered key-switch steps go through an
``Exchange``.  Every shard issues the same ops on the same metadata, so
scales, level counts and chunking agree.  The exchange's copies run on
each device's current stream in this thread (the default stream): torch
orders a copy between cards after the source card's queued work and
before the destination's next, and a barrier before and after every read
keeps each shard's buffer alive and unchanged until every shard has
queued its read.  A shard that raises aborts the barrier, so every shard
raises and the call re-raises the first error; nothing is caught and
carried on.

The results are full-width ``Ciphertext``s on ``mesh.root``, bit-equal to
the single-device port's and the JAX package's (tests/test_torch_tensor.py),
with the single-device scale.  As in the JAX package, this is a
correctness and overhead artifact, not a speed-up: each shard issues as
many launches as one device does, each a D-th the size.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..ckks.context import Ciphertext, CkksContext, Plaintext
from ..matching import senders
from ..ops import kernels
from ..ops import modmath as mm
from ..ops.ntt import NttPlan, ntt_fwd_stages, ntt_inv_stages, permute_rows
from . import sharded

BARRIER_TIMEOUT_S = 600.0  # a shard that waits longer at a barrier raises


class Exchange:
    """Where the D shard threads of one mesh meet: each shares a tensor,
    waits for the others, reads its part of theirs (copies queued on its
    own device) and waits again, so that no shard changes or frees its
    tensor before every read is queued.  ``bytes`` counts what crossed
    from one shard to another, by kind."""

    def __init__(self, size: int):
        self.size = size
        self.bytes = {"all_to_all": 0, "all_gather": 0}
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        """A fresh barrier (one a call: an aborted one stays broken)."""
        self._slots: List[Optional[torch.Tensor]] = [None] * self.size
        self._barrier = threading.Barrier(self.size, timeout=BARRIER_TIMEOUT_S)

    def abort(self):
        self._barrier.abort()

    def _share(self, s: int, x: torch.Tensor, read: Callable[[List[torch.Tensor]], torch.Tensor],
               kind: str, moved: int) -> torch.Tensor:
        self._slots[s] = x
        self._barrier.wait()
        out = read(self._slots)
        self._barrier.wait()
        with self._lock:
            self.bytes[kind] += moved
        return out

    def all_to_all(self, s: int, x: torch.Tensor, split: int, cat: int) -> torch.Tensor:
        """Shard s's part of an all-to-all: every shard's x holds D pieces
        along axis ``split``; shard s gets piece s of each shard t's, stacked
        in t's order along axis ``cat`` of the result (both axes negative)."""
        piece = list(x.select(split, s).shape)
        shape = piece[:len(piece) + 1 + cat] + [self.size] + piece[len(piece) + 1 + cat:]
        moved = (self.size - 1) * math.prod(piece) * x.element_size()

        def read(xs):
            out = torch.empty(shape, dtype=x.dtype, device=x.device)
            for t, y in enumerate(xs):
                out.select(cat, t).copy_(y.select(split, s))
            return out
        return self._share(s, x, read, "all_to_all", moved)

    def all_gather(self, s: int, x: torch.Tensor) -> torch.Tensor:
        """Every shard's x [..., w] side by side, in shard order: [..., D w]
        on shard s's device."""
        w = x.shape[-1]
        moved = (self.size - 1) * x.numel() * x.element_size()

        def read(xs):
            out = torch.empty((*x.shape[:-1], self.size * w), dtype=x.dtype, device=x.device)
            for t, y in enumerate(xs):
                out[..., t * w:(t + 1) * w].copy_(y)
            return out
        return self._share(s, x, read, "all_gather", moved)


class ShardPlan:
    """Shard s's NTT: the whole plan's tables (its twiddles are indexed by
    stage and global group), data of the shard's N/D positions.  The card
    runs K1's two passes alone with an all-to-all before each of the
    forward's (after each of the inverse's); the CPU runs the plain stages
    split at log2 D.  Anything else is the plan's own."""

    def __init__(self, plan: NttPlan, shard: int, ex: Exchange):
        self.plan, self.shard, self.ex = plan, shard, ex
        D, n = ex.size, plan.n
        if D & (D - 1) or n % (D * D):
            raise ValueError(f"tensor parallel: {D} shards of ring {n} (a power of two "
                             "with N/D >= D)")

    def __getattr__(self, name):
        plan = self.__dict__.get("plan")  # absent while a copy is being built
        if plan is None:
            raise AttributeError(name)
        return getattr(plan, name)

    def _split(self, limbs, inverse: bool):
        idx = self.plan.limb_index(limbs).long()
        tw = self.plan.ipsis if inverse else self.plan.psis
        return tw[idx], self.plan.q[idx], self.plan.ninv[idx]

    def fwd(self, a: torch.Tensor, limbs, perm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Forward transform of the shard's [..., L, N/D] (natural-order
        coefficients) -> its evaluation slots."""
        if perm is not None:
            raise ValueError("tensor parallel: the forward transform takes no permutation")
        return self._kernel(a, limbs, False) if a.is_cuda else self.fwd_plain(a, limbs)

    def inv(self, a: torch.Tensor, limbs, perm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Inverse transform -> the shard's [..., L, N/D] coefficients; with
        ``perm`` (the shard's rows of an automorphism, global indices) a is
        the all-gathered full-width source [..., L, N]."""
        if a.is_cuda:
            return self._kernel(a, limbs, True, perm)
        return self.inv_plain(permute_rows(a, perm), limbs)

    def fwd_plain(self, a: torch.Tensor, limbs) -> torch.Tensor:
        """The plain forward transform, split at log2 D (any device)."""
        D, s, n = self.ex.size, self.shard, self.plan.n
        lead, L, w = a.shape[:-2], a.shape[-2], a.shape[-1]
        psis, q, _ = self._split(limbs, False)
        x = self.ex.all_to_all(s, a.long().reshape(*lead, L, D, w // D), -2, -2)
        x = ntt_fwd_stages(x.reshape(*lead, L, w), psis, q, 1, D, inner=w // D)
        x = self.ex.all_to_all(s, x.reshape(*lead, L, D, w // D), -2, -2)
        return ntt_fwd_stages(x.reshape(*lead, L, w), psis, q, D, n, nblk=D, blk=s).int()

    def inv_plain(self, a: torch.Tensor, limbs) -> torch.Tensor:
        """The plain inverse transform (1/N included), split at log2 D."""
        D, s, n = self.ex.size, self.shard, self.plan.n
        lead, L, w = a.shape[:-2], a.shape[-2], a.shape[-1]
        ipsis, q, ninv = self._split(limbs, True)
        x = ntt_inv_stages(a.long(), ipsis, q, D, n, nblk=D, blk=s)
        x = self.ex.all_to_all(s, x.reshape(*lead, L, D, w // D), -2, -2)
        x = ntt_inv_stages(x.reshape(*lead, L, w), ipsis, q, 1, D, inner=w // D)
        x = x * ninv.long().view(L, 1) % q.long().view(L, 1)
        x = self.ex.all_to_all(s, x.reshape(*lead, L, D, w // D), -2, -2)
        return x.reshape(*lead, L, w).int()

    def _kernel(self, a: torch.Tensor, limbs, inverse: bool,
                perm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """K1 split at its column / row boundary: R = 2^a / D sub-blocks
        and cw = 256 / D columns a shard; every [L, N/D] block of the
        column exchange is [D, R, cw] (shard, row, column), of the row
        exchange [R, D, cw]."""
        plan, ex, s, D = self.plan, self.ex, self.shard, self.ex.size
        a_bits = plan.logn - 8
        R, cw = (1 << a_bits) // D, 256 // D
        if R < 1 or cw < 32:
            raise ValueError(f"tensor parallel: K1 splits ring {plan.n} over at most "
                             f"{min(8, 1 << max(a_bits, 0))} shards, not {D}")
        lead, L, w = a.shape[:-2], a.shape[-2], plan.n // D
        B = math.prod(lead)
        empty = lambda: torch.empty((B, L, w), dtype=torch.int32, device=a.device)  # noqa: E731
        if inverse:
            rows = plan.launch_pass(empty(), a, limbs, True, False, s * R, perm)
            cols = ex.all_to_all(s, rows.view(B, L, R, D, cw), -2, -3)
            plan.launch_pass(cols.view(B, L, w), cols.view(B, L, w), limbs, True, True)
            out = ex.all_to_all(s, cols, -3, -2)
        else:
            cols = ex.all_to_all(s, a.reshape(B, L, R, D, cw), -2, -3)
            done = plan.launch_pass(empty(), cols.view(B, L, w), limbs, False, True)
            rows = ex.all_to_all(s, done.view(B, L, D, R, cw), -3, -2)
            out = plan.launch_pass(empty(), rows.view(B, L, w), limbs, False, False, s * R)
        return out.reshape(*lead, L, w)


class ShardContext(CkksContext):
    """Shard s's evaluator: a copy of the full context whose keys and
    [.., N] tables are its slices and whose ``n`` is N/D (``shard_context``
    makes one).  Encoding and Galois elements come from the full context
    (host side); an automorphism's source is all-gathered first.  Key
    generation, encryption and decryption belong to the full context."""

    full: CkksContext
    shard: int
    ex: Exchange

    def rotation_galois(self, r: int) -> int:
        return self.full.rotation_galois(r)

    def encode(self, values: np.ndarray, limbs: int, scale: float) -> Plaintext:
        rows = self.full.encode_host(values, limbs, scale)[:, self.shard * self.n:][:, :self.n]
        return Plaintext(mm.to_tensor(np.ascontiguousarray(rows), self.device), scale)

    def gen_rotation_keys(self, rotations, force: bool = False):
        raise RuntimeError("tensor parallel: generate keys on the full context, then shard it")

    def encrypt_batch(self, *args, **kwargs):
        raise RuntimeError("tensor parallel: encrypt with the full context")

    def _decrypt_many(self, cts):
        raise RuntimeError("tensor parallel: decrypt the gathered result with the full context")

    def _decompose_extended(self, poly_eval, l, perms=None):
        if perms is not None:
            poly_eval = self.ex.all_gather(self.shard, poly_eval)
        return super()._decompose_extended(poly_eval, l, perms)

    def _ks_mac(self, digs, ksk, l, perms=None):
        if perms is not None:
            digs = self.ex.all_gather(self.shard, digs)
        return super()._ks_mac(digs, ksk, l, perms)

    def _moddown(self, comp, l, add=None, perms=None):
        if perms is not None and add is not None:
            add = self.ex.all_gather(self.shard, add)
        return super()._moddown(comp, l, add, perms)


def _part(x: torch.Tensor, s: int, D: int, device) -> torch.Tensor:
    """Shard s's slice of the last axis of x, contiguous on ``device``."""
    w = x.shape[-1] // D
    return x[..., s * w:(s + 1) * w].to(device, copy=True).contiguous()


def shard_context(ctx: CkksContext, device, s: int, ex: Exchange) -> ShardContext:
    """Shard s's context on ``device``: ctx's keys and every [.., N] table
    sliced (the rotation keys [R, dnum, 2, Ltot, N] and their permutations
    [R, N], which keep their global indices), its NTT tables whole."""
    D, n = ex.size, ctx.n
    dev = kernels.canonical_device(device)
    r = ctx._copied_to(dev, lambda v: _part(v, s, D, dev) if v.dim() >= 2 and v.shape[-1] == n
                       else v.to(dev, copy=True))
    r.__class__ = ShardContext
    r.full, r.shard, r.ex = ctx, s, ex
    r.n = n // D
    r.plan = ShardPlan(r.plan, s, ex)
    return r


def run_shards(mesh: sharded.Mesh, ex: Exchange, fn: Callable[[int], object]) -> list:
    """[fn(s) for each shard s of the mesh], each on its own thread with
    its device current; the first error of a shard (not the others'
    broken barriers) is raised after every thread has ended."""
    if any(d.type == "cuda" for d in mesh.devices):
        kernels.lib()  # built and loaded before the threads start
    ex.reset()
    results: list = [None] * mesh.size
    errors: List[Optional[BaseException]] = [None] * mesh.size

    def work(s):
        dev = mesh.devices[s]
        try:
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                results[s] = fn(s)
        except BaseException as e:  # noqa: B036 - re-raised by the caller
            errors[s] = e
            ex.abort()

    threads = [threading.Thread(target=work, args=(s,), name=f"tp-shard-{s}")
               for s in range(mesh.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    raised = [e for e in errors if e is not None]
    if raised:
        first = [e for e in raised if not isinstance(e, threading.BrokenBarrierError)]
        raise (first or raised)[0]
    return results


def _gathered(parts: Sequence[Ciphertext], root) -> Ciphertext:
    """The shards' slices of one ciphertext side by side on ``root``."""
    scales = {p.scale for p in parts}
    if len(scales) != 1:
        raise RuntimeError(f"tensor parallel: the shards' scales differ: {sorted(scales)}")
    return Ciphertext(torch.cat([p.data.to(root) for p in parts], dim=-1), parts[0].scale)


class TensorParallel:
    """Single-ciphertext CKKS ops with the slot / coefficient axis sharded
    over ``mesh`` (``sharded.Mesh``; a device may repeat).  Each op takes
    full-width data (anywhere), runs every shard on its slice and returns
    full-width data on ``mesh.root``."""

    def __init__(self, ctx: CkksContext, mesh: sharded.Mesh):
        self.ctx = ctx
        self.mesh = mesh
        self.ex = Exchange(mesh.size)
        self.shards = run_shards(mesh, self.ex,
                                 lambda s: shard_context(ctx, mesh.devices[s], s, self.ex))

    def run_shards(self, fn: Callable[[int, ShardContext], object]) -> list:
        """[fn(s, shard s's context) for each shard], one thread a shard."""
        return run_shards(self.mesh, self.ex, lambda s: fn(s, self.shards[s]))

    def _local(self, s: int, ct: Ciphertext) -> Ciphertext:
        return Ciphertext(_part(ct.data, s, self.mesh.size, self.shards[s].device), ct.scale)

    def _op(self, fn: Callable[[ShardContext, Ciphertext], Ciphertext], ct: Ciphertext) -> Ciphertext:
        return _gathered(self.run_shards(lambda s, c: fn(c, self._local(s, ct))), self.mesh.root)

    def shard_ct(self, ct: Ciphertext) -> Ciphertext:
        """The ciphertext on ``mesh.root``, checked for the ring: the ops
        take full-width data and slice it per shard."""
        if ct.data.shape[-1] != self.ctx.n:
            raise ValueError(f"tensor parallel: data {tuple(ct.data.shape)} for ring {self.ctx.n}")
        return Ciphertext(ct.data.to(self.mesh.root), ct.scale)

    def _transform(self, x: torch.Tensor, limbs, inverse: bool) -> torch.Tensor:
        parts = self.run_shards(lambda s, c: (c.plan.inv if inverse else c.plan.fwd)(
            _part(x, s, self.mesh.size, c.device), tuple(limbs)))
        return torch.cat([p.to(self.mesh.root) for p in parts], dim=-1)

    def ntt_fwd(self, x: torch.Tensor, limbs) -> torch.Tensor:
        """The forward NTT of x [..., L, N] (``ctx.plan.fwd``), sharded."""
        return self._transform(x, limbs, False)

    def ntt_inv(self, x: torch.Tensor, limbs) -> torch.Tensor:
        """The inverse NTT of x [..., L, N] (``ctx.plan.inv``), sharded."""
        return self._transform(x, limbs, True)

    def mul_relin_rescale(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """ct x ct multiply, relinearize, rescale (rescale_score)."""
        return _gathered(self.run_shards(lambda s, c: c.rescale_score(c.relinearize(
            c.mul(self._local(s, a), self._local(s, b))))), self.mesh.root)

    def rotate(self, ct: Ciphertext, steps: int) -> Ciphertext:
        """Slot rotation by ``steps`` through the power-of-two keys
        (``ctx.binary_rotate``)."""
        return self._op(lambda c, x: c.binary_rotate(x, steps), ct)

    def eval_sum(self, ct: Ciphertext, m: int) -> Ciphertext:
        return self._op(lambda c, x: c.eval_sum(x, m), ct)


class TPScenario:
    """A sender's whole membership or index with every polynomial's slot
    axis sharded: the sender's own scenario code runs on every shard over
    the shard's slice of its DB, query and keys (``senders.shard_view``),
    for an in-memory sender of any approach.  Bit-equal to the
    single-device sender."""

    def __init__(self, sender: senders.Sender, mesh: sharded.Mesh):
        self.sender = sender
        self.mesh = mesh
        self.tp = TensorParallel(sender.ctx, mesh)
        D = mesh.size
        self.views = self.tp.run_shards(lambda s, c: senders.shard_view(
            sender, c, _part(sender.db.data, s, D, c.device)))

    def _run(self, fn, query_cts):
        def shard(s, c):
            return fn(self.views[s], [self.tp._local(s, q) for q in query_cts])
        return self.tp.run_shards(shard)

    def membership(self, query_cts: Sequence[Ciphertext]) -> Ciphertext:
        parts = self._run(lambda v, q: v.membership_scenario(q), query_cts)
        return _gathered(parts, self.mesh.root)

    def index(self, query_cts: Sequence[Ciphertext]) -> List[Ciphertext]:
        parts = self._run(lambda v, q: v.index_scenario(q), query_cts)
        return [_gathered(flags, self.mesh.root) for flags in zip(*parts)]


def make_tp_mesh(n_devices: Optional[int] = None) -> sharded.Mesh:
    """A mesh over the first ``n_devices`` CUDA devices (all by default);
    raises without them.  A one-card mesh of D shards is
    ``sharded.make_mesh(devices=["cuda:0"] * D)``, a CPU one ``["cpu"] * D``."""
    return sharded.make_mesh(n_devices)

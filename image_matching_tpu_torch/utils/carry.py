"""Carry state of the JAX package, given as numpy arrays, into the port.

Lets both packages compute on the same keys and ciphertexts: a context's
secret, public, relinearization and rotation keys (with the galois ->
{set: row} map that picks among key sets), a BaseDB, BlindDB, DiagDB or
HersDB, a streamed DiagStore or HersStore, and ciphertexts.
Residues arrive as uint32 (the JAX dtype) and are stored as int32 with
the same bits, on the card unless ``device`` says otherwise (the stores
follow their context's device).  Only numpy arrays cross: this module
never imports jax.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ckks.context import Ciphertext, CkksContext
from ..matching.enrollers import BaseDB, BlindDB, DiagDB, HersDB
from ..matching.streaming import DiagStore, HersStore, SeededStore
from ..ops import kernels
from ..ops import modmath as mm


def load_context_state(ctx: CkksContext, *, s_eval: np.ndarray, pk_b: np.ndarray,
                       pk_a: np.ndarray, relin_key: np.ndarray,
                       rot_sets: Sequence[Tuple[np.ndarray, np.ndarray]] = (),
                       rot_keys: Optional[Dict[int, Dict[int, int]]] = None,
                       pow2_set_idx: Optional[int] = None,
                       pow2_rots: Sequence[int] = ()):
    """Replace ctx's keys with the given ones (JAX layouts: s_eval
    [Ltot, N] Montgomery; pk [Lq, N]; relin_key [dnum, 2, Ltot, N]; each
    rotation set (perms [R, N], keys [R, dnum, 2, Ltot, N])).  The host
    copy of the secret used for further key generation follows."""
    shapes = {"s_eval": (s_eval, (ctx.Ltot, ctx.n)), "pk_b": (pk_b, (ctx.Lq, ctx.n)),
              "pk_a": (pk_a, (ctx.Lq, ctx.n)),
              "relin_key": (relin_key, (ctx.dnum, 2, ctx.Ltot, ctx.n))}
    for name, (arr, shape) in shapes.items():
        if tuple(np.shape(arr)) != shape:
            raise ValueError(f"{name}: shape {np.shape(arr)}, expected {shape}")
    dev = ctx.device
    ctx.s_eval = mm.to_tensor(s_eval, dev)
    ctx._s_eval_std = np.stack([
        mm.host_from_mont(np.asarray(s_eval[i], dtype=np.uint32), q)
        for i, q in enumerate(ctx.all_primes)]).astype(np.uint64)
    ctx.pk_b = mm.to_tensor(pk_b, dev)
    ctx.pk_a = mm.to_tensor(pk_a, dev)
    ctx.relin_key = mm.to_tensor(relin_key, dev)
    ctx._rot_sets = [
        (torch.from_numpy(np.array(p, dtype=np.int32)).to(dev), mm.to_tensor(k, dev))
        for p, k in rot_sets]
    ctx._rot_cache.clear()
    ctx.rot_keys = {int(g): {int(s): int(r) for s, r in d.items()}
                    for g, d in (rot_keys or {}).items()}
    if pow2_set_idx is not None:
        ctx._pow2_set_idx = pow2_set_idx
    ctx._pow2_rots = list(pow2_rots)


def _residues(data: np.ndarray, device) -> torch.Tensor:
    return mm.to_tensor(data, kernels.resolve_device(device))


def ciphertext(data: np.ndarray, scale: float, device="cuda") -> Ciphertext:
    """A JAX ciphertext's data [k, l, N] (uint32) and scale."""
    return Ciphertext(_residues(data, device), float(scale))


def base_db(data: np.ndarray, num_vectors: int, scale: float, device="cuda") -> BaseDB:
    """A JAX BaseDB's fields ([num_batches, 2, L, N] uint32 data)."""
    return BaseDB(_residues(data, device), int(num_vectors), float(scale))


def blind_db(data: np.ndarray, num_vectors: int, scale: float, device="cuda") -> BlindDB:
    """A JAX BlindDB's fields ([num_matrices, chunks_per_vector, 2, L, N]
    uint32 data)."""
    return BlindDB(_residues(data, device), int(num_vectors), float(scale))


def diag_db(data: np.ndarray, num_vectors: int, scale: float, bsgs: bool,
            n1: int, device="cuda") -> DiagDB:
    """A JAX DiagDB's fields ([groups, dim, 2, L, N] uint32 data)."""
    return DiagDB(_residues(data, device), int(num_vectors), float(scale), bool(bsgs), int(n1))


def hers_db(data: np.ndarray, num_vectors: int, scale: float, device="cuda") -> HersDB:
    """A JAX HersDB's fields ([num_matrices, dim, 2, L, N] uint32 data)."""
    return HersDB(_residues(data, device), int(num_vectors), float(scale))


def _fill(store: SeededStore, groups: Sequence[np.ndarray]) -> SeededStore:
    for g in groups:
        store.groups.append(mm.to_tensor(np.asarray(g), store.ctx.device))
        store.resident.append(True)
    return store


def diag_store(ctx: CkksContext, groups: Sequence[np.ndarray], num_vectors: int,
               scale: float, bsgs: bool, n1: int, seed: int) -> DiagStore:
    """A JAX DiagStore's fields: its c0 groups ([dim, L, N] uint32 each),
    all placed resident on ctx's device; c1 follows from ``seed``."""
    return _fill(DiagStore(ctx, int(num_vectors), float(scale), bool(bsgs), int(n1), int(seed)),
                 groups)


def hers_store(ctx: CkksContext, groups: Sequence[np.ndarray], num_vectors: int,
               scale: float, seed: int) -> HersStore:
    """A JAX HersStore's fields, as ``diag_store``."""
    return _fill(HersStore(ctx, int(num_vectors), float(scale), int(seed)), groups)

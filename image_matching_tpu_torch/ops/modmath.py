"""RNS residue arithmetic on torch tensors (plain versions) plus the host
constant helpers.

Port of image_matching_tpu/ops/modmath.py.  Residues are stored as
``torch.int32``: every prime is below 2^31, so the bit pattern equals the
JAX package's uint32.  CPU torch cannot add, shift or compare uint32, so
these plain versions compute in int64 and return int32.  Each JAX result
is a fully reduced residue, so the exact identities

    mont_mul(a, b)  == a * b * R^{-1} mod q      (R = 2^32)
    shoup_mul(a, w) == a * w mod q

give bit-identical values without 16-bit half products (``mul32_wide``
exists only because the TPU has no 64-bit multiply).  Per-limb constants
are int64 tensors broadcastable against the data (``[l, 1]`` against
``[..., l, N]``): ``q`` and ``rinv`` = R^{-1} mod q.

The CUDA kernels use the device-function versions in ``csrc/modmath.cuh``.
"""

from __future__ import annotations

import numpy as np
import torch

R = 1 << 32


def mont_mul(a, b, q, rinv):
    """Montgomery product a * b * R^{-1} mod q (a * b < 2^63)."""
    return ((a.long() * b.long()) % q * rinv % q).int()


def shoup_mul(a, w, q):
    """a * w mod q for a standard-form constant w (the Shoup companion of
    the JAX version is an implementation detail of the same value)."""
    return (a.long() * w.long() % q).int()


def mod_add(a, b, q):
    s = a.long() + b.long()
    return torch.where(s >= q, s - q, s).int()


def mod_sub(a, b, q):
    d = a.long() - b.long()
    return torch.where(d < 0, d + q, d).int()


def mod_neg(a, q):
    a = a.long()
    return torch.where(a == 0, a, q - a).int()


def reduce_small(x, q):
    """x mod q (the JAX version assumes x < 16 q and subtracts)."""
    return (x.long() % q).int()


def mont_dot(a, b, dim, q, rinv, chunk: int = 64):
    """sum_k a_k * b_k * R^{-1} mod q over axis ``dim``: the Montgomery form
    of the dot product of Montgomery operands.  Each product is reduced
    before the sum (in chunks of ``chunk`` terms to bound the int64
    temporaries), so any contraction length is exact."""
    K = a.shape[dim]
    acc = None
    for k0 in range(0, K, chunk):
        ak = a.narrow(dim, k0, min(chunk, K - k0)).long()
        bk = b.narrow(dim, k0, min(chunk, K - k0)).long()
        part = (ak * bk % q).sum(dim)
        acc = part if acc is None else acc + part
    return (acc % q * rinv % q).int()


# ---------------------------------------------------------------------------
# Host-side (numpy / python int) helpers for constant generation
# ---------------------------------------------------------------------------


def host_mont_constants(q: int):
    """Return (qneg_inv, r1, r2, r3) for prime q: -q^{-1} mod 2^32, and
    R, R^2, R^3 mod q."""
    qinv = pow(q, -1, R)
    qneg_inv = (R - qinv) % R
    return qneg_inv, R % q, (R * R) % q, (R * R * R) % q


def host_to_mont(x: np.ndarray, q: int) -> np.ndarray:
    """Standard residues in [0, q) -> Montgomery form (exact via uint64)."""
    return ((x.astype(np.uint64) * np.uint64(R % q)) % np.uint64(q)).astype(np.uint32)


def host_from_mont(x: np.ndarray, q: int) -> np.ndarray:
    rinv = pow(R, -1, q)
    return ((x.astype(np.uint64) * np.uint64(rinv)) % np.uint64(q)).astype(np.uint32)


def host_shoup(w: np.ndarray, q: int) -> np.ndarray:
    """floor(w * 2^32 / q) for constant arrays (exact, via uint64)."""
    return ((w.astype(np.uint64) << np.uint64(32)) // np.uint64(q)).astype(np.uint32)


def host_pow16_mont(q: int) -> np.ndarray:
    """uint32[4]: 2^{16k} * R mod q (the JAX mont_dot lane fold)."""
    return np.array([(1 << (16 * k)) * R % q for k in range(4)], dtype=np.uint32)


def host_rinv(q: int) -> int:
    """R^{-1} mod q."""
    return pow(R, -1, q)


def to_tensor(x: np.ndarray, device) -> torch.Tensor:
    """uint32 residues (numpy) -> int32 tensor with the same bits."""
    x = np.ascontiguousarray(x, dtype=np.uint32)
    if not x.flags.writeable:  # torch.from_numpy wants a writable buffer
        x = x.copy()
    return torch.from_numpy(x.view(np.int32)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 residue tensor -> uint32 numpy array with the same bits."""
    return t.detach().cpu().numpy().view(np.uint32)

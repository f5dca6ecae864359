"""Threefry-2x32-20 counter-based generator of uniform residues (port of
image_matching_tpu/ops/prng.py).

The stream is part of the seed-compressed store's format: the c1 half of
DB ciphertext b in group g under base seed s is, per limb and coefficient,
one Threefry block with key (s, g) and counter (idx, 0),
idx = (b * l + limb) * N + k mod 2^32, its 64-bit output (hi, lo) reduced
mod q_limb.  The JAX package, its numpy reference, the C++ host enroller
and kernel K5 (``csrc/prng.cu``) all produce the same bits.

CPU torch has no uint32 add, shift or compare, so the plain version holds
the 32-bit words in int64 and masks to 32 bits after every add and rotate.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from . import kernels

_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
M32 = 0xFFFFFFFF


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds.  Keys are ints, counters int64 tensors
    holding uint32 values; returns (y0, y1) likewise."""
    ks0, ks1 = k0 & M32, k1 & M32
    ks2 = ks0 ^ ks1 ^ _PARITY
    x0 = (x0 + ks0) & M32
    x1 = (x1 + ks1) & M32
    ks = (ks1, ks2, ks0)
    for i in range(5):
        for r in _ROT[4 * i % 8: 4 * i % 8 + 4]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[i % 3]) & M32
        x1 = (x1 + ks[(i + 1) % 3] + i + 1) & M32
    return x0, x1


def uniform_residues_plain(seed: int, group: int, shape: Sequence[int], q: torch.Tensor,
                           r1: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`uniform_residues`: int32 [*shape], shape
    ending in (l, N); q, r1 (R mod q): int32 [>= l] per-limb constants.
    (hi * 2^32 + lo) mod q is computed as ((hi mod q) * R + lo) mod q,
    exact in int64 and equal to the kernel's Montgomery form."""
    l = shape[-2]
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=q.device) & M32
    hi, lo = threefry2x32(seed, group, idx, torch.zeros_like(idx))
    qv = q[:l].long()[:, None]
    v = (hi.reshape(shape) % qv * r1[:l].long()[:, None] + lo.reshape(shape)) % qv
    return v.int()


def uniform_residues(seed: int, group: int, shape: Sequence[int], q: torch.Tensor,
                     qneg: torch.Tensor, r1: torch.Tensor, r2: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Uniform residues mod q per limb, int32 [*shape] with shape
    (B, l, N), the Montgomery/eval-form c1 of B seed-compressed
    ciphertexts.  q, qneg (-q^-1 mod 2^32), r1 (R mod q), r2 (R^2 mod q):
    int32 per-limb constants [>= l] on the output's device.

    ``out``, if given, receives the result: a [B, l, N] view whose last two
    axes are contiguous (the c1 half of a [B, 2, l, N] stack).  Kernel K5
    for CUDA tensors, :func:`uniform_residues_plain` for CPU tensors."""
    B, l, n = shape
    if not q.is_cuda:
        v = uniform_residues_plain(seed, group, shape, q, r1)
        return v if out is None else out.copy_(v)
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=q.device)
    if tuple(out.shape) != (B, l, n) or out.stride()[1:] != (n, 1):
        raise ValueError(f"expand_c1: output {tuple(out.shape)} with strides "
                         f"{out.stride()} does not hold [{B}, {l}, {n}] rows")
    if B > 65535 or l > 65535:
        raise ValueError("expand_c1: batch or limbs exceed the kernel's grid (65535)")
    kernels.check_cuda("expand_c1", q, qneg, r1, r2)
    if out.device != q.device or out.dtype != torch.int32:
        raise ValueError("expand_c1: output must be int32 on the constants' device")
    kernels.launch("imtpu_expand_c1", "expand_c1", out, kernels.ptr(q),
                   kernels.ptr(qneg), kernels.ptr(r1), kernels.ptr(r2), seed & M32,
                   group & M32, B, l, n, out.stride(0))
    return out

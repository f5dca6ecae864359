"""CKKS canonical-embedding encoding/decoding (host side, float64 FFT).

The port's own copy of image_matching_tpu/ckks/encoding.py; the exact
multi-limb CRT decode goes through the port's native loader.

Slot j of a plaintext corresponds to evaluation of the message polynomial at
zeta^{5^j}, zeta = exp(i*pi/N) a primitive 2N-th complex root; conjugate
slots make the polynomial real.  With this ordering, the Galois map
X -> X^{5^r} rotates slot contents left by r — the basis for EvalRotate
semantics (reference binaryRotate, src/openFHE_wrapper.cpp:103-128).

Encoding and decoding are O(N log N) via a twisted FFT:
    tau(a)[t] = m(zeta^{2t+1}) = N * ifft(a * psi)[t],  psi_k = zeta^k.

RNS conversion and exact CRT reconstruction live here too.  Decoding uses a
fast uint64 path when the remaining modulus fits 63 bits (the common case —
circuits finish at two ~2^28/2^30 limbs) and falls back to exact python-int
CRT otherwise.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np


@functools.lru_cache(maxsize=8)
def _slot_tables(n: int):
    """(slot_pos, conj_pos): FFT bin index for slot j and its conjugate."""
    slots = n // 2
    e = 1
    slot_pos = np.empty(slots, dtype=np.int64)
    conj_pos = np.empty(slots, dtype=np.int64)
    for j in range(slots):
        slot_pos[j] = (e - 1) // 2
        conj_pos[j] = (2 * n - e - 1) // 2
        e = (e * 5) % (2 * n)
    return slot_pos, conj_pos


@functools.lru_cache(maxsize=8)
def _twist(n: int) -> np.ndarray:
    return np.exp(1j * np.pi * np.arange(n) / n)


def encode(values: np.ndarray, n: int, scale: float) -> np.ndarray:
    """Encode real slot values (shape [..., m], m <= N/2, zero-padded) into
    integer coefficients (int64, shape [..., N]).  Vectorized over leading
    dims so whole databases encode in one FFT batch."""
    values = np.atleast_2d(np.asarray(values, dtype=np.float64))
    lead = values.shape[:-1]
    slots = n // 2
    if values.shape[-1] < slots:
        pad = np.zeros(lead + (slots - values.shape[-1],), dtype=np.float64)
        values = np.concatenate([values, pad], axis=-1)
    slot_pos, conj_pos = _slot_tables(n)
    u = np.zeros(lead + (n,), dtype=np.complex128)
    u[..., slot_pos] = values
    u[..., conj_pos] = values  # conj of a real value
    x = np.fft.fft(u, axis=-1) / n
    a = (x * np.conj(_twist(n))).real
    return np.rint(a * scale).astype(np.int64)


def decode(coeffs: np.ndarray, n: int, scale: float, num_slots: int | None = None) -> np.ndarray:
    """Decode centered float/int coefficients [..., N] -> real slots
    [..., N/2] (or first num_slots)."""
    a = np.asarray(coeffs, dtype=np.float64) / scale
    tau = n * np.fft.ifft(a * _twist(n), axis=-1)
    slot_pos, _ = _slot_tables(n)
    out = tau[..., slot_pos].real
    if num_slots is not None:
        out = out[..., :num_slots]
    return out


def to_rns(coeffs: np.ndarray, primes: Sequence[int]) -> np.ndarray:
    """Signed int64 coefficients [..., N] -> standard-form residues
    uint32[..., L, N]."""
    coeffs = np.asarray(coeffs)
    out = np.empty(coeffs.shape[:-1] + (len(primes),) + coeffs.shape[-1:], dtype=np.uint32)
    for i, q in enumerate(primes):
        out[..., i, :] = np.mod(coeffs, q).astype(np.uint32)
    return out


def from_rns_centered(res: np.ndarray, primes: Sequence[int]) -> np.ndarray:
    """Standard-form residues [..., L, N] -> centered coefficients, float64.

    Exact for |value| < Q/2.  Fast vectorized path for products Q < 2^63;
    python-int CRT otherwise (rare: only needed when decoding fresh
    high-level ciphertexts, e.g. in tests).
    """
    primes = [int(q) for q in primes]
    Q = 1
    for q in primes:
        Q *= q
    if Q >= (1 << 63):
        # exact multi-word path in native code when available
        from ..utils import native

        out = native.crt_compose_centered(res, primes)
        if out is not None:
            return out
    if Q < (1 << 63):
        acc = np.zeros(res.shape[:-2] + res.shape[-1:], dtype=np.int64)
        # iterative CRT: x := x + q_partial * ((r_i - x) * inv mod q_i)
        qp = 1
        for i, q in enumerate(primes):
            r = res[..., i, :].astype(np.int64)
            inv = pow(qp % q, -1, q)
            diff = (r - acc) % q
            acc = acc + qp * (diff * inv % q)
            qp *= q
        acc = np.where(acc > Q // 2, acc - Q, acc)
        return acc.astype(np.float64)
    # exact big-int path
    shape = res.shape
    L = shape[-2]
    flat = res.reshape(-1, L, shape[-1])
    out = np.empty((flat.shape[0], shape[-1]), dtype=np.float64)
    crt_m = []
    for i, q in enumerate(primes):
        Qi = Q // q
        crt_m.append(Qi * pow(Qi % q, -1, q))
    for b in range(flat.shape[0]):
        cols = flat[b].astype(object)
        vals = [0] * shape[-1]
        for i in range(L):
            mi = crt_m[i]
            row = cols[i]
            for j in range(shape[-1]):
                vals[j] += int(row[j]) * mi
        for j in range(shape[-1]):
            v = vals[j] % Q
            if v > Q // 2:
                v -= Q
            out[b, j] = float(v)
    return out.reshape(shape[:-2] + shape[-1:])

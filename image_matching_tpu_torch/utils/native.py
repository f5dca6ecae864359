"""The port's ctypes loader for the repository's host C++ runtime
(``native/imtpu_native.cpp``: the ``.dat`` parser, exact multi-limb CRT
decode and the seeded host enroller).

The source is compiled with the host C++ compiler on first use into
``build/imtpu_torch/`` at the root of the checkout, named by a hash of the
source and flags; the JAX package's own build of the same source is never
loaded.  Where no compiler or source is found, ``available()`` is False
and callers take their pure-Python paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[2] / "native" / "imtpu_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "imtpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")

_LIB = None
_TRIED = False


def _build() -> Path | None:
    """Compile the library unless a build of this source exists; None
    when there is no source or no compiler, or the build fails."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not SRC.exists() or cxx is None:
        return None
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libimtpu_native_{h}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, timeout=300, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    return out


def _lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.imtpu_parse_dat.restype = ctypes.c_long
    lib.imtpu_parse_dat.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_long,
    ]
    lib.imtpu_crt_compose_centered.restype = None
    lib.imtpu_crt_compose_centered.argtypes = [
        np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS"),
        ctypes.c_long,
        ctypes.c_long,
        np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
    ]
    lib.imtpu_enroll_group.restype = None
    lib.imtpu_enroll_group.argtypes = [
        np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS"),
        ctypes.c_uint32, ctypes.c_uint32,
        np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS"),
        ctypes.c_int,
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _lib() is not None


def parse_dat(path: str, max_vals: int) -> np.ndarray | None:
    """Up to ``max_vals`` whitespace-separated numbers of a text file as
    float64 (native/imtpu_native.cpp imtpu_parse_dat); None when the
    library is missing or the file cannot be read."""
    lib = _lib()
    if lib is None:
        return None
    out = np.empty(max_vals, dtype=np.float64)
    n = lib.imtpu_parse_dat(path.encode(), out, max_vals)
    if n < 0:
        return None
    return out[:n]


def enroll_group(m_plus_e: np.ndarray, primes: np.ndarray, psis: np.ndarray,
                 s_eval: np.ndarray, seed: int, group: int,
                 n_threads: int = 0) -> np.ndarray | None:
    """Host-side seeded symmetric encryption of one DB group (see
    native/imtpu_native.cpp imtpu_enroll_group): [B, N] int64 coeffs ->
    c0 [B, L, N] uint32 Montgomery/eval."""
    lib = _lib()
    if lib is None:
        return None
    if not n_threads:
        n_threads = os.cpu_count() or 1
    m_plus_e = np.ascontiguousarray(m_plus_e, dtype=np.int64)
    B, N = m_plus_e.shape
    primes = np.ascontiguousarray(primes, dtype=np.uint32)
    L = primes.shape[0]
    psis = np.ascontiguousarray(psis[:L], dtype=np.uint32)
    s_eval = np.ascontiguousarray(s_eval[:L], dtype=np.uint32)
    out = np.empty((B, L, N), dtype=np.uint32)
    lib.imtpu_enroll_group(m_plus_e, B, N, L, primes, psis, s_eval,
                           seed & 0xFFFFFFFF, group & 0xFFFFFFFF, out, n_threads)
    return out


def crt_compose_centered(res: np.ndarray, primes) -> np.ndarray | None:
    """res: uint32 [..., L, n] standard residues -> centered float64 [..., n]."""
    lib = _lib()
    if lib is None:
        return None
    res = np.ascontiguousarray(res, dtype=np.uint32)
    shape = res.shape
    L, n = shape[-2], shape[-1]
    flat = res.reshape(-1, L, n)
    pr = np.asarray([int(p) for p in primes], dtype=np.uint64)
    out = np.empty((flat.shape[0], n), dtype=np.float64)
    for b in range(flat.shape[0]):
        lib.imtpu_crt_compose_centered(flat[b], L, n, pr, out[b])
    return out.reshape(shape[:-2] + (n,))

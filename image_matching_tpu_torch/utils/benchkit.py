"""What the kernel benches (``ntt_bench``, ``dot_bench``, ``fbc_bench``,
``resid_bench``, ``enc_bench``, ``psum_bench``, ``dec_bench``) and
``chip_smoke.py`` share: the card's rates and the operation counts behind
a kernel's bound, device time in windows queued behind a sleep, a
wrapper's host time a call, another design's sources built alone into a
library of their own, and random residue rows."""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

from ..ops import kernels

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM device memory
INT_OPS_PER_S = 67e12      # 32-bit lanes outside the tensor cores (the float32 peak;
# Hopper issues integer add, xor and shift at a lower one)
MUL, ADD = 6, 2            # 32-bit operations per modular product / add
BUTTERFLY_OPS = MUL + 2 * ADD  # a Shoup product and two modular adds
THREEFRY_OPS = 20 * 4 + 4 * 6 + 2 * MUL  # a uniform residue: 20 rounds of add, rotate,
# xor; the key injections; two Montgomery products
SLEEP_CYCLES_PER_CALL = 2_000_000  # ~1 ms of the card's clock: above one call's host time
# (a decryption of 64 ciphertexts takes ~0.1-0.6 ms of Python before its launch)


def bound(nbytes, ops):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` and issue ``ops`` 32-bit operations."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def ntt_ops(rows: int, n: int) -> int:
    """The butterflies' operations of ``rows`` transforms of N = n."""
    return rows * n // 2 * (n.bit_length() - 1) * BUTTERFLY_OPS


def event_ms(fn, iters: int) -> float:
    """Device time per call: the stream first runs a sleep long enough for
    the host to queue every call behind it, so the window holds the
    kernels back to back and not the wrappers' host time."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(iters * SLEEP_CYCLES_PER_CALL))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 20) -> float:
    """Host time per call of ``iters`` calls with no sync inside, the card
    idle before them: what a wrapper costs the caller's thread."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return t / iters * 1e3


def in_turns(new, old, window=lambda fn: event_ms(fn, 20)):
    """(ms, baseline ms) of two calls on the same inputs: kernel,
    baseline, baseline, kernel, twice (four windows a side; ``window``
    gives a window's ms a call, by default device time over 20 calls);
    without a baseline (``old`` None), the kernel's four windows."""
    if old is None:
        return sum(window(new) for _ in range(4)) / 4, None
    ks = [window(f) for f in (new, old, old, new) * 2]
    return sum(ks[0::4] + ks[3::4]) / 4, sum(ks[1::4] + ks[2::4]) / 4


def build_alone(src_dir: Path, sources: Sequence[str], stem: str, entries: Dict[str, str]):
    """The ``.cu`` files of ``sources`` in ``src_dir`` (another design)
    built into one library of their own, their includes from ``src_dir``
    first, then the port's ``csrc/``; each entry of ``entries`` (name:
    argument signature in ``kernels._CTYPE`` letters, a stream last) is
    bound.  The library is named by a hash of the directory's sources."""
    src_dir = Path(src_dir).resolve()
    h = hashlib.sha256()
    for p in sorted(src_dir.glob("*.cu")) + sorted(src_dir.glob("*.cuh")):
        h.update(p.name.encode() + p.read_bytes())
    out = kernels.BUILD_DIR / f"lib{stem}_baseline_{h.hexdigest()[:12]}.so"
    if not out.exists():
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-I", str(src_dir),
                        "-I", str(kernels.CSRC), "-o", str(out),
                        *(str(src_dir / s) for s in sources if s.endswith(".cu"))],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    for name, sig in entries.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [kernels._CTYPE[c] for c in sig] + [ctypes.c_void_p]
    return lib


def call(lib, entry: str, out: torch.Tensor, *args) -> torch.Tensor:
    """``lib.entry(out, *args, stream)`` on the current stream; raises on
    a CUDA error."""
    rc = getattr(lib, entry)(out.data_ptr(), *args,
                             torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"baseline {entry}: CUDA error {rc}")
    return out


def rand_rows(ctx, gen, shape, limbs) -> torch.Tensor:
    """Uniform residues int32 [*shape, len(limbs), N] of ctx's primes."""
    q = ctx.q64[list(limbs)][:, None]
    return (torch.randint(0, 1 << 62, (*shape, len(limbs), ctx.n), generator=gen,
                          device=ctx.device) % q).int()

"""Build, load and launch the hand-written CUDA kernels of the port.

The sources in ``image_matching_tpu_torch/csrc/*.cu`` are compiled on first
use by ``nvcc`` for ``sm_90a`` (Hopper) into one shared library with a
plain C interface, which is loaded with ``ctypes``.  The library is cached
under ``build/imtpu_torch/`` at the root of the checkout, named by a hash
of the sources and flags, so an edited source is rebuilt.

Every C entry point takes device pointers and the CUDA stream as
``void*``, launches on that stream without synchronising, and returns
``cudaGetLastError()``; :func:`launch` calls it on the current stream of
its output tensor's device, with that device current, and raises on a
non-zero code.  A
build or launch failure raises: there is no fallback.  Each kernel has a
launch counter, incremented only where the kernel is launched, so a run
can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "imtpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

# C entry point -> its arguments before the trailing stream: "p" a device
# pointer (c_void_p), "i" an int64_t.
_ENTRIES = {
    "imtpu_ntt": "ppipipiiipppppi",
    "imtpu_ct_dot": "pppiiiiiipppp",
    "imtpu_ct_dot_seeded": "pppiiiiiippppii",
    "imtpu_fbc": "pppppiiii",
    "imtpu_ks_mac": "ppippiiiiiiiipp",
    "imtpu_expand_c1": "pppppiiiiii",
    "imtpu_seeded_pre": "pppppppppiii",
    "imtpu_seeded_c0": "pppppppiiiii",
    "imtpu_rescale_lift": "ppiipppiii",
    "imtpu_sub_scale": "ppipppppiiipiiii",
    "imtpu_decompose": "ppippiiii",
    "imtpu_tensor": "ppiipiiippiii",
    "imtpu_decrypt_mac": "ppiiipppiii",
    "imtpu_pk_pre": "ppppppppiii",
    "imtpu_pk_mac": "ppppppiii",
    "imtpu_modarith": "ppipiiiiiiiipp",
    "imtpu_mod_sum": "ppiiiiipppp",
    "imtpu_psum_mod": "ppiiiip",
}
_CTYPE = {"p": ctypes.c_void_p, "i": ctypes.c_int64}

# launch counters: one per kernel, the NTT counted per direction, K2's
# seeded variant (ct_dot_seeded: the contraction with K5's c1 drawn in
# registers) apart from K2, and the two-pass kernels (K6 seeded
# encryption, K7 division by a modulus, K9 tensor product / decrypt MAC,
# K10 public-key encryption, K11 standalone residue arithmetic:
# elementwise / row sum) per pass; K12 the modular sum of shard partials
KERNELS = ("ntt_fwd", "ntt_inv", "ct_dot", "ct_dot_seeded", "fbc", "ks_mac",
           "expand_c1", "seeded_pre", "seeded_c0", "rescale_lift", "sub_scale",
           "decompose", "tensor", "decrypt_mac", "pk_pre", "pk_mac", "modarith",
           "mod_sum", "psum_mod")
_counts = {k: 0 for k in KERNELS}
# the sharded scenarios launch from one thread per card: a count's
# read-modify-write is guarded so that none is lost
_counts_lock = threading.Lock()
# K7's and K11's launches by shape, filled only where those kernels launch
# (no device sync): which shapes they have to serve.  Keys are (pass, B, l,
# k, form): pass "lift", "sub_scale", "row_sum" or K11's op; B the [l, N]
# blocks of the output; l its limbs; k the sub-scale's addend components,
# K11's head (0: every component) or the row sum's R; form whether the
# sub-scale's addend is gathered, or K11's operand b ("same", "plane",
# "limb", or "" for neg)
shape_hist: Dict[tuple, int] = {}

_lib = None
build_seconds = None  # wall time of the build in this process, if one ran
build_log = ""


def counts() -> dict:
    return dict(_counts)


def reset_counts():
    with _counts_lock:
        for k in _counts:
            _counts[k] = 0


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _run_all(cmds):
    """Run the commands side by side; return their logs; raise if any
    failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for cmd in cmds]
    logs, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{logs[-1]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def build() -> Path:
    """Compile the kernels if the cached library is missing or stale;
    return its path.  One nvcc per source, all started together, then one
    link."""
    global build_seconds, build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libimtpu_{source_hash()}.so"
    if out.exists():
        return out
    t0 = time.perf_counter()
    nvcc, srcs = _nvcc(), sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f".{p.stem}.{out.stem}.{os.getpid()}.o" for p in srcs]
    compile_cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)] for o, p in zip(objs, srcs)]
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
    try:
        logs = _run_all(compile_cmds)
        logs += _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    build_log = "\n".join(logs)
    (BUILD_DIR / "build.log").write_text(build_log)
    os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    build_seconds = time.perf_counter() - t0
    return out


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, sig in _ENTRIES.items():
            fn = getattr(handle, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [_CTYPE[c] for c in sig] + [ctypes.c_void_p]
        handle.imtpu_error_string.restype = ctypes.c_char_p
        handle.imtpu_error_string.argtypes = [ctypes.c_int]
        _lib = handle
    return _lib


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device where none is available
    raises here, so an entry point never carries on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: no CUDA GPU is available. The port runs on the card "
            "by default; pass device='cpu' to run the plain versions on the CPU.")
    return dev


def canonical_device(device) -> torch.device:
    """``resolve_device(device)`` with a CUDA device's index filled in
    (``"cuda"`` is the current device), so two names of one card compare
    equal; a CUDA index past the device count raises."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {str(device)!r}: this machine has "
                               f"{torch.cuda.device_count()} CUDA device(s)")
    return dev


def ptr(t) -> int:
    """Device pointer of a tensor, or 0 for None."""
    return 0 if t is None else t.data_ptr()


def check_cuda(name: str, *tensors, contiguous: bool = True, dtype=torch.int32):
    """Raise unless every tensor is a CUDA tensor of ``dtype`` on one
    device (int32: the kernels read int32 storage as uint32 residues),
    contiguous unless ``contiguous`` is False (a strided view passed with
    its strides)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: tensor must be contiguous")


def check_aligned(name: str, t: torch.Tensor):
    """Raise unless t starts on a 16-byte boundary (a fresh allocation
    or a slice of whole rows of one does): the kernels that move four
    residues per access take no other."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must start on a 16-byte boundary")


def row_blocks(t: torch.Tensor):
    """(t, batch, stride) for t [..., L, N] whose [L, N] blocks are each
    contiguous and lie ``stride`` elements apart along the flattened
    leading axes, so a kernel reads a slice of limbs in place; t is
    copied (contiguous) only where no single stride addresses it."""
    L, n = t.shape[-2], t.shape[-1]
    batch = t.numel() // (L * n) if L * n else 0
    if t.stride(-1) == 1 and (L == 1 or t.stride(-2) == n):
        dims = [(s, st) for s, st in zip(t.shape[:-2], t.stride()[:-2]) if s != 1]
        if all(dims[i][1] == dims[i + 1][1] * dims[i + 1][0] for i in range(len(dims) - 1)):
            return t, batch, dims[-1][1] if dims else L * n
    return t.contiguous(), batch, L * n


def launch(entry: str, counter: str, out: torch.Tensor, *args):
    """Call a C entry point whose first argument is the output tensor
    ``out`` on the current stream of ``out``'s device, with that device
    current for the launch (the runtime launches, and sets kernel
    attributes, on its current device); raise on a CUDA error."""
    L = lib()
    sig = _ENTRIES[entry]
    if len(args) + 1 != len(sig):
        raise TypeError(f"{entry} takes {len(sig)} arguments, got {len(args) + 1}")
    dev = out.device
    with torch.cuda.device(dev):
        rc = getattr(L, entry)(out.data_ptr(), *args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = L.imtpu_error_string(rc).decode()
        raise RuntimeError(f"{entry}: CUDA error {rc} ({msg})")
    count(counter)


def count(counter: str):
    """Add one launch to ``counter`` (thread-safe)."""
    with _counts_lock:
        _counts[counter] += 1


def note_shape(*key):
    """Add one launch to ``shape_hist[key]`` (thread-safe)."""
    with _counts_lock:
        shape_hist[key] = shape_hist.get(key, 0) + 1

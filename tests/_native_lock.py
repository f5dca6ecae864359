"""Both host C++ libraries, loaded once per test process under a lock.

The JAX package's loader runs ``make -C native``, which writes
``image_matching_tpu/_native.so`` in place; a process that loads the file
while another writes it fails, and that loader never tries again.  Here
the first test process to ask builds both libraries while the others wait
on a lock file in the checkout's ``build/``.  A load that still fails
while the file exists (a test of the JAX package, which takes no lock,
writing it) is tried again until the file is whole."""

import fcntl
import time
from pathlib import Path

from image_matching_tpu.utils import native as jnative
from image_matching_tpu_torch.utils import native as tnative

ROOT = Path(__file__).resolve().parents[1]
LOCK = ROOT / "build" / "native.lock"
JAX_LIB = ROOT / "image_matching_tpu" / "_native.so"
WAIT_S = 180  # the JAX loader's make stops after 120 s

_ANSWER = None


def _jax_library() -> bool:
    deadline = time.monotonic() + WAIT_S
    while not jnative.available():
        if not JAX_LIB.exists() or time.monotonic() > deadline:
            return False
        time.sleep(2)
        jnative._TRIED = False  # the file was being written: load it again
    return True


def available() -> bool:
    """True when both the JAX package's and the port's host libraries
    load."""
    global _ANSWER
    if _ANSWER is None:
        LOCK.parent.mkdir(parents=True, exist_ok=True)
        with open(LOCK, "w") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            _ANSWER = _jax_library() and tnative.available()
    return _ANSWER

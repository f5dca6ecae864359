"""CPU rehearsals of benchmark runs for the tests: a checkout copied into a
temporary directory, and a run there in a fresh process with its own
``HOME``, ``XDG_CACHE_HOME`` and ``TMPDIR``."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY = "portbench/tests/tiny/benchmark.json"
IGNORE = shutil.ignore_patterns("__pycache__", "*.pyc")

# runs one cell through portbench.run.main, then names on standard error
# every top-level module left loaded
WRAPPER = (
    "import sys\n"
    "from portbench import run\n"
    "rc = run.main(sys.argv[1:])\n"
    "print('MODULES ' + ' '.join(sorted({m.split('.')[0] for m in list(sys.modules)})),"
    " file=sys.stderr)\n"
    "sys.exit(rc)\n"
)


def checkout(dest: Path, program: bool = True) -> Path:
    """The files a run needs, as a checkout holds them: ``BENCHMARK.json``
    and ``portbench/``, and with ``program`` the port and its host C++
    source (the port's host library, where this repository has built it,
    copied too, so the rehearsal need not compile it)."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", dest / "portbench", ignore=IGNORE)
    if program:
        shutil.copytree(REPO / "image_matching_tpu_torch", dest / "image_matching_tpu_torch",
                        ignore=IGNORE)
        shutil.copytree(REPO / "native", dest / "native", ignore=IGNORE)
        built = REPO / "build" / "imtpu_torch"
        for lib in built.glob("libimtpu_native_*.so") if built.is_dir() else []:
            (dest / "build" / "imtpu_torch").mkdir(parents=True, exist_ok=True)
            shutil.copy(lib, dest / "build" / "imtpu_torch" / lib.name)
    return dest


def run(root: Path, homes: Path, *args, timeout=600):
    """``portbench.run`` in ``root`` on the CPU -> (returncode, result or
    None, stderr, top-level modules left loaded)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    for var in ("HOME", "XDG_CACHE_HOME", "TMPDIR"):
        env[var] = str(homes / var.lower())
        os.makedirs(env[var], exist_ok=True)
    env["PYTHONPATH"] = ""
    proc = subprocess.run([sys.executable, "-c", WRAPPER, "--device", "cpu", *args],
                          cwd=root, env=env, capture_output=True, text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    result = None
    if lines:
        try:
            result = json.loads(lines[-1])
        except ValueError:
            result = None
    mods = [ln for ln in proc.stderr.splitlines() if ln.startswith("MODULES ")]
    return proc.returncode, result, proc.stderr, (mods[-1].split()[1:] if mods else None)

"""Two processes, one mesh: the port's parallel/multihost.py on the CPU
(torch.distributed over gloo), as tests/test_multihost.py runs the JAX
package's.  Each process joins the job, takes its share of the DB rows,
and sums two virtual shards' partials with the other process's through
``psum_mod`` over the global mesh; both must hold the numpy modular sum of
all four.  This file is its own worker (run as a script with a rank, a
port and "cpu" or "cuda"); the workers import neither jax nor the JAX
package.  tests/test_torch_cuda.py runs the same pair over NCCL where a
machine has two cards."""

import os
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
L, N = 2, 512


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _shard(primes, shard):
    rng = np.random.default_rng(100 + shard)
    q = np.array(primes, np.uint64)[:, None]
    return (rng.integers(0, 2 ** 31, (L, N)).astype(np.uint64) % q).astype(np.uint32)


def _worker(rank: int, port: str, kind: str):
    """One rank: on the CPU over gloo, or (kind "cuda") on card ``rank``
    over NCCL, where each psum_mod launches K12."""
    import torch
    import torch.distributed as dist

    from image_matching_tpu_torch.ckks.params import SchemeParams
    from image_matching_tpu_torch.ops import kernels
    from image_matching_tpu_torch.parallel import multihost, sharded

    dev = f"cuda:{rank}" if kind == "cuda" else "cpu"
    if kind == "cuda":
        torch.cuda.set_device(rank)
    multihost.init(f"127.0.0.1:{port}", num_processes=2, process_id=rank,
                   backend="nccl" if kind == "cuda" else "gloo")
    assert dist.get_world_size() == 2
    sl = multihost.local_rows(10)
    assert sl == (slice(0, 5) if rank == 0 else slice(5, 10)), sl

    primes = SchemeParams.create(ring_dim=N, mult_depth=2, security="none").q_primes[:L]
    mesh = multihost.global_mesh(devices=[dev, dev])  # 2 virtual shards here
    assert mesh.group is not None and mesh.size == 2
    parts = [torch.from_numpy(_shard(primes, 2 * rank + s).view(np.int32))[None].to(dev)
             for s in range(mesh.size)]
    out = sharded.psum_mod(parts, primes, dev, mesh.group)
    assert out.device == torch.device(dev) and kernels.counts()["psum_mod"] == (
        2 if kind == "cuda" else 0)

    q = np.array(primes, np.uint64)[:, None]
    expect = sum(_shard(primes, s).astype(np.uint64) for s in range(4)) % q
    np.testing.assert_array_equal(out.cpu().numpy().view(np.uint32), expect.astype(np.uint32))
    leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "image_matching_tpu")]
    assert not leaked, leaked
    dist.destroy_process_group()
    print(f"MULTIHOST-OK rank={rank} procs=2 shards=4", flush=True)


def run_pair(kind: str):
    """Run two worker processes ("cpu": gloo; "cuda": NCCL, one card
    each) and require both to finish with the modular sum."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(rank), str(port),
                               kind],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=ROOT,
                              text=True)
             for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"MULTIHOST-OK rank={rank}" in out, out


def test_two_process_psum_mod_over_gloo():
    run_pair("cpu")


def test_single_process_defaults():
    """Without a job: init is a no-op, this process owns every row, and
    the global mesh carries no group."""
    from image_matching_tpu_torch.parallel import multihost

    multihost.init("127.0.0.1:1", num_processes=1, process_id=0)
    assert multihost.local_rows(10) == slice(0, 10)
    assert multihost.global_mesh(devices=["cpu"]).group is None


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])

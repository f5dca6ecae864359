"""Port parity of the sharded scenarios (parallel/sharded.py) at
tests/test_sharding.py scale: ring 512, dim 64, comparison depth 8.

Bit-exact against the JAX package: the plain modular sum of shard
partials (K12's plain version) against JAX ``psum_mod`` under shard_map
over 2, 4 and 8 of the 8 virtual CPU devices, the sharded streamed score
stack (padding groups included) against JAX's
``ShardedStreamedScenario._sharded_scores``, and JAX's reduce segment fed
the port's flags against the port's membership.  The port alone: sharded
membership and index bit-equal to its single-device sender (in memory for
HyDia and HERS, streamed for HyDia), decisions with uneven padding, the
context replica, and the mesh.  Meshes here name the CPU several times
(``["cpu"] * n``): the partition, padding and reduction of n devices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as JP

from image_matching_tpu.ckks.context import CkksContext as JCtx
from image_matching_tpu.ckks.params import SchemeParams, compute_required_depth
from image_matching_tpu.matching.config import MatchConfig
from image_matching_tpu.matching.protocol import MatchingProtocol as JProto
from image_matching_tpu.ops import modmath as jmm
from image_matching_tpu.parallel import sharded as jsharded
from image_matching_tpu.utils import io as dio
from image_matching_tpu_torch.ckks.context import CkksContext as TCtx
from image_matching_tpu_torch.matching.protocol import MatchingProtocol
from image_matching_tpu_torch.ops import kernels
from image_matching_tpu_torch.parallel import sharded

from _torch_parity import assert_same, jax_noise, jax_seeded_noise, port_cfg, port_params, u32

DIM, RING = 64, 512
CFG = MatchConfig(vector_dim=DIM, chunk_len=16, comp_depth=8)
TCFG = port_cfg(CFG)


def _params(approach):
    return SchemeParams.create(ring_dim=RING, security="none",
                               mult_depth=compute_required_depth(approach, CFG.comp_depth))


def _port_ctx(params, seed):
    return TCtx(port_params(params), seed=seed, device="cpu", noise=jax_noise(params.sigma),
                seeded_noise=jax_seeded_noise(params.sigma))


def _cpu_mesh(n):
    return sharded.make_mesh(devices=["cpu"] * n)


def _same_cts(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert_same(x.data, y.data)
        assert x.scale == y.scale


@pytest.mark.parametrize("P", [2, 4, 8])
@pytest.mark.parametrize("l", [1, 2, 3])
def test_psum_mod_plain_matches_jax(P, l):
    """P shard partials of l limbs: JAX's 16-bit-half psum and refold
    under shard_map against the port's int64 sum mod q, summed one row per
    part and as unequal multi-row parts."""
    primes = _params(5).q_primes[:l]
    q = np.array(primes, np.uint32)[:, None]
    qneg = np.array([jmm.host_mont_constants(p)[0] for p in primes], np.uint32)[:, None]
    p16 = np.stack([jmm.host_pow16_mont(p) for p in primes], axis=1)[:, :, None]
    rng = np.random.default_rng(10 * P + l)
    x = (rng.integers(0, 2 ** 31, (P, l, RING)) % q[None]).astype(np.uint32)
    mesh = JMesh(np.array(jax.devices()[:P]), ("db",))
    fn = jax.jit(jax.shard_map(
        lambda a: jsharded.psum_mod(a[0], jnp.asarray(q), jnp.asarray(qneg),
                                    jnp.asarray(p16), "db"),
        mesh=mesh, in_specs=(JP("db"),), out_specs=JP(), check_vma=False))
    want = np.asarray(fn(x))
    parts = torch.from_numpy(x.view(np.int32))
    q64 = torch.tensor(primes, dtype=torch.int64)[:, None]
    assert_same(want, sharded.psum_mod_plain([parts[i:i + 1] for i in range(P)], q64))
    assert_same(want, sharded.psum_mod_plain([parts[:1], parts[1:]], q64))
    assert_same(want, sharded.psum_mod([parts[:P // 2], parts[P // 2:]], primes, "cpu"))


def test_replica_copies_without_drawing():
    """The copy behind ``replica``: equal keys and tables in other
    storage, the same residues from an op, empty caches, and the
    original's generator untouched (its next draw is the one it would
    have made)."""
    params = _params(5)
    ctx = TCtx(port_params(params), seed=3, device="cpu")
    ctx.gen_power_of_two_rotation_keys()
    ctx.gen_rotation_keys([1, 8])
    x = ctx.encrypt(np.random.default_rng(1).uniform(-1, 1, ctx.slots))
    ctx.rotate(x, 1)  # fill the caches
    state = ctx._rng.bit_generator.state
    r = ctx._copied_to(torch.device("cpu"))
    assert ctx._rng.bit_generator.state == state and r._rng is not ctx._rng
    assert ctx.replica("cpu") is ctx and ctx.replica("cpu:0") is ctx
    for name in ("s_eval", "pk_b", "pk_a", "relin_key", "q32", "qneg32", "q64"):
        a, b = getattr(ctx, name), getattr(r, name)
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), name
    assert torch.equal(ctx.plan.psis, r.plan.psis)
    assert r.plan.psis.data_ptr() != ctx.plan.psis.data_ptr()
    assert r.rot_keys == ctx.rot_keys and len(r._rot_sets) == len(ctx._rot_sets)
    for (p0, k0), (p1, k1) in zip(ctx._rot_sets, r._rot_sets):
        assert torch.equal(p0, p1) and torch.equal(k0, k1) and k0.data_ptr() != k1.data_ptr()
    assert not (r._qrow_cache or r._const_cache or r._fbc_cache or r._pt_cache)
    assert ctx._qrow_cache
    assert_same(ctx.rotate(x, 1).data, r.rotate(x, 1).data)
    assert_same(ctx.eval_sum(x, ctx.slots).data, r.eval_sum(x, ctx.slots).data)
    assert ctx._rng.bit_generator.state == state


def test_make_mesh(monkeypatch):
    mesh = _cpu_mesh(3)
    assert mesh.size == 3 and mesh.root == torch.device("cpu")
    assert mesh.distinct() == [torch.device("cpu")] and mesh.group is None
    with pytest.raises(ValueError, match="n_devices"):
        sharded.make_mesh(2, devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            sharded.make_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert sharded.make_mesh().devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert sharded.make_mesh(devices=["cuda:1"] * 2).distinct() == [torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="3 devices asked for, 2 CUDA"):
        sharded.make_mesh(3)
    with pytest.raises(RuntimeError, match="2 CUDA device"):
        sharded.make_mesh(devices=["cuda:0", "cuda:2"])


@pytest.fixture(scope="module", params=[(2, 2), (4, 3)], ids=["2dev-2groups", "4dev-3groups"])
def streamed(request):
    """The same streamed HyDia protocol in both packages (host tier), the
    query encrypted in both, and the sharded scenario of each."""
    n_dev, n_groups = request.param
    params = _params(5)
    query, db = dio.gen_dataset(params.slots * n_groups, DIM, seed=11)
    stream = dict(streamed=True, resident_budget=0, engine="device")
    jp = JProto.setup(5, db, CFG, ctx=JCtx(params, seed=11), **stream)
    tp = MatchingProtocol.setup(5, db, TCFG, ctx=_port_ctx(params, 11), **stream)
    assert tp.sender.store.num_groups == n_groups and tp.sender.store.host_count() == n_groups
    jq, tq = jp.encrypt_query(query), tp.encrypt_query(query)
    assert_same(jq[0].data, tq[0].data)
    js = jsharded.ShardedStreamedScenario(jp.sender, jsharded.make_mesh(n_dev))
    ts = sharded.ShardedStreamedScenario(tp.sender, _cpu_mesh(n_dev))
    return n_dev, n_groups, jp, tp, jq, tq, js, ts


def test_sharded_streamed_scores_bit_exact(streamed):
    """The score stack of every group id, padding included (exact zeros
    of an encryption of 0), in order k = d*per + s."""
    n_dev, n_groups, _, _, jq, tq, js, ts = streamed
    jscores, jscale, jgp = js._sharded_scores(jq)
    scores, scale, gp = ts._sharded_scores(tq)
    assert gp == jgp == n_dev * -(-n_groups // n_dev) and scale == jscale
    assert_same(jscores, scores)
    assert not scores[n_groups:].any()


def test_sharded_streamed_reduce_bit_exact(streamed):
    """JAX's reduce segment (local mod_add chain, psum_mod, EvalSum under
    shard_map) fed the port's flags, padding flags zeroed as the JAX
    membership zeroes them, gives the port's sharded membership."""
    n_dev, n_groups, jp, tp, _, tq, js, ts = streamed
    kernels.reset_counts()
    flags = ts.index(tq)
    member = ts.membership(tq)
    assert all(v == 0 for v in kernels.counts().values())  # the CPU runs no kernel
    fstack = np.stack([u32(f.data) for f in flags])
    fstack[n_groups:] = 0
    fn, meta = js._reduce_fn(flags[0].scale, fstack.shape)
    want = fn(jp.ctx.device_state(), jnp.asarray(fstack))
    assert_same(want, member.data)
    assert meta["scale"] == member.scale


def test_sharded_streamed_matches_single_device(streamed):
    """Membership bit-equal to the port's single-device streamed sender,
    the first G index flags bit-equal, the decisions right."""
    _, n_groups, _, tp, _, tq, _, ts = streamed
    single = tp.sender.run_membership(tq)
    member = ts.membership(tq)
    assert_same(single.data, member.data) and single.scale == member.scale
    assert tp.decrypt_membership(member) is True
    flags = ts.index(tq)
    _same_cts(tp.sender.run_index(tq), flags[:n_groups])
    assert tp.decrypt_index(flags) == [0]


@pytest.mark.parametrize("approach", [5, 4])
def test_sharded_in_memory_matches_single_device(approach):
    """HyDia and HERS over 2 shards of 2 groups: membership and index
    bit-equal to the single-device sender (held to the JAX package by
    test_torch_matching.py and test_torch_hers.py); the sender's DB is
    left as it was."""
    params = _params(approach)
    query, db = dio.gen_dataset(params.slots * 2, DIM, seed=10)
    tp = MatchingProtocol.setup(approach, db, TCFG, ctx=_port_ctx(params, 10))
    data = tp.sender.db.data
    q = tp.encrypt_query(query)
    scen = sharded.ShardedScenario(tp.sender, _cpu_mesh(2))
    assert [s.db.data.shape[0] for s in scen.shards] == [1, 1]
    member = scen.membership(q)
    assert_same(tp.membership(q).data, member.data)
    assert tp.decrypt_membership(member) is True
    flags = scen.index(q)
    _same_cts(tp.index(q), flags)
    assert tp.decrypt_index(flags) == [0]
    assert tp.sender.db.data is data


def test_sharded_uneven_groups_padded():
    """3 HyDia groups on 2 shards: one all-zero group at the end of the
    last shard (as the JAX ``_padded_db``), decisions unchanged, the real
    groups' flags equal to the single-device ones."""
    params = _params(5)
    query, db = dio.gen_dataset(params.slots * 3, DIM, seed=9)
    tp = MatchingProtocol.setup(5, db, TCFG, ctx=_port_ctx(params, 9))
    q = tp.encrypt_query(query)
    scen = sharded.ShardedScenario(tp.sender, _cpu_mesh(2))
    blocks = [s.db.data for s in scen.shards]
    assert [b.shape[0] for b in blocks] == [2, 2] and not blocks[1][1].any()
    assert torch.equal(torch.cat(blocks)[:3], tp.sender.db.data)
    assert tp.decrypt_membership(scen.membership(q)) is True
    flags = scen.index(q)
    assert len(flags) == 4 and tp.decrypt_index(flags) == [0]
    _same_cts(tp.index(q), flags[:3])


def test_per_device_one_thread_each_and_errors_propagate():
    """per_device: one device runs on the calling thread; several each get
    a thread of their own, all running at once (each waits for the others
    at a barrier), and a worker's exception is raised in the caller after
    every worker has ended."""
    import threading

    cpu, meta = torch.device("cpu"), torch.device("meta")
    assert sharded.per_device([cpu, cpu], lambda d: threading.get_ident()) == {
        cpu: threading.get_ident()}
    barrier = threading.Barrier(2, timeout=30)

    def meet(dev):
        barrier.wait()
        return threading.get_ident()

    windows = {}
    ids = sharded.per_device([cpu, meta, cpu], meet, windows)
    assert set(ids) == {cpu, meta} and len(set(ids.values())) == 2
    assert threading.get_ident() not in ids.values()
    assert set(windows) == {"cpu", "meta"}
    assert all(0 <= w["issue_start_s"] <= w["issue_end_s"] <= w["done_s"]
               for w in windows.values())
    ended = []

    def fail_on_meta(dev):
        if dev == meta:
            raise RuntimeError("worker failed")
        ended.append(dev)
        return dev

    with pytest.raises(RuntimeError, match="worker failed"):
        sharded.per_device([cpu, meta], fail_on_meta)
    assert ended == [cpu]


def test_launch_counts_are_not_lost_under_threads():
    """The kernels' launch counters are bumped from one thread per card in
    the sharded scenarios: many threads bumping at a short switch interval
    lose no count."""
    import sys
    import threading

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        kernels.reset_counts()
        threads = [threading.Thread(target=lambda: [kernels.count("modarith")
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert kernels.counts()["modarith"] == 16 * 2000
    finally:
        sys.setswitchinterval(old)
        kernels.reset_counts()

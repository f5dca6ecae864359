"""Port parity: slot-sharded tensor parallelism (parallel/tensor.py) on CPU
meshes that name the CPU 2, 4 and 8 times, bit-exact against the JAX
package's single-device results at tests/test_tensor.py's scale (ring 512,
mult_depth 5, seed 12, power-of-two rotation keys; the HyDia scenario at
vector_dim 64, chunk_len 16, 300 vectors, 8 shards).  The JAX references
run on one device (the JAX package's own TP test needs 4 and 8).  The
scenario runs the compare circuit at depth 8, as the JAX package's
sharding and streaming tests do at this scale: its JAX reference (one jit
of the index scenario, whose flags the JAX sender's own
``_membership_reduce`` sums) then compiles in ~100 s, against ~560 s for
two jits at depth 10.  Also: the plain split-stage transforms equal the whole ones for
every shard count with N/D >= D, a failing shard raises from the call
without hanging, and meshes the transform cannot split raise."""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.ckks.context import CkksContext as JCtx
from image_matching_tpu.ckks.params import SchemeParams, compute_required_depth, root_of_unity
from image_matching_tpu.matching.config import MatchConfig
from image_matching_tpu.matching.protocol import MatchingProtocol as JProto
from image_matching_tpu.utils import io as dio
from image_matching_tpu_torch.ckks.context import Ciphertext as TCt
from image_matching_tpu_torch.ckks.context import CkksContext as TCtx
from image_matching_tpu_torch.matching.protocol import MatchingProtocol as TProto
from image_matching_tpu_torch.ops import modmath as tmm
from image_matching_tpu_torch.ops import ntt as tntt
from image_matching_tpu_torch.parallel import sharded, tensor

from _torch_parity import assert_same, jax_noise, port_cfg, port_params, u32

RING = 512
SHARDS = (2, 4, 8)


def _mesh(d):
    return sharded.make_mesh(devices=["cpu"] * d)


def _port_ct(ct) -> TCt:
    return TCt(tmm.to_tensor(u32(ct.data), "cpu"), ct.scale)


@pytest.fixture(scope="module")
def pair():
    """The JAX context and the port's, one seed (identical keys), with the
    JAX single-device references of the op tests."""
    params = SchemeParams.create(ring_dim=RING, mult_depth=5, security="none")
    j = JCtx(params, seed=12)
    j.gen_power_of_two_rotation_keys()
    t = TCtx(port_params(params), seed=12, device="cpu", noise=jax_noise(params.sigma))
    t.gen_power_of_two_rotation_keys()
    assert_same(j.relin_key, t.relin_key)
    for (jp, jk), (tp, tk) in zip(j._rot_sets, t._rot_sets):
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        assert_same(jk, tk)
    rng = np.random.default_rng(1)
    a, b = j.encrypt(rng.uniform(-1, 1, j.slots)), j.encrypt(rng.uniform(-1, 1, j.slots))
    single = j.rescale_score(j.relinearize(j.mul(a, b)))
    lim = j.q_limbs(4)
    qs = np.asarray([int(j.q_np[i]) for i in lim])[:, None]
    x = (np.random.default_rng(0).integers(0, 2 ** 31, (len(lim), j.n)) % qs).astype(np.uint32)
    ref = dict(a=a, b=b, single=single, rot=j.binary_rotate(single, 3),
               sum=j.eval_sum(single, 8), lim=lim, x=x,
               fwd=np.asarray(j.plan.fwd(jnp.asarray(x), lim)),
               inv=np.asarray(j.plan.inv(jnp.asarray(x), lim)))
    return j, t, ref


@pytest.mark.parametrize("d", SHARDS)
def test_tp_ntt_matches_single(pair, d):
    _, t, ref = pair
    tp = tensor.TensorParallel(t, _mesh(d))
    x = tmm.to_tensor(ref["x"], "cpu")
    assert_same(ref["fwd"], tp.ntt_fwd(x, ref["lim"]))
    assert_same(ref["inv"], tp.ntt_inv(x, ref["lim"]))
    assert tp.ex.bytes["all_to_all"] > 0


@pytest.mark.parametrize("d", SHARDS)
def test_tp_ctmult_rotate_sum_match_single(pair, d):
    _, t, ref = pair
    tp = tensor.TensorParallel(t, _mesh(d))
    ta, tb = tp.shard_ct(_port_ct(ref["a"])), tp.shard_ct(_port_ct(ref["b"]))
    prod = tp.mul_relin_rescale(ta, tb)
    rot = tp.rotate(prod, 3)
    tsum = tp.eval_sum(prod, 8)
    assert prod.scale == ref["single"].scale
    assert rot.scale == ref["rot"].scale and tsum.scale == ref["sum"].scale
    assert_same(ref["single"].data, prod.data)
    assert_same(ref["rot"].data, rot.data)
    assert_same(ref["sum"].data, tsum.data)
    assert tp.ex.bytes["all_gather"] > 0  # the rotations' sources


def test_tp_scenario_membership_index_match_single():
    """The whole HyDia membership and index over 8 slot shards equal the
    JAX single-device sender's and the port's, and find the planted
    match."""
    cfg = MatchConfig(vector_dim=64, chunk_len=16, comp_depth=8)
    depth = compute_required_depth(5, cfg.comp_depth, cfg.alpha_depth)
    params = SchemeParams.create(ring_dim=RING, mult_depth=depth, security="none")
    query, db = dio.gen_dataset(300, 64, seed=7)
    jp = JProto.setup(5, db, cfg, ctx=JCtx(params, seed=7))
    tp = TProto.setup(5, db, port_cfg(cfg),
                      ctx=TCtx(port_params(params), seed=7, device="cpu",
                               noise=jax_noise(params.sigma)))
    jq, tq = jp.encrypt_query(query), tp.encrypt_query(query)
    assert_same(jq[0].data, tq[0].data)
    want_idx = jp.sender.run_index(jq)
    want_mem = jp.sender._membership_reduce(want_idx)  # run_membership's last step

    one_mem = tp.sender.run_membership(tq)
    scen = tensor.TPScenario(tp.sender, _mesh(8))
    got_mem = scen.membership(tq)
    got_idx = scen.index(tq)

    assert got_mem.scale == want_mem.scale == one_mem.scale
    assert_same(want_mem.data, got_mem.data)
    assert_same(want_mem.data, one_mem.data)
    assert tp.decrypt_membership(got_mem) is True
    assert len(got_idx) == len(want_idx)
    for g, w in zip(got_idx, want_idx):
        assert g.scale == w.scale
        assert_same(w.data, g.data)
    assert 0 in tp.decrypt_index(got_idx)


def _all_to_all(xs, split, cat):
    return [torch.stack([x.select(split, s) for x in xs], dim=cat) for s in range(len(xs))]


@pytest.mark.parametrize("n,nlimbs", [(512, 4), (32768, 2)])
def test_split_stages_equal_whole(n, nlimbs):
    """For every D with N/D >= D: the first log2 D stages over an
    all-to-all of the offsets inside a shard, then the rest on contiguous
    shards (the inverse mirrored, 1/N last), equal the whole plain
    transforms."""
    params = SchemeParams.create(ring_dim=n, mult_depth=11, security="none")
    primes = params.q_primes[:nlimbs]
    plan = tntt.NttPlan(n, primes, [root_of_unity(q, 2 * n) for q in primes], device="cpu")
    limbs = tuple(range(nlimbs))
    rng = np.random.default_rng(5)
    a = torch.tensor(np.stack([rng.integers(0, q, (2, n)) for q in primes], 1))
    want_f, want_i = plan.fwd(a.int(), limbs).long(), plan.inv(a.int(), limbs).long()
    q, L = plan.q.long(), nlimbs
    ninv = plan.ninv.long().view(L, 1)
    D = 1
    while D * D <= n:
        w, W = n // D, n // D // D
        loc = [a[..., s * w:(s + 1) * w] for s in range(D)]
        ys = _all_to_all([x.reshape(2, L, D, W) for x in loc], -2, -2)
        ys = [tntt.ntt_fwd_stages(y.reshape(2, L, w), plan.psis, q, 1, D, inner=W) for y in ys]
        xs = _all_to_all([y.reshape(2, L, D, W) for y in ys], -2, -2)
        got = [tntt.ntt_fwd_stages(x.reshape(2, L, w), plan.psis, q, D, n, nblk=D, blk=s)
               for s, x in enumerate(xs)]
        assert torch.equal(torch.cat(got, -1), want_f), D
        xs = [tntt.ntt_inv_stages(x, plan.ipsis, q, D, n, nblk=D, blk=s)
              for s, x in enumerate(loc)]
        ys = _all_to_all([x.reshape(2, L, D, W) for x in xs], -2, -2)
        ys = [tntt.ntt_inv_stages(y.reshape(2, L, w), plan.ipsis, q, 1, D, inner=W) * ninv % q.view(L, 1)
              for y in ys]
        got = _all_to_all([y.reshape(2, L, D, W) for y in ys], -2, -2)
        assert torch.equal(torch.cat([g.reshape(2, L, w) for g in got], -1), want_i), D
        D *= 2


def test_failing_shard_raises_and_does_not_hang(pair):
    """A shard whose key MAC raises makes the whole rotation raise that
    error; the other shards, waiting at the exchange, end too."""
    _, t, ref = pair
    tp = tensor.TensorParallel(t, _mesh(4))
    ct = _port_ct(ref["single"])

    def broken(*a, **k):
        raise RuntimeError("shard 2 failed")

    tp.shards[2]._ks_mac = broken
    box = {}

    def call():
        try:
            tp.rotate(ct, 1)
        except BaseException as e:  # noqa: B036 - recorded for the assertion
            box["err"] = e

    th = threading.Thread(target=call, daemon=True)
    th.start()
    th.join(timeout=90)
    assert not th.is_alive(), "the tensor-parallel call hung after a shard failed"
    assert isinstance(box.get("err"), RuntimeError) and "shard 2 failed" in str(box["err"])
    del tp.shards[2]._ks_mac  # the next call runs again, on fresh barriers
    assert_same(ref["rot"].data, tp.rotate(ct, 3).data)


def test_exchange_under_thread_stress(pair):
    """16 shards (more threads than cores) with a 1 us switch interval:
    20 sharded transforms each way stay bit-equal, and the exchange's byte
    count, a read-modify-write from every thread, loses no update."""
    _, t, ref = pair
    tp = tensor.TensorParallel(t, _mesh(16))
    x = tmm.to_tensor(ref["x"], "cpu")
    box = {}

    def work():
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            box["out"] = [(tp.ntt_fwd(x, ref["lim"]), tp.ntt_inv(x, ref["lim"]))
                          for _ in range(20)]
        finally:
            sys.setswitchinterval(old)

    th = threading.Thread(target=work, daemon=True)
    th.start()
    th.join(timeout=300)
    assert not th.is_alive() and "out" in box
    for fwd, inv in box["out"]:
        assert_same(ref["fwd"], fwd)
        assert_same(ref["inv"], inv)
    # each transform: two all-to-alls of int64 pieces, 15/16 of them crossing
    assert tp.ex.bytes["all_to_all"] == 20 * 2 * 2 * 15 * x.numel() // 16 * 8


def test_meshes_that_cannot_split_raise(pair):
    _, t, _ = pair
    with pytest.raises(ValueError, match="power of two"):
        tensor.TensorParallel(t, _mesh(3))
    with pytest.raises(ValueError, match="power of two"):
        tensor.TensorParallel(t, _mesh(32))  # N/D < D

"""Port parity: RNS residue arithmetic (B1) and the kernel loader.

The port's plain int64 versions against image_matching_tpu.ops.modmath on
random residues of every prime of a test chain: bit-exact."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.ckks.params import SchemeParams
from image_matching_tpu.ops import modmath as jmm
from image_matching_tpu_torch.ops import kernels
from image_matching_tpu_torch.ops import modmath as tmm

from _torch_parity import assert_same

PARAMS = SchemeParams.create(ring_dim=512, mult_depth=11, security="none")
PRIMES = PARAMS.q_primes + PARAMS.sp_primes
N = 257  # odd width: nothing relies on a power of two here
RNG = np.random.default_rng(17)


def _residues(shape=(3,), bound=None):
    """uint32 [*shape, L, N] with row i uniform below bound(q_i) (q_i by
    default)."""
    rows = [RNG.integers(0, bound(q) if bound else q, size=shape + (N,), dtype=np.int64)
            for q in PRIMES]
    return np.stack(rows, axis=-2).astype(np.uint32)


def _jq():
    q = np.array(PRIMES, dtype=np.uint32)[:, None]
    qneg = np.array([jmm.host_mont_constants(p)[0] for p in PRIMES], dtype=np.uint32)[:, None]
    return jnp.asarray(q), jnp.asarray(qneg)


def _tq():
    q = torch.tensor(PRIMES, dtype=torch.int64)[:, None]
    rinv = torch.tensor([tmm.host_rinv(p) for p in PRIMES], dtype=torch.int64)[:, None]
    return q, rinv


def _t(x):
    return tmm.to_tensor(x, "cpu")


@pytest.mark.parametrize("op", ["mont_mul", "shoup_mul", "mod_add", "mod_sub",
                                "mod_neg", "reduce_small"])
def test_elementwise_ops_bit_exact(op):
    a, b = _residues(), _residues()
    jq, jqneg = _jq()
    tq, trinv = _tq()
    if op == "mont_mul":
        # the first operand may be any 32-bit word below 2^31 (not reduced)
        a = _residues(bound=lambda q: 1 << 31)
        want = jmm.mont_mul(jnp.asarray(a), jnp.asarray(b), jq, jqneg)
        got = tmm.mont_mul(_t(a), _t(b), tq, trinv)
    elif op == "shoup_mul":
        w = b[0]  # one constant row per limb
        wsh = np.stack([jmm.host_shoup(w[i], q) for i, q in enumerate(PRIMES)])
        want = jmm.shoup_mul(jnp.asarray(a), jnp.asarray(w), jnp.asarray(wsh), jq)
        got = tmm.shoup_mul(_t(a), _t(w), tq)
    elif op == "mod_add":
        want, got = jmm.mod_add(jnp.asarray(a), jnp.asarray(b), jq), tmm.mod_add(_t(a), _t(b), tq)
    elif op == "mod_sub":
        want, got = jmm.mod_sub(jnp.asarray(a), jnp.asarray(b), jq), tmm.mod_sub(_t(a), _t(b), tq)
    elif op == "mod_neg":
        a[..., :5] = 0  # the zero branch
        want, got = jmm.mod_neg(jnp.asarray(a), jq), tmm.mod_neg(_t(a), tq)
    else:
        # transfer between primes of the chain: x < 16 q and x < 2^31
        a = _residues(bound=lambda q: min(16 * q, 1 << 31))
        want, got = jmm.reduce_small(jnp.asarray(a), jq), tmm.reduce_small(_t(a), tq)
    assert got.dtype == torch.int32
    assert_same(want, got)


@pytest.mark.parametrize("K", [1, 7, 64, 300])
def test_mont_dot_bit_exact(K):
    a, b = _residues((K,)), _residues((K,))
    jq, jqneg = _jq()
    p16 = jnp.asarray(np.stack([jmm.host_pow16_mont(p) for p in PRIMES], axis=1))[:, :, None]
    want = jmm.mont_dot(jnp.asarray(a), jnp.asarray(b), 0, jq, jqneg, p16)
    tq, trinv = _tq()
    assert_same(want, tmm.mont_dot(_t(a), _t(b), 0, tq, trinv, chunk=16))


def test_mont_dot_long_contraction_exact():
    """Beyond the JAX version's 2^16-term lane bound the plain version
    stays exact: compare with python integers."""
    q = PRIMES[0]
    K = 70000
    a = RNG.integers(q - 1000, q, size=(K, 1, 1)).astype(np.uint32)
    b = RNG.integers(q - 1000, q, size=(K, 1, 1)).astype(np.uint32)
    want = sum(int(x) * int(y) for x, y in zip(a.ravel(), b.ravel())) % q
    want = want * pow(1 << 32, -1, q) % q
    got = tmm.mont_dot(_t(a), _t(b), 0, torch.tensor([[q]]),
                       torch.tensor([[tmm.host_rinv(q)]]), chunk=4096)
    assert int(got.ravel()[0]) == want


@pytest.mark.parametrize("q", [PRIMES[0], PRIMES[-1], 2147483647])
def test_host_helpers_match(q):
    x = RNG.integers(0, q, size=64).astype(np.uint32)
    assert tmm.host_mont_constants(q) == jmm.host_mont_constants(q)
    np.testing.assert_array_equal(tmm.host_to_mont(x, q), jmm.host_to_mont(x, q))
    np.testing.assert_array_equal(tmm.host_from_mont(x, q), jmm.host_from_mont(x, q))
    np.testing.assert_array_equal(tmm.host_shoup(x, q), jmm.host_shoup(x, q))
    np.testing.assert_array_equal(tmm.host_pow16_mont(q), jmm.host_pow16_mont(q))
    assert tmm.host_rinv(q) * (1 << 32) % q == 1


def test_tensor_views_keep_bits():
    x = _residues()
    t = tmm.to_tensor(x, "cpu")
    assert t.dtype == torch.int32 and int(t.min()) >= 0
    np.testing.assert_array_equal(tmm.to_numpy(t), x)


def test_port_never_imports_jax():
    """Importing every module of the port leaves jax out of sys.modules
    (the machine with the GPU has no jax)."""
    root = Path(__file__).resolve().parents[1]
    mods = sorted(
        ".".join(p.relative_to(root).with_suffix("").parts)
        for p in (root / "image_matching_tpu_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
            "assert not bad, bad\n"
            "print(len(" + repr(mods) + "))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 12


def test_kernel_sources_and_hash():
    names = {p.name for p in kernels.sources()}
    assert {"ntt.cu", "ct_dot.cu", "basis_convert.cu", "keyswitch.cu",
            "modmath.cuh"} <= names
    h = kernels.source_hash()
    assert h == kernels.source_hash() and len(h) == 16
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


def test_cpu_tensors_never_launch_kernels():
    """The plain versions serve CPU tensors; the launch counters only move
    where a kernel is launched."""
    from image_matching_tpu_torch.ops.ntt import NttPlan
    from image_matching_tpu.ckks.params import root_of_unity

    before = kernels.counts()
    primes = PRIMES[:2]
    plan = NttPlan(512, primes, [root_of_unity(q, 1024) for q in primes], device="cpu")
    x = torch.zeros((2, 512), dtype=torch.int32)
    plan.inv(plan.fwd(x, (0, 1)), (0, 1))
    assert kernels.counts() == before
    assert set(before) == set(kernels.KERNELS)


def test_launch_checks_reject_cpu_and_wrong_dtype():
    with pytest.raises(ValueError):
        kernels.check_cuda("t", torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.check_cuda("t", torch.zeros(4, dtype=torch.int64))


def _moduli():
    q, rinv = _tq()
    consts = [jmm.host_mont_constants(p) for p in PRIMES]
    return tmm.Moduli(q, rinv, *(tmm.to_tensor(np.array(col, dtype=np.uint32), "cpu")
                                 for col in (PRIMES, *list(zip(*consts))[:3])))


@pytest.mark.parametrize("form", ["same", "plane", "limb", "head"])
@pytest.mark.parametrize("op", ["add", "sub", "neg", "mul"])
def test_residue_op_plain_bit_exact(op, form):
    """K11's plain entry point (the CPU side of its dispatch) against the
    JAX package's mod_add / mod_sub / mod_neg / mont_mul, with the second
    operand of the first's shape, a plaintext plane broadcast over the
    leading axes, a per-limb constant, or on the first component only."""
    a, b = _residues((2, 3)), _residues((2, 3))
    jq, jqneg = _jq()
    m = _moduli()
    jfn = {"add": lambda x, y: jmm.mod_add(x, y, jq), "sub": lambda x, y: jmm.mod_sub(x, y, jq),
           "neg": lambda x, y: jmm.mod_neg(x, jq),
           "mul": lambda x, y: jmm.mont_mul(x, y, jq, jqneg)}[op]
    head = None
    if form == "same":
        y, jy = _t(b), jnp.asarray(b)
    elif form == "plane":
        y, jy = _t(b[0, 0]), jnp.asarray(b[0, 0])[None, None]
    elif form == "limb":
        c = b[0, 0, :, :1]  # [L, 1]
        y, jy = (_t(c).long() & 0xFFFFFFFF, _t(c[:, 0])), jnp.asarray(c)
    else:
        a, b, head = a[0], b[0, :1], 1
        y, jy = _t(b), jnp.asarray(b)
    got = tmm.residue_op(op, _t(a), y, m, head=head)
    want = jfn(jnp.asarray(a), jy)
    if head is not None:
        want = jnp.concatenate([want[:head], jnp.asarray(a)[head:]])
    assert_same(want, got)


@pytest.mark.parametrize("R", [1, 2, 15, 128])
def test_row_sum_plain_bit_exact(R):
    """K11's row sum on the CPU against the JAX package's chain of
    mod_adds (senders._mod_sum_rows)."""
    from image_matching_tpu.matching.senders import _mod_sum_rows

    rows = _residues((R, 2))
    jq, _ = _jq()
    assert_same(_mod_sum_rows(jnp.asarray(rows), jq), tmm.row_sum(_t(rows), _moduli()))

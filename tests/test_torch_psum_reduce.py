"""K12 (``csrc/psum_mod.cu``), the modular sum of shard partials, emulated
in numpy uint64 behind the port's own wrapper.

No GPU is needed: ``sharded.psum_mod_kernel`` runs as it does on the card
(the chunked walk of a list longer than ``PSUM_CAP``, the buffers'
addresses, row counts and limb constants in host arrays), on CPU tensors,
with its launch replaced by an emulation of the kernel that reads those
host arrays and the buffers through their addresses, as the kernel reads
its struct parameter: the grid (V = 4 residues an access where every
buffer and the output are 16-byte aligned, else V = 1; G row groups, the
least of 4, 8 and 16 that gives ``PASS_MIN_BLOCKS`` blocks), each group's
rows with a buffer cursor that only moves forward, four rows at a time,
the 64-bit partials joined and reduced as mont(hi, R^2) + mont(lo, R), the
limb from a shift; every output element is written exactly once.  Held
bit-exact against ``psum_mod_plain`` and, through partial sums, against the
JAX package's ``psum_mod`` under shard_map (conftest's 8 virtual CPU
devices), on HyDia's ring-32768 flag primes, with every residue at q - 1,
P below, at and above the cap, one-row and many-row buffers, views not on
a 16-byte boundary (V = 1), and the reduction at the stated limit (sums of
up to 2^33 - 1 residues below 2^31)."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as JP

from image_matching_tpu.ckks.params import SchemeParams, compute_required_depth
from image_matching_tpu.ops import modmath as jmm
from image_matching_tpu.parallel import sharded as jsharded
from image_matching_tpu_torch.ops import kernels
from image_matching_tpu_torch.parallel import sharded

from _torch_parity import assert_same, u32
from test_torch_resid_reduce import Out, sum_reduce

K12_THREADS, K12_CAP, K12_MAX_LIMBS = 128, 64, 64  # csrc/psum_mod.cu
PASS_MIN_BLOCKS, MAX_GRID_Y = 528, 65535           # csrc/passgrid.cuh
N = 512
RNG = np.random.default_rng(12)
PRIMES = SchemeParams.create(mult_depth=compute_required_depth(5, 10, 2)).q_primes


def host_array(addr, ctype, count):
    return np.ctypeslib.as_array((ctype * count).from_address(addr)).copy()


def grid(plane_v, B):
    """psum_mod.cu launch_v: (row groups G, blocks x, blocks y)."""
    by = min(B, MAX_GRID_Y)
    for G in (4, 8, 16):
        bx = -(-plane_v // (K12_THREADS // G))
        if bx * by >= PASS_MIN_BLOCKS or G == 16:
            return G, bx, by


def emulate_launch(launches):
    """A stand-in for ``kernels.launch`` that runs imtpu_psum_mod on CPU
    tensors in numpy; appends (P, V, G) of each launch to ``launches``."""

    def launch(entry, counter, out, addrs, rows, P, total, l, n, consts):
        assert (entry, counter) == ("imtpu_psum_mod", "psum_mod")
        assert 1 <= P <= K12_CAP and 1 <= l <= K12_MAX_LIMBS and total % (l * n) == 0
        a = host_array(addrs, ctypes.c_int64, P)
        r = host_array(rows, ctypes.c_int64, P)
        c = host_array(consts, ctypes.c_uint32, 4 * l).astype(np.uint64).reshape(4, l)
        start = np.concatenate([[0], np.cumsum(r)]).astype(np.int64)
        R = int(start[P])
        assert R < 2 ** 31
        bufs = [np.ctypeslib.as_array((ctypes.c_uint32 * max(1, int(r[p]) * total))
                                      .from_address(int(a[p]))).astype(np.uint64)
                for p in range(P)]
        V = 4 if n % 4 == 0 and out.data_ptr() % 16 == 0 and all(x % 16 == 0 for x in a) else 1
        B, plane_v = total // (l * n), l * n // V
        lg = (n // V).bit_length() - 1
        G, bx, by = grid(plane_v, B)
        VB = K12_THREADS // G
        j = np.arange(bx * VB)
        j = j[j < plane_v]  # the live lanes of every block
        e, limb = j * V, j >> lg
        res = Out(B, l, n)
        for y in range(by):
            for blk in range(y, B, by):
                for v in range(V):
                    parts = []
                    for grp in range(G):
                        s, p = np.zeros(e.shape, np.uint64), 0
                        for r0 in range(grp, R, 4 * G):
                            for u in range(4):
                                g = r0 + u * G
                                if g < R:
                                    while g >= start[p + 1]:
                                        p += 1
                                    s = s + bufs[p][(g - start[p]) * total + blk * l * n + e + v]
                        parts.append(s)
                    s = sum(parts[1:], parts[0])
                    val = np.empty(e.shape, np.uint64)
                    for i in np.unique(limb):
                        sel = limb == i
                        val[sel] = sum_reduce(s[sel], int(c[0, i]), int(c[1, i]), int(c[2, i]),
                                              int(c[3, i]))
                    res.put(blk * l * n + e + v, val)
        out.copy_(res.done(tuple(out.shape)))
        launches.append((P, V, G))
        kernels.count(counter)

    return launch


@pytest.fixture
def emulated(monkeypatch):
    """psum_mod_kernel on CPU tensors with the emulated launch; yields
    the list of (P, V, G) of its launches."""
    launches = []
    monkeypatch.setattr(kernels, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "launch", emulate_launch(launches))
    yield launches


def _parts(counts, l, top=False, n=N):
    """Buffers [R, 2, l, n] of random residues of the first l primes, or
    all q - 1."""
    q = np.array(PRIMES[:l], np.uint64)[:, None]
    out = []
    for R in counts:
        x = (np.broadcast_to(q - 1, (R, 2, l, n)) if top
             else RNG.integers(0, 2 ** 62, (R, 2, l, n), dtype=np.uint64) % q)
        out.append(torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint32).view(np.int32)))
    return out


def _misaligned(t):
    """t's values in a buffer that starts 4 bytes past a 16-byte boundary."""
    raw = torch.empty(t.numel() + 4, dtype=torch.int32)
    off = next(o for o in range(4) if (raw.data_ptr() + 4 * o) % 16 == 4)
    v = raw[off:off + t.numel()].view(t.shape)
    v.copy_(t)
    return v


def _q(l):
    return torch.tensor(PRIMES[:l], dtype=torch.int64)[:, None]


def _jax_psum(parts, l):
    """JAX psum_mod under shard_map over up to 8 virtual devices, each
    device holding the sum mod q of its share of the parts."""
    D = min(8, len(parts))
    shares = [sharded.psum_mod_plain(parts[i::D], _q(l)) for i in range(D)]
    primes = PRIMES[:l]
    q = np.array(primes, np.uint32)[:, None]
    qneg = np.array([jmm.host_mont_constants(p)[0] for p in primes], np.uint32)[:, None]
    p16 = np.stack([jmm.host_pow16_mont(p) for p in primes], axis=1)[:, :, None]
    mesh = JMesh(np.array(jax.devices()[:D]), ("db",))
    fn = jax.jit(jax.shard_map(
        lambda a: jsharded.psum_mod(a[0], jnp.asarray(q), jnp.asarray(qneg),
                                    jnp.asarray(p16), "db"),
        mesh=mesh, in_specs=(JP("db"),), out_specs=JP(), check_vma=False))
    return np.asarray(fn(np.stack([u32(s) for s in shares])))


def test_reduction_exact_at_the_stated_limit():
    """mont(hi, R^2) + mont(lo, R) == s mod q for every 64-bit sum K12 can
    form: up to 2^33 - 1 residues below 2^31, and the extremes, on every
    prime of the chain."""
    for q in PRIMES:
        qneg, r1, r2, _ = jmm.host_mont_constants(q)
        top = ((1 << 33) - 1) * ((1 << 31) - 1)  # below 2^64
        s = [0, 1, q - 1, q, (1 << 32) - 1, 1 << 32, ((1 << 33) - 1) * (q - 1), top,
             (1 << 64) - 1]
        s += [int(v) for v in RNG.integers(0, top, size=64, dtype=np.uint64)]
        got = sum_reduce(np.array(s, np.uint64), q, qneg, r1, r2)
        assert got.tolist() == [v % q for v in s], q


@pytest.mark.parametrize("counts,form", [
    ([16] * 4, "random"), ([1] * 4, "random"), ([1] * 8, "random"), ([16], "random"),
    ([3, 1, 5, 1, 2], "random"), ([1] * 8, "q - 1"), ([16] * 4, "q - 1"),
    ([2, 7, 1], "misaligned"), ([1] * 3, "one misaligned")])
@pytest.mark.parametrize("l", [2, 14])
def test_launch_matches_plain_and_jax(emulated, counts, form, l):
    """One launch (P below the cap) over [2, l, N] blocks: chip_smoke's
    shapes (4 x 16 rows, 4 x 1, 8 x 1, 1 x 16) and unequal counts, every
    residue at q - 1, and buffers off a 16-byte boundary (V = 1), against
    psum_mod_plain and JAX's psum_mod."""
    parts = _parts(counts, l, top=form == "q - 1")
    if form == "misaligned":
        parts = [_misaligned(p) for p in parts]
    elif form == "one misaligned":
        parts[1] = _misaligned(parts[1])
    got = sharded.psum_mod_kernel(parts, PRIMES[:l])
    assert len(emulated) == 1 and emulated[0][1] == (1 if "misaligned" in form else 4)
    want = sharded.psum_mod_plain(parts, _q(l))
    assert_same(got, want)
    assert_same(got, _jax_psum(parts, l))


@pytest.mark.parametrize("P", [K12_CAP - 1, K12_CAP, K12_CAP + 1, 2 * K12_CAP + 5])
def test_list_past_the_cap_reduces_in_chunks(emulated, P):
    """P one-row buffers below, at and past the cap (and past twice the
    cap), all q - 1 in every other buffer: the wrapper's chunks, each
    chunk's sum appended as one more one-row buffer, give the same sum."""
    parts = _parts([1] * P, 2, top=False)
    for i in range(0, P, 2):
        parts[i] = _parts([1], 2, top=True)[0]
    got = sharded.psum_mod_kernel(parts, PRIMES[:2])
    expect, left = [], P
    while left > K12_CAP:
        expect.append(K12_CAP)
        left -= K12_CAP - 1
    assert [x[0] for x in emulated] == expect + [left]
    want = sharded.psum_mod_plain(parts, _q(2))
    assert_same(got, want)
    assert_same(got, _jax_psum(parts, 2))


def test_small_plane_takes_more_row_groups(emulated):
    """A plane too small for PASS_MIN_BLOCKS blocks of 32 vectors splits
    its rows over 8 or 16 groups of fewer lanes: the same sums."""
    for n, G in ((N, 16), (32768, 8), (65536, 4)):
        emulated.clear()
        parts = _parts([5, 3], 1, n=n)
        got = sharded.psum_mod_kernel(parts, PRIMES[:1])
        assert emulated[0][2] == G, (n, emulated)
        assert_same(got, sharded.psum_mod_plain(parts, _q(1)))


def test_limb_constants_host_array():
    """The constants K12 takes by value: q, -q^-1 mod 2^32, R mod q and
    R^2 mod q of each limb, as the JAX package computes them."""
    c = np.ctypeslib.as_array(sharded._limb_consts(tuple(PRIMES))).reshape(4, -1)
    for i, q in enumerate(PRIMES):
        qneg, r1, r2, _ = jmm.host_mont_constants(q)
        assert c[:, i].tolist() == [q, qneg, r1, r2]

"""Batched decryption: ``CkksContext._decrypt_many`` and the receivers that
decrypt their lists through it, and K9's decrypt MAC pass
(``csrc/tensor.cu``) over a list of ciphertext addresses, emulated.

At ring 512 with the JAX context's keys carried into the port
(``utils/carry.py``): ``_decrypt_many`` over lists of 2- and 3-component
ciphertexts, mixed levels in one list (grouped by components and limbs,
each a view of a higher-level ciphertext) and lists past the kernel's cap
equal one-at-a-time decryption (``decrypt_coeffs``) and the JAX context's
``decrypt_coeffs``; every receiver's ``decrypt_index`` and
``decrypt_scores`` equal the same receiver decrypting one ciphertext at a
time and the JAX package's receivers.  Residues are bit-exact; decoded
slots are equal, since both packages decode in numpy.

No GPU is needed for the kernel either: ``ctx._decrypt_mac`` runs as on
the card (the chunks of ``DECRYPT_CAP`` addresses in a host array, the
copies of blocks that lack unit coefficient stride, limb stride N or the
list's component stride), on CPU tensors, with its launch replaced by an
emulation that reads the ciphertexts, the key and the primes through
their addresses and repeats the kernel's grid (passgrid.cuh's
limb_split_grid: V = 4 residues an access where every operand is 16-byte
aligned, else V = 1; the ciphertexts over y, the limbs over z in chunks)
and its arithmetic in numpy uint64; every output element is written
exactly once.  Held bit-exact against ``decrypt_mac_plain``."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_matching_tpu.ckks.context import Ciphertext as JCt
from image_matching_tpu.ckks.context import CkksContext as JCtx
from image_matching_tpu.ckks.params import SchemeParams, compute_required_depth
from image_matching_tpu.matching import receivers as jrecv
from image_matching_tpu.matching.config import MatchConfig
from image_matching_tpu_torch.ckks import context as tc
from image_matching_tpu_torch.ckks.context import Ciphertext as TCt
from image_matching_tpu_torch.ckks.context import CkksContext as TCtx
from image_matching_tpu_torch.matching import receivers as trecv
from image_matching_tpu_torch.ops import kernels

from _torch_parity import assert_same, carry_context, port_cfg, port_params, u32
from test_torch_resid_reduce import Out, limb_split_grid, mod_add, mont, thread_coeffs

CAP = 64  # csrc/tensor.cu K9_CAP
CFG = MatchConfig(vector_dim=64, chunk_len=16, comp_depth=8)
RNG = np.random.default_rng(9)


@pytest.fixture(scope="module")
def pair():
    """The JAX context and the port's on the CPU, the JAX keys carried in."""
    params = SchemeParams.create(ring_dim=512, security="none",
                                 mult_depth=compute_required_depth(5, CFG.comp_depth))
    jctx = JCtx(params, seed=5)
    tctx = TCtx(port_params(params), seed=6, device="cpu")
    carry_context(jctx, tctx)
    return jctx, tctx


def _encrypt(tctx, vals):
    """Fresh ciphertexts of the rows of vals at the top level."""
    data = tctx.encrypt_batch(np.asarray(vals, np.float64))
    return [TCt(data[i], tctx.fresh_scale) for i in range(len(vals))]


def _cts(tctx, kind):
    """A list of port ciphertexts: "top" (k = 2 at the top level), "mixed"
    (k = 2 and 3 at 1 and 2 limbs, interleaved: views of top-level
    ciphertexts and tensor products), or "past the cap" (CAP + 6)."""
    count = CAP + 6 if kind == "past the cap" else 6
    cts = _encrypt(tctx, RNG.uniform(-1, 1, (count, tctx.slots)))
    if kind == "top":
        return cts
    out = []
    for i, ct in enumerate(cts):
        l = 1 + i % 2
        if i % 3 == 2:  # a tensor product: 3 components at scale^2
            x = ct.data[:, :l]
            out.append(TCt(tctx._tensor(x, x), ct.scale ** 2))
        else:
            out.append(TCt(ct.data[:, :l], ct.scale))
    return out


def _jax(ct):
    return JCt(jnp.asarray(u32(ct.data)), ct.scale)


@pytest.mark.parametrize("kind", ["top", "mixed", "past the cap"])
def test_decrypt_many_matches_one_at_a_time_and_jax(pair, kind):
    jctx, tctx = pair
    cts = _cts(tctx, kind)
    got = tctx._decrypt_many(cts)
    assert len(got) == len(cts)
    for g, ct in zip(got, cts):
        assert np.array_equal(g, tctx.decrypt_coeffs(ct))
        assert np.array_equal(g, np.asarray(jctx.decrypt_coeffs(_jax(ct))))
    assert tctx._decrypt_many([]) == []


def _flag_vals(tctx, count, hits):
    """count rows of slot values below 1 with 1.5 at (row, slot) of hits."""
    vals = RNG.uniform(-0.5, 0.5, (count, tctx.slots))
    for r, s in hits:
        vals[r, s] = 1.5
    return vals


@pytest.mark.parametrize("approach", [1, 2, 3, 4, 5])
def test_receivers_match_one_at_a_time_and_jax(pair, approach, monkeypatch):
    """decrypt_index and decrypt_scores of each approach's receiver over a
    list (GROTE: its rows and columns; past the cap for HERS) equal JAX's
    receiver and the same receiver decrypting one ciphertext at a time."""
    jctx, tctx = pair
    slots = tctx.slots
    count = CAP + 3 if approach == 4 else 3
    num = slots * count
    if approach == 2:  # GROTE: n_row + n_col ciphertexts for num vectors
        num = slots * slots // 2
        row_len = 2 ** int(np.ceil(np.log2(slots) / 2))
        n_score = -(-num // slots)
        count = -(-n_score // row_len) + -(-n_score // (slots // row_len))
    hits = [(0, 0), (count // 2, slots - 1), (count - 1, 5)]
    cts = _encrypt(tctx, _flag_vals(tctx, count, hits))
    jcts = [_jax(c) for c in cts]
    trc = trecv.make_receiver(approach, tctx, port_cfg(CFG), num)
    jrc = jrecv.make_receiver(approach, jctx, CFG, num)
    idx, scores = trc.decrypt_index(cts), trc.decrypt_scores(cts)
    assert idx == jrc.decrypt_index(jcts)
    assert np.array_equal(scores, jrc.decrypt_scores(jcts))
    if approach in (1, 4, 5):
        assert idx == [r * slots + s for r, s in hits]
    monkeypatch.setattr(trecv, "decrypt_all", lambda ctx, cs: [ctx.decrypt(c) for c in cs])
    assert trc.decrypt_index(cts) == idx
    assert np.array_equal(trc.decrypt_scores(cts), scores)


# ---------------------------------------------------------------------------
# K9's decrypt MAC over an address list, emulated
# ---------------------------------------------------------------------------


def _host(addr, count, ctype=ctypes.c_uint32):
    return np.ctypeslib.as_array((ctype * count).from_address(addr)).astype(np.uint64)


def emulate_launch(launches):
    """A stand-in for ``kernels.launch`` that runs imtpu_decrypt_mac on CPU
    tensors in numpy; appends (B, V, per) of each launch."""

    def launch(entry, counter, out, cts, B, cstride, k, s, qs, qneg, l, n):
        assert (entry, counter) == ("imtpu_decrypt_mac", "decrypt_mac")
        assert 1 <= B <= CAP and 1 <= k <= 3 and out.is_contiguous()
        addrs = [int(a) for a in _host(cts, B, ctypes.c_int64)]
        V = 4 if (n % 4 == 0 and (k == 1 or cstride % 4 == 0) and out.data_ptr() % 16 == 0
                  and s % 16 == 0 and all(a % 16 == 0 for a in addrs)) else 1
        bx, by, bz, per = limb_split_grid(B, l, n, V)
        assert by == B
        key, q, qn = _host(s, l * n), _host(qs, l), _host(qneg, l)
        res = Out(B, l, n)
        c = thread_coeffs(bx, n, V)
        for b, a in enumerate(addrs):
            d = _host(a, (k - 1) * cstride + l * n)
            for z in range(bz):
                for i in range(z * per, min(l, (z + 1) * per)):
                    for v in range(V):
                        p = i * n + c + v
                        sv, m = key[p], d[p]
                        spow = sv
                        for j in range(1, k):
                            m = mod_add(m, mont(d[j * cstride + p], spow, q[i], qn[i]), q[i])
                            if j + 1 < k:
                                spow = mont(spow, sv, q[i], qn[i])
                        res.put((b * l + i) * n + c + v, mont(m, 1, q[i], qn[i]))
        out.copy_(res.done(tuple(out.shape)))
        launches.append((B, V, per))
        kernels.count(counter)

    return launch


@pytest.fixture
def emulated(monkeypatch):
    launches = []
    monkeypatch.setattr(kernels, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "launch", emulate_launch(launches))
    yield launches


def _blocks(tctx, B, k, l, form):
    """B ciphertext blocks [k, l, N] of random residues: "plain"
    (separate allocations), "views" (limb slices of [k, Lq, N] blocks:
    component stride Lq N), "mixed strides" (views and plain), "strided
    coefficients" (every other coefficient) or "misaligned" (4 bytes
    past a 16-byte boundary)."""
    q = tctx.q64[:tctx.Lq, None]
    out = []
    for b in range(B):
        full = (torch.from_numpy(RNG.integers(0, 2 ** 62, (k, tctx.Lq, 2 * tctx.n))) % q).int()
        x = full[:, :, ::2]
        if form == "views" or (form == "mixed strides" and b % 2):
            x = x.contiguous()[:, :l]
        elif form == "strided coefficients":
            x = full[:, :l, ::2]
        else:
            x = x[:, :l].contiguous()
        if form == "misaligned":
            raw = torch.empty(x.numel() + 4, dtype=torch.int32)
            off = next(o for o in range(4) if (raw.data_ptr() + 4 * o) % 16 == 4)
            x = raw[off:off + x.numel()].view(x.shape).copy_(x)
        out.append(x)
    return out


@pytest.mark.parametrize("B,k,l,form", [
    (1, 2, 2, "plain"), (1, 3, None, "plain"), (1, 1, 3, "plain"), (64, 2, 2, "plain"),
    (CAP + 6, 2, 2, "views"), (5, 3, 4, "mixed strides"), (3, 2, 5, "strided coefficients"),
    (4, 2, 3, "misaligned"), (2, 3, 2, "misaligned")])
def test_decrypt_mac_launch_matches_plain(pair, emulated, B, k, l, form):
    """K9's decrypt MAC over B separate ciphertexts: one launch up to the
    cap and one more past it, the membership's and the flags' shapes (B =
    1, 64 at [2, 2, N]), the table's [3, l, N] at the top level (l None),
    limb-slice views, blocks copied for their strides, V = 1 for
    misaligned blocks."""
    _, tctx = pair
    l = l or tctx.Lq
    blocks = _blocks(tctx, B, k, l, form)
    got = tctx._decrypt_mac(blocks)
    assert [x[0] for x in emulated] == [min(CAP, B - i) for i in range(0, B, CAP)]
    assert all(x[1] == (1 if form == "misaligned" else 4) for x in emulated)
    want = tc.decrypt_mac_plain(tctx, torch.stack([b.contiguous() for b in blocks]))
    assert_same(got, want)
    assert_same(tctx.plan.inv_plain(got, tctx.q_limbs(l)),
                tc.decrypt_plain(tctx, torch.stack([b.contiguous() for b in blocks])))

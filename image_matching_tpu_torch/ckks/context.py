"""CKKS crypto context on torch: key generation, encryption and the
leveled evaluator with hybrid key switching (port of
image_matching_tpu/ckks/context.py).

Everything on the device is int32 RNS residues (bit-identical to the JAX
package's uint32) in Montgomery form, evaluation (NTT) domain, held on the
context's ``torch.device``.  Key generation is host numpy drawing from
``np.random.default_rng(seed)`` in the JAX package's order, so both
packages hold identical keys for one seed.  Encryption noise comes from a
``torch.Generator`` seeded by the same numpy draw that the JAX package
turns into a ``jax.random`` key; a ``noise`` callable replaces it (the
parity tests feed the JAX package's noise through it).

Key switching is hybrid with ``dnum`` digits over the full RNS basis.  On
CUDA tensors every step is a hand-written kernel: the NTT (K1, in
``ops/ntt.py``, which also gathers a rotation's c1 through its
automorphism on the way in), fast base conversion (K3, ``_fbc``, with the
mod-down's centred form), the digit decomposition (K8,
``_decompose_extended``), the key multiply-accumulate with the hoisted
digits' gather (K4, ``_ks_mac``) and the division by P (K7, ``_moddown``),
whose last pass also adds a rotation's gathered c0 or a relinearization's
input.  Rescale is K1 and K7; the tensor product and decryption's MAC are
K9; public-key encryption is K10 around K1.  Each has its plain torch
version here (``fbc_plain``, ``rescale_plain``, ``moddown_plain``, ...),
used for CPU tensors: there is no fallback from one to the other.  The
JAX package's ``vmap``/``scan`` over rotations become an explicit leading
batch axis or a Python loop.

Seed-compressed (symmetric) encryption of streamed DB groups keeps only
c0; c1 is regenerated from a Threefry stream (``ops/prng.py``, kernel K5).
Its two passes around the NTT are kernel K6 (``_seeded_pre``,
``_seeded_c0``).  Its noise comes from a ``torch.Generator`` seeded by the
numpy draw the JAX package turns into its ``jax.random`` key; a
``seeded_noise`` callable replaces it.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import kernels
from ..ops import modmath as mm
from ..ops import prng
from ..ops.ntt import NttPlan, host_ntt_fwd, permute_rows
from ..utils import native
from . import encoding
from .params import SchemeParams, root_of_unity

R = mm.R

# noise(seed, batch, n) -> (v, e0, e1) signed integer arrays [batch, n]
NoiseFn = Callable[[int, int, int], Tuple[np.ndarray, np.ndarray, np.ndarray]]
# seeded_noise(seed, batch, n) -> e, a signed integer array [batch, n]
SeededNoiseFn = Callable[[int, int, int], np.ndarray]


@dataclasses.dataclass
class Ciphertext:
    """RNS-CKKS ciphertext: data [k, l, N] (k components, l limbs) in
    Montgomery/eval form.  ``scale`` is exact metadata."""

    data: torch.Tensor
    scale: float

    @property
    def limbs(self) -> int:
        return self.data.shape[-2]

    @property
    def ncomp(self) -> int:
        return self.data.shape[-3]


@dataclasses.dataclass
class Plaintext:
    data: torch.Tensor  # [l, N] eval Montgomery
    scale: float


def _sample_gauss(rng, n, sigma):
    return np.rint(rng.normal(0.0, sigma, size=n)).astype(np.int64)


def _sample_ternary(rng, n):
    return rng.integers(-1, 2, size=n).astype(np.int64)


# ---------------------------------------------------------------------------
# K3: fast base conversion — constants and plain version
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FbcConsts:
    """Constants of one (source basis -> target basis) conversion, as
    device tensors for the plain version plus one packed buffer for the
    kernel."""

    qs: torch.Tensor       # int64 [g, 1] source primes
    rinv_s: torch.Tensor   # int64 [g, 1] R^{-1} mod q_i
    qd: torch.Tensor       # int64 [t, 1] target primes
    rinv_d: torch.Tensor
    t_std: torch.Tensor    # int64 [g, 1] y_i = x_i * t_i (standard-form multiplier)
    qhat: torch.Tensor     # int64 [g, t] (Qhat_i * R^2) mod p
    qg_r2: torch.Tensor    # int64 [t, 1] (Q * R^2) mod p
    inv_q: torch.Tensor    # float32 [g] 1/q_i
    packed: torch.Tensor   # int32: fbc_pack_targets, then qs, qnegs, t_std, inv_q


FBC_TW = 12  # words per target in the kernel's constants (csrc/fbc.cuh)


def fbc_pack_targets(src_p: Sequence[int], dst_p: Sequence[int],
                     qneg_d: np.ndarray) -> np.ndarray:
    """The kernel's per-target constants (csrc/fbc.cuh), uint32 [t *
    FBC_TW]: for each target prime p, c_i = Qhat_i R^3 mod p for the g <= 8
    source primes (zero-padded to 8), c_v = -Q R^3 mod p, p, -p^-1 mod 2^32
    and a zero.  One 64-bit sum of y_i c_i and v c_v and two Montgomery
    steps give (sum_i y_i Qhat_i - v Q) R mod p."""
    Q = math.prod(src_p)
    out = np.zeros((len(dst_p), FBC_TW), dtype=np.uint32)
    for j, p in enumerate(dst_p):
        r3 = R ** 3 % p
        out[j, :len(src_p)] = [(Q // q) % p * r3 % p for q in src_p]
        out[j, 8:11] = (-Q * r3 % p, p, qneg_d[j])
    return out.ravel()


def fbc_plain(x: torch.Tensor, c: FbcConsts, pre: Optional[torch.Tensor] = None,
              post: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain fast base conversion of coefficient-domain Montgomery residues
    [..., g, N] (source basis) -> [..., t, N] (target basis).  The float32
    sum runs in index order, one rounding per product and per sum, as
    XLA's reduction does; torch.round rounds half to even like jnp.round.
    The centred form (the mod-down) adds ``pre`` (int64 [g, 1]) to the
    input and subtracts ``post`` (int64 [t, 1]) from the output."""
    if pre is not None:
        x = mm.mod_add(x, pre, c.qs)
    y = mm.mont_mul(x, c.t_std, c.qs, c.rinv_s)  # standard form
    yf = y.float()
    g = y.shape[-2]
    acc = yf[..., 0, :] * c.inv_q[0]
    for i in range(1, g):
        acc = acc + yf[..., i, :] * c.inv_q[i]
    v = torch.round(acc).long()
    out = None
    for i in range(g):
        term = mm.mont_mul(y[..., i:i + 1, :], c.qhat[i][:, None], c.qd, c.rinv_d)
        out = term if out is None else mm.mod_add(out, term, c.qd)
    corr = mm.mont_mul(v[..., None, :], c.qg_r2, c.qd, c.rinv_d)
    out = mm.mod_sub(out, corr, c.qd)
    return out if post is None else mm.mod_sub(out, post, c.qd)


# ---------------------------------------------------------------------------
# K4: key-switching multiply-accumulate — plain version
# ---------------------------------------------------------------------------


def ks_mac_plain(digs: torch.Tensor, ksk: torch.Tensor, l: int, Lq: int,
                 q: torch.Tensor, rinv: torch.Tensor,
                 perms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[r, c] = sum_j digs[r, j][..., perm_r] * ksk[r, j, c][rows]  mod p.

    digs: [ndig, E, N] (shared) or [R, ndig, E, N]; ksk: [dnum, 2, Ltot, N]
    (shared) or [R, dnum, 2, Ltot, N]; perms: None or int32 [R, N];
    q, rinv: int64 [E, 1] over the extended limbs.  -> [R, 2, E, N]."""
    rows = torch.cat([ksk[..., :l, :], ksk[..., Lq:, :]], dim=-2)
    if digs.dim() == 3:
        digs = digs[None]
    if rows.dim() == 4:
        rows = rows[None]
    if perms is not None:
        Rn = perms.shape[0]
        digs = digs.expand(Rn, *digs.shape[1:])
        idx = perms.long()[:, None, None, :].expand(Rn, *digs.shape[1:])
        digs = torch.gather(digs, -1, idx)
    acc0 = acc1 = None
    for j in range(digs.shape[1]):
        t0 = mm.mont_mul(digs[:, j], rows[:, j, 0], q, rinv)
        t1 = mm.mont_mul(digs[:, j], rows[:, j, 1], q, rinv)
        acc0 = t0 if acc0 is None else mm.mod_add(acc0, t0, q)
        acc1 = t1 if acc1 is None else mm.mod_add(acc1, t1, q)
    return torch.stack([acc0, acc1], dim=1)


# ---------------------------------------------------------------------------
# K6: seeded encryption passes — plain versions
# ---------------------------------------------------------------------------


def seeded_pre_plain(ctx: "CkksContext", hi: torch.Tensor, lo: torch.Tensor,
                     e: torch.Tensor, l: int) -> torch.Tensor:
    """Plain version of K6's pre pass: (hi, lo) split coefficients and the
    small signed noise e, each [B, N] -> Montgomery standard residues of
    m + e, int32 [B, l, N]."""
    lim = ctx.q_limbs(l)
    q, rinv = ctx._qrow(lim)
    m = ctx._coeffs_from_split(hi, lo, l)
    ev = e.long()[..., None, :]
    es = torch.where(ev < 0, q + ev, ev)
    return mm.mont_mul(mm.mod_add(m, es, q), ctx.r2_64[:l, None], q, rinv)


def seeded_c0_plain(ctx: "CkksContext", x: torch.Tensor, seed: int,
                    group: int) -> torch.Tensor:
    """Plain version of K6's c0 pass: x [B, l, N] (NTT of the pre pass) ->
    c0 = x - c1 * s with c1 = expand_c1(seed, group, B, l)."""
    B, l, n = x.shape
    q, rinv = ctx._qrow(ctx.q_limbs(l))
    c1 = prng.uniform_residues_plain(seed, group, (B, l, n), ctx.q32, ctx.r1_32)
    return mm.mod_sub(x, mm.mont_mul(c1, ctx.s_eval[:l], q, rinv), q)


# ---------------------------------------------------------------------------
# K7-K10: plain versions of the fused passes.  Each takes what its kernel
# chain takes and runs the JAX package's arithmetic in plain torch (plain
# NTTs included), on any device: the context uses them for CPU tensors,
# and chip_smoke.py holds the kernels against them on the card.
# ---------------------------------------------------------------------------


def rescale_plain(ctx: "CkksContext", data: torch.Tensor) -> torch.Tensor:
    """Divide [..., k, l, N] by the top prime q_{l-1} -> [..., k, l-1, N]
    (K7 with K1 around its lift pass)."""
    l = data.shape[-2]
    top_c = ctx.plan.inv_plain(data[..., l - 1 : l, :], (l - 1,))
    t_eval = ctx.plan.fwd_plain(rescale_lift_plain(ctx, top_c, l), ctx.q_limbs(l - 1))
    return sub_scale_plain(ctx, data, t_eval, ctx._qtinv(l)[0])


def rescale_lift_plain(ctx: "CkksContext", top_c: torch.Tensor, l: int) -> torch.Tensor:
    """K7's lift pass alone: the top limb q_{l-1} of a rescale in the
    coefficient domain [..., 1, N] -> its centred remainder mod each other
    limb, [..., l-1, N] Montgomery."""
    qt = int(ctx.all_primes[l - 1])
    q, rinv = ctx._qrow(ctx.q_limbs(l - 1))
    r2 = ctx.r2_64[: l - 1, None]
    top_std = top_c.long() * mm.host_rinv(qt) % qt  # standard form, < qt
    pos = mm.reduce_small(top_std, q)
    negv = mm.mod_neg(mm.reduce_small(qt - top_std, q), q)
    t_std = torch.where(top_std <= qt // 2, pos, negv)
    return mm.mont_mul(t_std, r2, q, rinv)


def sub_scale_plain(ctx: "CkksContext", x: torch.Tensor, t: torch.Tensor,
                    cinv: torch.Tensor, add: Optional[torch.Tensor] = None,
                    perms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7's sub-scale pass alone: (x[..., :l, :] - t) * cinv per limb
    (cinv int64 [l, 1] Montgomery) over t's l limbs, with ``add`` (see
    ``add_rotated_plain``) added."""
    q, rinv = ctx._qrow(ctx.q_limbs(t.shape[-2]))
    out = mm.mont_mul(mm.mod_sub(x[..., : t.shape[-2], :], t, q), cinv, q, rinv)
    return out if add is None else add_rotated_plain(out, add, perms, q)


def add_rotated_plain(out: torch.Tensor, add: torch.Tensor,
                      perms: Optional[torch.Tensor], q: torch.Tensor) -> torch.Tensor:
    """out [R, 2, l, N] with add [Ra, k, l, N] (Ra in {1, R}, k in {1, 2})
    added to its first k components, add's coefficients gathered through
    perms [R, N] when given: c0 o sigma + d0 of a rotation (k = 1), c + d
    of a relinearization (k = 2)."""
    R, k = out.shape[0], add.shape[1]
    a = add.expand(R, *add.shape[1:])
    if perms is not None:
        idx = perms.long()[:, None, None, :].expand(R, k, *add.shape[2:])
        a = torch.gather(a, -1, idx)
    head = mm.mod_add(a, out[:, :k], q)
    return head if k == out.shape[1] else torch.cat([head, out[:, k:]], dim=1)


def moddown_plain(ctx: "CkksContext", comp: torch.Tensor, l: int,
                  add: Optional[torch.Tensor] = None,
                  perms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[..., l + S, N] evaluation form over Q_l + P -> [..., l, N] over
    Q_l, dividing by P with the centred correction (K1, centred K3, K1,
    K7); with ``add`` (see ``add_rotated_plain``; comp then [R, 2, l + S,
    N]) the rotated c0 or the relinearized input is added."""
    sp = ctx.sp_limbs()
    lim = ctx.q_limbs(l)
    cp = ctx.plan.inv_plain(comp[..., l:, :], sp)
    pre, post = ctx._centre_shift(l)
    conv = fbc_plain(cp, ctx._fbc_consts(sp, lim), pre[0], post[0])
    return sub_scale_plain(ctx, comp, ctx.plan.fwd_plain(conv, lim), ctx._pinv(l)[0], add, perms)


def decompose_plain(ctx: "CkksContext", poly_eval: torch.Tensor, l: int,
                    perms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Digit-decompose evaluation-form polys [..., l, N] (gathered through
    the automorphism ``perms`` first, see ops.ntt.permute_rows) and extend
    every digit to Q_l + P -> [..., ndig, l + S, N] evaluation Montgomery
    (K1 with the gather, K8, K1)."""
    coeff = ctx.plan.inv_plain(permute_rows(poly_eval, perms), ctx.q_limbs(l))
    return ctx.plan.fwd_plain(decompose_coeff_plain(ctx, coeff, l), ctx.ext_limbs(l))


def decompose_coeff_plain(ctx: "CkksContext", coeff: torch.Tensor, l: int) -> torch.Tensor:
    """K8's pass alone: coefficient-domain rows [..., l, N] -> every live
    digit extended to Q_l + P, [..., ndig, l + S, N] in the coefficient
    domain."""
    digs = []
    for g, other in ctx._digits(l):
        a, b = g[0], g[-1] + 1
        x = coeff[..., a:b, :]
        conv = fbc_plain(x, ctx._fbc_consts(g, other))
        # ext order: conv rows below the digit, the digit's own rows
        # copied exactly, then the remaining conv rows
        digs.append(torch.cat([conv[..., :a, :], x, conv[..., a:, :]], dim=-2))
    return torch.stack(digs, dim=-3)


def tensor_plain(ctx: "CkksContext", x: torch.Tensor,
                 y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tensor product of ciphertext data [..., 2, lx, N] and [..., 2, ly, N]
    -> [..., 3, l, N], l = min(lx, ly) (K9); the square of x when y is
    None.  Each ciphertext of a batch is multiplied on its own."""
    l = x.shape[-2] if y is None else min(x.shape[-2], y.shape[-2])
    q, rinv = ctx._qrow(ctx.q_limbs(l))
    x0, x1 = x[..., 0, :l, :], x[..., 1, :l, :]
    if y is None:
        m = mm.mont_mul(x0, x1, q, rinv)
        return torch.stack([mm.mont_mul(x0, x0, q, rinv), mm.mod_add(m, m, q),
                            mm.mont_mul(x1, x1, q, rinv)], dim=-3)
    y0, y1 = y[..., 0, :l, :], y[..., 1, :l, :]
    c0 = mm.mont_mul(x0, y0, q, rinv)
    c1 = mm.mod_add(mm.mont_mul(x0, y1, q, rinv), mm.mont_mul(x1, y0, q, rinv), q)
    c2 = mm.mont_mul(x1, y1, q, rinv)
    return torch.stack([c0, c1, c2], dim=-3)


def decrypt_plain(ctx: "CkksContext", data: torch.Tensor) -> torch.Tensor:
    """[..., k, l, N] -> standard-form coefficient residues [..., l, N]
    (K9's MAC, then K1)."""
    k, l = data.shape[-3], data.shape[-2]
    lim = ctx.q_limbs(l)
    q, rinv = ctx._qrow(lim)
    s = ctx.s_eval[:l]
    m = data[..., 0, :, :]
    spow = s
    for i in range(1, k):
        m = mm.mod_add(m, mm.mont_mul(data[..., i, :, :], spow, q, rinv), q)
        if i + 1 < k:
            spow = mm.mont_mul(spow, s, q, rinv)
    coeff_mont = ctx.plan.inv_plain(m, lim)
    return mm.mont_mul(coeff_mont, torch.ones_like(q), q, rinv)  # REDC


def pk_encrypt_plain(ctx: "CkksContext", m_rns: torch.Tensor, v: torch.Tensor,
                     e0: torch.Tensor, e1: torch.Tensor, l: int) -> torch.Tensor:
    """Public-key encryption of standard-form message residues [B, l, N]
    with small signed noise v, e0, e1 [B, N] -> [B, 2, l, N] (K10 around
    K1): c0 = pk_b v + e0 + m, c1 = pk_a v + e1."""
    lim = ctx.q_limbs(l)
    q, rinv = ctx._qrow(lim)
    r2 = ctx.r2_64[:l, None]
    small = torch.stack([v, e0, e1]).long()[:, :, None, :]  # [3, B, 1, n]
    small = torch.where(small < 0, q + small, small)         # [3, B, l, n]
    std = torch.cat([m_rns[None].long(), small])              # [4, B, l, n]
    m, vv, ee0, ee1 = ctx.plan.fwd_plain(mm.mont_mul(std, r2, q, rinv), lim)
    c0 = mm.mod_add(mm.mod_add(mm.mont_mul(ctx.pk_b[:l], vv, q, rinv), ee0, q), m, q)
    c1 = mm.mod_add(mm.mont_mul(ctx.pk_a[:l], vv, q, rinv), ee1, q)
    return torch.stack([c0, c1], dim=-3)


class CkksContext:
    """Scheme context + evaluator.  One instance per parameter set, with
    its tables and keys on ``device``: the card (``"cuda"``) unless the
    caller asks for the CPU, where the plain versions run.  Without a GPU
    the default raises."""

    _SPLIT_BITS = 24            # coefficient split: c + OFFSET = hi*2^24 + lo
    _SPLIT_OFFSET = 1 << 47     # |coeff| must stay below this

    # rows per batched keyswitch of a stack rotated by one automorphism:
    # bounds the digit stack ([rows, dnum, l + S, N]) and the kernels' grids
    ROW_CHUNK = 128

    def __init__(self, params: SchemeParams, seed: int = 0, device="cuda",
                 noise: Optional[NoiseFn] = None,
                 seeded_noise: Optional[SeededNoiseFn] = None):
        self.params = params
        self.device = kernels.resolve_device(device)
        n = params.ring_dim
        self.n = n
        self.slots = params.slots
        self.Lq = params.num_limbs
        self.S = params.num_special
        self.all_primes: Tuple[int, ...] = params.q_primes + params.sp_primes
        self.Ltot = len(self.all_primes)
        roots = [root_of_unity(q, 2 * n) for q in self.all_primes]
        self.plan = NttPlan(n, self.all_primes, roots, device=self.device)

        consts = [mm.host_mont_constants(int(q)) for q in self.all_primes]
        self.q_np = np.array(self.all_primes, dtype=np.uint32)
        self.qneg_np = np.array([c[0] for c in consts], dtype=np.uint32)
        self.r2_np = np.array([c[2] for c in consts], dtype=np.uint32)
        dev = self.device
        self.q32 = mm.to_tensor(self.q_np, dev)       # kernels
        self.qneg32 = mm.to_tensor(self.qneg_np, dev)
        self.q64 = torch.tensor(self.all_primes, dtype=torch.int64, device=dev)
        self.rinv64 = torch.tensor([mm.host_rinv(q) for q in self.all_primes],
                                   dtype=torch.int64, device=dev)
        self.r2_64 = torch.tensor(self.r2_np.astype(np.int64), device=dev)
        # seeded encryption (K5, K6): R and R^2 mod q, 2^56 mod q (the hi
        # half's weight times R) and the split offset mod q
        self.r1_32 = mm.to_tensor(np.array([c[1] for c in consts], dtype=np.uint32), dev)
        self.r2_32 = mm.to_tensor(self.r2_np, dev)
        self.c24_32 = mm.to_tensor(np.array(
            [(1 << (self._SPLIT_BITS + 32)) % q for q in self.all_primes], dtype=np.uint32), dev)
        self.offm_32 = mm.to_tensor(np.array(
            [self._SPLIT_OFFSET % q for q in self.all_primes], dtype=np.uint32), dev)

        # digit partition over full Q basis
        g0 = math.ceil(self.Lq / params.dnum)
        self.groups: List[List[int]] = [
            list(range(j * g0, min((j + 1) * g0, self.Lq)))
            for j in range(params.dnum)
            if j * g0 < self.Lq
        ]
        self.dnum = len(self.groups)

        self.seed = seed
        self.noise = noise
        self.seeded_noise = seeded_noise
        self._rng = np.random.default_rng(seed)
        self._qrow_cache: Dict = {}
        self._const_cache: Dict = {}
        self._fbc_cache: Dict = {}
        # device index tensors by row tuple, and (set, rows) -> (index,
        # gathered perms) of rotation rows that no slice of their set
        # holds: built once, so no pageable host-to-device copy (which
        # blocks the host until the stream drains) runs per call
        self._idx_cache: Dict = {}
        self._rot_cache: Dict = {}
        self._keygen()
        # rotation keys live in stacked sets (perms [R, N], keys
        # [R, dnum, 2, Ltot, N]) so groups of rotations run as one batched
        # keyswitch
        self._rot_sets: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self.rot_keys: Dict[int, Dict[int, int]] = {}  # galois -> {set: row}
        self._pow2_rots: List[int] = []
        self._pt_cache: Dict = {}

    def replica(self, device) -> "CkksContext":
        """This context on another device: the same parameters, keys,
        rotation-key sets and NTT tables, copied (not regenerated), with
        empty caches; ``self`` when ``device`` is this context's own.  The
        replica draws from a copy of the generator, so nothing it does moves
        this context's later draws."""
        dev = kernels.canonical_device(device)
        if dev == kernels.canonical_device(self.device):
            return self
        return self._copied_to(dev)

    def _copied_to(self, dev: torch.device) -> "CkksContext":
        """``replica``'s copy, made even onto this context's own device."""
        r = copy.copy(self)
        for k, v in vars(self).items():
            if isinstance(v, torch.Tensor):
                setattr(r, k, v.to(dev, copy=True))
        r.device = dev
        r.plan = self.plan.replica(dev)
        r._rot_sets = [(p.to(dev, copy=True), k.to(dev, copy=True))
                      for p, k in self._rot_sets]
        r.rot_keys = {g: dict(sets) for g, sets in self.rot_keys.items()}
        r._pow2_rots = list(self._pow2_rots)
        r._rng = copy.deepcopy(self._rng)
        r._qrow_cache, r._const_cache, r._fbc_cache, r._pt_cache = {}, {}, {}, {}
        r._idx_cache, r._rot_cache = {}, {}
        return r

    # ------------------------------------------------------------------
    # constant helpers
    # ------------------------------------------------------------------

    def _index(self, rows: Sequence[int]) -> torch.Tensor:
        """int64 tensor of ``rows`` on this context's device, built on
        first use and kept."""
        key = tuple(rows)
        if key not in self._idx_cache:
            self._idx_cache[key] = torch.tensor(key, dtype=torch.int64, device=self.device)
        return self._idx_cache[key]

    def _qrow(self, limbs: Sequence[int]):
        """Per-limb (q, R^{-1} mod q) int64 views [l, 1]."""
        key = tuple(limbs)
        if key not in self._qrow_cache:
            idx = self._index(key)
            self._qrow_cache[key] = (self.q64[idx][:, None], self.rinv64[idx][:, None])
        return self._qrow_cache[key]

    def _mod(self, l: int) -> mm.Moduli:
        """The moduli of limbs 0..l-1 for ``mm.residue_op`` / ``mm.row_sum``."""
        key = ("moduli", l)
        if key not in self._const_cache:
            q, rinv = self._qrow(self.q_limbs(l))
            self._const_cache[key] = mm.Moduli(q, rinv, self.q32, self.qneg32, self.r1_32,
                                               self.r2_32)
        return self._const_cache[key]

    def _mont_const(self, value: int, limbs: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Montgomery form of an integer constant per limb, as the pair
        (int64 [l, 1], int32 [l]) of ``_limb_pair``."""
        v = int(value)
        return self._limb_pair(("mont", v), limbs, lambda q: v % q * (R % q) % q)

    def _limb_pair(self, name, limbs: Sequence[int], fn) -> Tuple[torch.Tensor, torch.Tensor]:
        """fn(q_i) over the given limbs as (int64 [l, 1] for the plain
        versions, int32 [l] for the kernels)."""
        key = ("pair", name, tuple(limbs))
        if key not in self._const_cache:
            vals = np.array([fn(self.all_primes[i]) for i in limbs], dtype=np.uint32)
            self._const_cache[key] = (
                torch.tensor(vals.astype(np.int64), device=self.device)[:, None],
                mm.to_tensor(vals, self.device))
        return self._const_cache[key]

    def _qtinv(self, l: int):
        """q_{l-1}^{-1} in Montgomery form over limbs 0..l-2 (rescale)."""
        qt = int(self.all_primes[l - 1])
        return self._limb_pair(("qtinv", qt), self.q_limbs(l - 1),
                               lambda p: pow(qt, -1, p) * (R % p) % p)

    def _pinv(self, l: int):
        """P^{-1} in Montgomery form over limbs 0..l-1 (mod-down)."""
        P = math.prod(self.params.sp_primes)
        return self._limb_pair("pinv", self.q_limbs(l), lambda p: pow(P % p, -1, p) * (R % p) % p)

    def _centre_shift(self, l: int):
        """(pre, post) of the centred mod-down conversion: P/2 in
        Montgomery form over the special limbs and over limbs 0..l-1."""
        half = math.prod(self.params.sp_primes) // 2
        fn = lambda q: half % q * (R % q) % q  # noqa: E731
        return (self._limb_pair("half_p", self.sp_limbs(), fn),
                self._limb_pair("half_p", self.q_limbs(l), fn))

    def _digits(self, l: int) -> List[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
        """(digit limbs, other extended limbs) of every digit live at l:
        digits whose limbs all lie at or above l are dropped."""
        ext = self.ext_limbs(l)
        out = []
        for grp in self.groups:
            g = tuple(i for i in grp if i < l)
            if g:
                out.append((g, tuple(i for i in ext if i not in g)))
        return out

    @property
    def fresh_scale(self) -> float:
        """Scale for fresh encryptions: sqrt(Delta * q_top * q_top2) when
        fresh_levels == 1 (so two rescales after the first ct*ct product
        land exactly on Delta), else Delta."""
        p = self.params
        if p.fresh_levels == 1:
            return math.sqrt(
                p.scale * self.all_primes[self.Lq - 1] * self.all_primes[self.Lq - 2]
            )
        return p.scale

    def rescale_score(self, ct: Ciphertext) -> Ciphertext:
        """Rescale after a product of two fresh ciphertexts: 1+fresh_levels
        rescales, landing the scale back on ~Delta."""
        for _ in range(1 + self.params.fresh_levels):
            ct = self.rescale(ct)
        return ct

    def q_limbs(self, l: int) -> Tuple[int, ...]:
        return tuple(range(l))

    def sp_limbs(self) -> Tuple[int, ...]:
        return tuple(range(self.Lq, self.Ltot))

    def ext_limbs(self, l: int) -> Tuple[int, ...]:
        return tuple(range(l)) + self.sp_limbs()

    # ------------------------------------------------------------------
    # key generation (host side, numpy/python ints; same draw order as
    # the JAX package)
    # ------------------------------------------------------------------

    def _host_rns_eval(self, coeffs: np.ndarray, limb_ids: Sequence[int]) -> np.ndarray:
        """signed coeffs [n] -> eval-domain standard residues uint64 [L, n]."""
        out = np.empty((len(limb_ids), self.n), dtype=np.uint64)
        for row, i in enumerate(limb_ids):
            q = self.all_primes[i]
            out[row] = host_ntt_fwd(np.mod(coeffs, q).astype(np.uint64), q,
                                    self.plan.psis_np[i])
        return out

    def _to_mont(self, std: np.ndarray, limb_ids: Sequence[int]) -> np.ndarray:
        """standard residues [..., L, n] -> Montgomery uint32 (host)."""
        out = np.empty(std.shape, dtype=np.uint32)
        for row, i in enumerate(limb_ids):
            out[..., row, :] = mm.host_to_mont(std[..., row, :].astype(np.uint32),
                                               self.all_primes[i])
        return out

    def _keygen(self):
        n, rng = self.n, self._rng
        p = self.params
        self._s_coeffs = _sample_ternary(rng, n)
        s_eval = self._host_rns_eval(self._s_coeffs, range(self.Ltot))
        self._s_eval_std = s_eval  # standard form, host, for key gen
        self.s_eval = mm.to_tensor(self._to_mont(s_eval, range(self.Ltot)), self.device)

        # public key over Q basis
        a = np.stack([rng.integers(0, q, size=n, dtype=np.uint64)
                      for q in self.all_primes[: self.Lq]])
        e = self._host_rns_eval(_sample_gauss(rng, n, p.sigma), range(self.Lq))
        b = np.empty_like(a)
        for i, q in enumerate(self.all_primes[: self.Lq]):
            b[i] = (q - a[i] * s_eval[i] % q + e[i]) % q
        self.pk_b = mm.to_tensor(self._to_mont(b, range(self.Lq)), self.device)
        self.pk_a = mm.to_tensor(self._to_mont(a, range(self.Lq)), self.device)

        # relinearization key: KSK for s^2
        s2_eval = np.empty_like(s_eval)
        for i, q in enumerate(self.all_primes):
            s2_eval[i] = s_eval[i] * s_eval[i] % q
        self.relin_key = mm.to_tensor(self._gen_ksk(s2_eval), self.device)

    def _gen_ksk(self, sp_eval_std: np.ndarray) -> np.ndarray:
        """Key-switching key for target secret s' (eval std [Ltot, n]):
        ksk[j] = (b_j, a_j) with b_j = -a_j s + e_j + P*g_j*s' (mod QP).
        Returns Montgomery uint32 [dnum, 2, Ltot, N] (host)."""
        n, rng = self.n, self._rng
        P = math.prod(self.params.sp_primes)
        Qfull = math.prod(self.params.q_primes)
        ksk = np.empty((self.dnum, 2, self.Ltot, n), dtype=np.uint64)
        for j, grp in enumerate(self.groups):
            Qj = math.prod(self.all_primes[i] for i in grp)
            Qhat = Qfull // Qj
            t = pow(Qhat % Qj, -1, Qj)
            a = np.stack([rng.integers(0, q, size=n, dtype=np.uint64)
                          for q in self.all_primes])
            e = self._host_rns_eval(_sample_gauss(rng, n, self.params.sigma),
                                    range(self.Ltot))
            for i, q in enumerate(self.all_primes):
                fac = (P * Qhat * t) % q  # == P mod q for i in grp; 0 for specials
                b = (q - a[i] * self._s_eval_std[i] % q + e[i]) % q
                ksk[j, 0, i] = (b + fac * sp_eval_std[i]) % q
                ksk[j, 1, i] = a[i]
        return self._to_mont(ksk, range(self.Ltot))

    def rotation_galois(self, r: int) -> int:
        """Galois element for EvalRotate(ct, r): left-rotate slots by r."""
        return pow(5, r % self.slots, 2 * self.n)

    def gen_rotation_keys(self, rotations: Sequence[int], force: bool = False):
        """Generate keys for the given slot rotations as one stacked set.
        With force=True, rotations already covered by other sets are
        regenerated here so the whole list lives in a single set."""
        new = []
        for r in rotations:
            g = self.rotation_galois(r)
            if g == 1 or g in [x[0] for x in new]:
                continue
            if g in self.rot_keys and not force:
                continue
            new.append((g, r))
        if not new:
            return
        self._rot_cache.clear()  # no gathered rows outlive a change of the sets
        set_idx = len(self._rot_sets)
        perms = np.stack([self.plan.auto_perm(g) for g, _ in new])
        keys = torch.empty((len(new), self.dnum, 2, self.Ltot, self.n),
                           dtype=torch.int32, device=self.device)
        for row, (g, _r) in enumerate(new):
            s_rot = self._s_eval_std[:, perms[row]]
            keys[row] = mm.to_tensor(self._gen_ksk(s_rot), self.device)
            self.rot_keys.setdefault(g, {})[set_idx] = row
        self._rot_sets.append((torch.from_numpy(perms).to(self.device), keys))

    def gen_power_of_two_rotation_keys(self):
        """Keys for +-2^k, ordered [1, 2, 4, ...] first so eval_sum can use
        a prefix of the stacked set."""
        rots = []
        i = 1
        while i < self.slots:
            rots.append(i)
            i *= 2
        i = 1
        while i < self.slots:
            rots.append(-i)
            i *= 2
        self._pow2_set_idx = len(self._rot_sets)
        self._pow2_rots = rots
        self.gen_rotation_keys(rots)

    def _rot_entry(self, g: int):
        """(perm, key) of the FIRST set holding galois element g."""
        set_idx, row = next(iter(self.rot_keys[g].items()))
        perms, keys = self._rot_sets[set_idx]
        return perms[row], keys[row]

    # ------------------------------------------------------------------
    # encoding / encryption (host <-> device boundary)
    # ------------------------------------------------------------------

    def encode(self, values: np.ndarray, limbs: int, scale: float) -> Plaintext:
        """Encode slot values into an eval-domain Montgomery plaintext at
        the given limb count and exact scale (host numpy NTT)."""
        coeffs = encoding.encode(np.asarray(values), self.n, scale)[0]
        rows = []
        for i in range(limbs):
            q = self.all_primes[i]
            ev = host_ntt_fwd(np.mod(coeffs, q).astype(np.uint64), q, self.plan.psis_np[i])
            rows.append(mm.host_to_mont(ev.astype(np.uint32), q))
        return Plaintext(mm.to_tensor(np.stack(rows), self.device), scale)

    def encode_cached(self, key, values, limbs: int, scale: float) -> Plaintext:
        ck = (key, limbs, round(math.log2(scale) * 1e6))
        if ck not in self._pt_cache:
            self._pt_cache[ck] = self.encode(values, limbs, scale)
        return self._pt_cache[ck]

    def _fresh_noise(self, seed: int, batch: int):
        """(v, e0, e1) int64 [batch, n] on the device: ternary v and rounded
        gaussians, from ``self.noise`` or a torch.Generator seeded by seed."""
        if self.noise is not None:
            return tuple(torch.as_tensor(np.array(x), dtype=torch.int64).to(self.device)
                         for x in self.noise(seed, batch, self.n))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        shape = (batch, self.n)
        v = torch.randint(-1, 2, shape, generator=gen, device=self.device)
        e = [torch.round(torch.randn(shape, generator=gen, device=self.device,
                                     dtype=torch.float32) * self.params.sigma).long()
             for _ in range(2)]
        return v, e[0], e[1]

    def encrypt_batch(self, values: np.ndarray, limbs: Optional[int] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
        """Encrypt a batch of slot-value vectors [B, slots] -> ciphertext
        data [B, 2, l, N].  Only the encoded message crosses from the
        host; the noise is drawn on the device and all NTTs and public-key
        products run there."""
        values = np.atleast_2d(np.asarray(values, dtype=np.float64))
        B = values.shape[0]
        l = limbs if limbs is not None else self.Lq
        sc = scale if scale is not None else self.fresh_scale
        primes = [self.all_primes[i] for i in range(l)]
        coeffs = encoding.encode(values, self.n, sc)  # [B, n]
        m_rns = mm.to_tensor(encoding.to_rns(coeffs, primes), self.device)  # [B, l, n] std
        seed = int(self._rng.integers(0, 2 ** 63))
        v, e0, e1 = self._fresh_noise(seed, B)
        return self._encrypt_impl(m_rns, v, e0, e1, l)

    _PK_CHUNK = 128  # ciphertexts per K10 pass: bounds the [3, B, l, N] transient

    def _encrypt_impl(self, m_rns: torch.Tensor, v: torch.Tensor, e0: torch.Tensor,
                      e1: torch.Tensor, l: int) -> torch.Tensor:
        """Public-key encryption, [B, l, N] standard residues and [B, N]
        int64 noise -> [B, 2, l, N]: K10's pre pass, K1, K10's MAC pass on
        CUDA (in chunks of ``_PK_CHUNK`` ciphertexts, one noise draw for the
        whole batch), ``pk_encrypt_plain`` on the CPU."""
        if not m_rns.is_cuda:
            return pk_encrypt_plain(self, m_rns, v, e0, e1, l)
        B, n = m_rns.shape[0], self.n
        if m_rns.shape != (B, l, n) or any(t.shape != (B, n) for t in (v, e0, e1)):
            raise ValueError(f"encrypt: message {tuple(m_rns.shape)} and noise "
                             f"{tuple(v.shape)} for l={l}, N={n}")
        m_rns, v, e0, e1 = (t.contiguous() for t in (m_rns, v, e0, e1))
        kernels.check_cuda("pk_encrypt", m_rns, self.pk_b, self.pk_a, self.q32, self.qneg32,
                           self.r2_32)
        kernels.check_cuda("pk_encrypt", v, e0, e1, dtype=torch.int64)
        if v.device != m_rns.device:
            raise ValueError("pk_encrypt: message and noise on different devices")
        lim = self.q_limbs(l)
        out = torch.empty((B, 2, l, n), dtype=torch.int32, device=m_rns.device)
        for i in range(0, B, self._PK_CHUNK):
            b = min(self._PK_CHUNK, B - i)
            x = torch.empty((3, b, l, n), dtype=torch.int32, device=m_rns.device)
            kernels.launch("imtpu_pk_pre", "pk_pre", x, kernels.ptr(m_rns[i]),
                           kernels.ptr(v[i]), kernels.ptr(e0[i]), kernels.ptr(e1[i]),
                           kernels.ptr(self.q32), kernels.ptr(self.qneg32),
                           kernels.ptr(self.r2_32), b, l, n)
            x = self.plan.fwd(x, lim)
            kernels.launch("imtpu_pk_mac", "pk_mac", out[i], kernels.ptr(x),
                           kernels.ptr(self.pk_b), kernels.ptr(self.pk_a),
                           kernels.ptr(self.q32), kernels.ptr(self.qneg32), b, l, n)
        return out

    def encrypt(self, values: np.ndarray, limbs: Optional[int] = None,
                scale: Optional[float] = None) -> Ciphertext:
        data = self.encrypt_batch(values, limbs, scale)[0]
        return Ciphertext(data, scale if scale is not None else self.fresh_scale)

    # ------------------------------------------------------------------
    # seed-compressed (symmetric) encryption for streamed databases: only
    # c0 is stored and streamed; c1 is expanded from (seed, group) on the
    # device when the group is used
    # ------------------------------------------------------------------

    def uniform_mont(self, seed: int, group: int, shape_prefix, l: int,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Uniform residues in [0, q_i) per limb, int32 [*shape_prefix, l,
        N] (one leading axis): the Threefry stream of ``ops/prng.py``.
        Uniform residues are uniform in Montgomery/eval form too, so the
        output is directly the seed-expanded c1 of an RLWE ciphertext."""
        (B,) = tuple(shape_prefix)
        return prng.uniform_residues(seed, group, (B, l, self.n), self.q32, self.qneg32,
                                     self.r1_32, self.r2_32, out=out)

    def expand_c1(self, seed: int, group: int, B: int, l: int,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Regenerate the c1 of a batch encrypted with
        ``encrypt_seeded_batch(seed, group)``: int32 [B, l, N] (written into
        ``out`` when given).  Kernel K5 on CUDA."""
        return self.uniform_mont(seed, group, (B,), l, out=out)

    def split_coeffs(self, coeffs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Signed int64 coefficients [..., N] -> (hi, lo) uint32 halves of
        coeff + OFFSET, the compact host->device transfer form (8 bytes per
        coefficient instead of 4 per limb)."""
        off = np.uint64(self._SPLIT_OFFSET)
        if np.abs(coeffs).max(initial=0) >= self._SPLIT_OFFSET:
            raise ValueError("coefficient overflows the 48-bit split")
        u = (coeffs.astype(np.int64) + np.int64(off)).astype(np.uint64)
        hi = (u >> np.uint64(self._SPLIT_BITS)).astype(np.uint32)
        lo = (u & np.uint64((1 << self._SPLIT_BITS) - 1)).astype(np.uint32)
        return hi, lo

    def _coeffs_from_split(self, hi: torch.Tensor, lo: torch.Tensor, l: int) -> torch.Tensor:
        """(hi, lo) [..., N] -> standard residues int32 [..., l, N] (plain)."""
        q, rinv = self._qrow(self.q_limbs(l))
        # mont_mul(hi, 2^24 * R) = hi * 2^24 mod q; lo < 2^24 < q already
        t = mm.mod_add(mm.mont_mul(hi.long()[..., None, :], self.c24_32[:l, None], q, rinv),
                       lo.long()[..., None, :], q)
        return mm.mod_sub(t, self.offm_32[:l, None], q)

    def encode_split(self, values: np.ndarray,
                     scale: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Host CKKS encode of [B, slots] values to the (hi, lo) uint32
        transfer form consumed by ``encrypt_seeded_from_split`` (a
        deterministic function of the plaintext, independent of keys and
        noise)."""
        values = np.atleast_2d(np.asarray(values, dtype=np.float64))
        sc = scale if scale is not None else self.fresh_scale
        return self.split_coeffs(encoding.encode(values, self.n, sc))

    def _seeded_noise(self, seed: int, batch: int) -> torch.Tensor:
        """Rounded gaussian e, int32 [batch, n] on the device, from
        ``self.seeded_noise`` or a torch.Generator seeded by seed."""
        if self.seeded_noise is not None:
            e = np.asarray(self.seeded_noise(seed, batch, self.n))
            return torch.as_tensor(e.astype(np.int32)).to(self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        e = torch.randn((batch, self.n), generator=gen, device=self.device,
                        dtype=torch.float32) * self.params.sigma
        return torch.round(e).int()

    def _seeded_pre(self, hi: torch.Tensor, lo: torch.Tensor, e: torch.Tensor,
                    l: int) -> torch.Tensor:
        """K6 pre pass on CUDA, ``seeded_pre_plain`` on the CPU."""
        if not hi.is_cuda:
            return seeded_pre_plain(self, hi, lo, e, l)
        hi, lo, e = hi.contiguous(), lo.contiguous(), e.contiguous()
        B, n = hi.shape
        if lo.shape != hi.shape or e.shape != hi.shape or n != self.n or B > 65535:
            raise ValueError(f"seeded_pre: shapes {tuple(hi.shape)}, {tuple(lo.shape)}, "
                             f"{tuple(e.shape)} for N={self.n}")
        kernels.check_cuda("seeded_pre", hi, lo, e, self.q32, self.qneg32, self.r2_32,
                           self.c24_32, self.offm_32)
        out = torch.empty((B, l, n), dtype=torch.int32, device=hi.device)
        kernels.launch("imtpu_seeded_pre", "seeded_pre", out, kernels.ptr(hi),
                       kernels.ptr(lo), kernels.ptr(e), kernels.ptr(self.q32),
                       kernels.ptr(self.qneg32), kernels.ptr(self.r2_32),
                       kernels.ptr(self.c24_32), kernels.ptr(self.offm_32), B, l, n)
        return out

    def _seeded_c0(self, x: torch.Tensor, seed: int, group: int) -> torch.Tensor:
        """K6 c0 pass on CUDA (in place: the result overwrites x),
        ``seeded_c0_plain`` on the CPU."""
        if not x.is_cuda:
            return seeded_c0_plain(self, x, seed, group)
        B, l, n = x.shape
        if n != self.n or B > 65535:
            raise ValueError(f"seeded_c0: data {tuple(x.shape)} for N={self.n}")
        kernels.check_cuda("seeded_c0", x, self.s_eval, self.q32, self.qneg32, self.r1_32,
                           self.r2_32)
        kernels.launch("imtpu_seeded_c0", "seeded_c0", x, kernels.ptr(x),
                       kernels.ptr(self.s_eval), kernels.ptr(self.q32),
                       kernels.ptr(self.qneg32), kernels.ptr(self.r1_32),
                       kernels.ptr(self.r2_32), seed & prng.M32, group & prng.M32, B, l, n)
        return x

    def encrypt_seeded(self, hi: torch.Tensor, lo: torch.Tensor, e: torch.Tensor,
                       seed: int, group: int, l: int) -> torch.Tensor:
        """c0 of the seeded encryption of split coefficients (hi, lo) with
        noise e (each [B, N] on the device): c0 = NTT(m + e) - c1 * s with
        c1 = expand_c1(seed, group, B, l) -> int32 [B, l, N].  m and e are
        added before one NTT (exact: the NTT is linear over Z_q), where the
        JAX package transforms each."""
        x = self.plan.fwd(self._seeded_pre(hi, lo, e, l), self.q_limbs(l))
        return self._seeded_c0(x, seed, group)

    def encrypt_seeded_from_split(self, hi: np.ndarray, lo: np.ndarray, seed: int,
                                  group: int, limbs: Optional[int] = None) -> torch.Tensor:
        """Seeded encryption from pre-encoded (hi, lo) coefficients: the 8
        bytes per coefficient are the only host->device traffic; the noise,
        NTT and seeded mask run on the device.  Draws one seed from the
        context's numpy generator, as the JAX package does."""
        l = limbs if limbs is not None else self.Lq
        e = self._seeded_noise(int(self._rng.integers(0, 2 ** 63)), hi.shape[0])
        return self.encrypt_seeded(mm.to_tensor(hi, self.device), mm.to_tensor(lo, self.device),
                                   e, seed, group, l)

    def encrypt_seeded_batch(self, values: np.ndarray, seed: int, group: int,
                             limbs: Optional[int] = None,
                             scale: Optional[float] = None) -> torch.Tensor:
        """Symmetric seeded encryption of [B, slots] values -> c0 only,
        int32 [B, l, N] on the device; the matching c1 is
        ``expand_c1(seed, group, B, l)``."""
        hi, lo = self.encode_split(values, scale)
        return self.encrypt_seeded_from_split(hi, lo, seed, group, limbs)

    def encrypt_seeded_batch_host(self, values: np.ndarray, seed: int, group: int,
                                  limbs: Optional[int] = None,
                                  scale: Optional[float] = None) -> torch.Tensor:
        """Host counterpart of ``encrypt_seeded_batch`` through the C++
        enroller (``utils.native.enroll_group``): c0 as a
        CPU int32 tensor [B, l, N], no device work.  Its noise is drawn
        from the context's numpy generator, as in the JAX package."""
        if not native.available():
            raise RuntimeError("the native host enroller could not be built "
                               "(native/imtpu_native.cpp needs a C++ compiler)")
        values = np.atleast_2d(np.asarray(values, dtype=np.float64))
        l = limbs if limbs is not None else self.Lq
        sc = scale if scale is not None else self.fresh_scale
        coeffs = encoding.encode(values, self.n, sc)
        e = np.rint(self._rng.normal(0.0, self.params.sigma, size=coeffs.shape)).astype(np.int64)
        s_std = np.ascontiguousarray(self._s_eval_std[:l].astype(np.uint32))
        c0 = native.enroll_group(coeffs + e, self.q_np[:l], self.plan.psis_np[:l], s_std,
                                 seed, group)
        return torch.from_numpy(c0.view(np.int32))

    def _decrypt_impl(self, data: torch.Tensor) -> torch.Tensor:
        """[..., k, l, N] -> standard-form coefficient residues [..., l, N]:
        K9's MAC (c0 + c1 s (+ c2 s^2), REDC) then K1 on CUDA,
        ``decrypt_plain`` on the CPU."""
        if not data.is_cuda:
            return decrypt_plain(self, data)
        k, l, n = data.shape[-3:]
        if n != self.n or not 1 <= k <= 3:
            raise ValueError(f"decrypt: data {tuple(data.shape)} for N={self.n}")
        d = data.reshape(-1, k, l, n)
        if d.stride(-1) != 1 or d.stride(-2) != n:
            d = d.contiguous()
        kernels.check_cuda("decrypt_mac", d, contiguous=False)
        kernels.check_cuda("decrypt_mac", self.s_eval, self.q32, self.qneg32)
        B = d.shape[0]
        out = torch.empty((B, l, n), dtype=torch.int32, device=data.device)
        kernels.launch("imtpu_decrypt_mac", "decrypt_mac", out, kernels.ptr(d),
                       d.stride(0), d.stride(1), k, kernels.ptr(self.s_eval),
                       kernels.ptr(self.q32), kernels.ptr(self.qneg32), B, l, n)
        return self.plan.inv(out, self.q_limbs(l)).reshape(*data.shape[:-3], l, n)

    def decrypt_coeffs(self, ct: Ciphertext) -> np.ndarray:
        """-> centered float64 coefficient vector [n]."""
        std = mm.to_numpy(self._decrypt_impl(ct.data))
        primes = [self.all_primes[i] for i in range(ct.limbs)]
        return encoding.from_rns_centered(std[None, ...], primes)[0]

    def decrypt(self, ct: Ciphertext, num_slots: Optional[int] = None) -> np.ndarray:
        return encoding.decode(self.decrypt_coeffs(ct), self.n, ct.scale, num_slots)

    # ------------------------------------------------------------------
    # basic homomorphic ops
    # ------------------------------------------------------------------

    def _check_scales(self, a: float, b: float):
        if abs(math.log2(a) - math.log2(b)) > 1e-6:
            raise ValueError(f"scale mismatch: {a} vs {b}; use align_to")

    # The residue ops below launch K11 for CUDA tensors (``mm.residue_op``)
    # and run the plain versions for CPU tensors.  Ciphertext data may carry
    # leading batch axes ([..., k, l, N]), the same on both operands of a
    # binary op; no op reduces across them, so a batch gives each
    # ciphertext's own result (the compare circuit runs over stacks of
    # scores, ``Sender._compare_many_with``).

    def add(self, x: Ciphertext, y: Ciphertext) -> Ciphertext:
        l = min(x.limbs, y.limbs)
        x, y = self.drop_to(x, l), self.drop_to(y, l)
        self._check_scales(x.scale, y.scale)
        kx, ky = x.ncomp, y.ncomp
        if kx == ky:
            return Ciphertext(mm.residue_op("add", x.data, y.data, self._mod(l)), x.scale)
        big, small = (x, y) if kx > ky else (y, x)
        return Ciphertext(mm.residue_op("add", big.data, small.data, self._mod(l),
                                        head=small.ncomp), x.scale)

    def sub(self, x: Ciphertext, y: Ciphertext) -> Ciphertext:
        return self.add(x, self.neg(y))

    def neg(self, x: Ciphertext) -> Ciphertext:
        return Ciphertext(mm.residue_op("neg", x.data, None, self._mod(x.limbs)), x.scale)

    def add_scalar(self, x: Ciphertext, c: float) -> Ciphertext:
        """Add constant c to every slot: constant polynomial, exact at the
        ciphertext's scale, added to component 0 only."""
        consts = self._mont_const(int(round(c * x.scale)), self.q_limbs(x.limbs))
        return Ciphertext(mm.residue_op("add", x.data, consts, self._mod(x.limbs), head=1),
                          x.scale)

    def mul_scalar_int(self, x: Ciphertext, k: int) -> Ciphertext:
        """Exact multiply by a (small) integer; no level, no scale change."""
        consts = self._mont_const(k, self.q_limbs(x.limbs))
        return Ciphertext(mm.residue_op("mul", x.data, consts, self._mod(x.limbs)), x.scale)

    def mul_plain(self, x: Ciphertext, pt: Plaintext) -> Ciphertext:
        if pt.data.shape[-2] < x.limbs:
            x = self.drop_to(x, pt.data.shape[-2])
        l = x.limbs
        return Ciphertext(mm.residue_op("mul", x.data, pt.data[:l], self._mod(l)),
                          x.scale * pt.scale)

    def mul_scalar(self, x: Ciphertext, c: float, pt_scale: float) -> Ciphertext:
        """Multiply every slot by real constant c encoded at pt_scale (a
        constant polynomial — no encoding FFT needed)."""
        consts = self._mont_const(int(round(c * pt_scale)), self.q_limbs(x.limbs))
        return Ciphertext(mm.residue_op("mul", x.data, consts, self._mod(x.limbs)),
                          x.scale * pt_scale)

    def _tensor(self, x: torch.Tensor, y: Optional[torch.Tensor]) -> torch.Tensor:
        """Tensor product of data [..., 2, lx, N] and [..., 2, ly, N] (the
        square of x when y is None; the same leading batch axes) -> [..., 3,
        min(lx, ly), N]: one K9 launch on CUDA, reading dropped limbs in
        place; ``tensor_plain`` on the CPU."""
        if not x.is_cuda:
            return tensor_plain(self, x, y)
        lead = tuple(x.shape[:-3])
        ops = [x] if y is None else [x, y]
        l, n = min(t.shape[-2] for t in ops), self.n
        if any(t.dim() < 3 or t.shape[-3] != 2 or t.shape[-1] != n
               or tuple(t.shape[:-3]) != lead for t in ops):
            raise ValueError(f"tensor: operands {[tuple(t.shape) for t in ops]}")
        ops = [t.reshape(-1, *t.shape[-3:]) for t in ops]  # [B, 2, L, N]
        ops = [t if t.stride(-1) == 1 and t.stride(-2) == n else t.contiguous() for t in ops]
        kernels.check_cuda("tensor", *ops, contiguous=False)
        kernels.check_cuda("tensor", self.q32, self.qneg32)
        xs, ys = ops[0], ops[-1]
        B = xs.shape[0]
        out = torch.empty((B, 3, l, n), dtype=torch.int32, device=x.device)
        kernels.launch("imtpu_tensor", "tensor", out, kernels.ptr(xs), xs.stride(0),
                       xs.stride(1), 0 if y is None else kernels.ptr(ys), ys.stride(0),
                       ys.stride(1), int(y is None), kernels.ptr(self.q32),
                       kernels.ptr(self.qneg32), B, l, n)
        return out.reshape(*lead, 3, l, n)

    def mul(self, x: Ciphertext, y: Ciphertext) -> Ciphertext:
        """Tensor product without relinearization (EvalMultNoRelin); the
        higher operand's top limbs drop (free modulus reduction)."""
        assert x.ncomp == 2 and y.ncomp == 2, "relinearize first"
        return Ciphertext(self._tensor(x.data, y.data), x.scale * y.scale)

    def square(self, x: Ciphertext) -> Ciphertext:
        assert x.ncomp == 2
        return Ciphertext(self._tensor(x.data, None), x.scale * x.scale)

    def drop_to(self, x: Ciphertext, l: int) -> Ciphertext:
        """Free modulus reduction: drop top limbs (scale unchanged)."""
        if x.limbs == l:
            return x
        assert x.limbs > l
        return Ciphertext(x.data[..., :l, :], x.scale)

    def rescale(self, x: Ciphertext) -> Ciphertext:
        """Divide by the top prime (FIXEDMANUAL RescaleInPlace): on CUDA K1
        inverse of the top limb (read in place), K7's lift pass, K1
        forward, K7's sub-scale pass; ``rescale_plain`` on the CPU.  Each
        polynomial of data [..., l, N] is divided on its own, so any leading
        axes (components, a batch of ciphertexts) go in one pass."""
        l = x.limbs
        assert l >= 2, "cannot rescale below guard level"
        qt = int(self.all_primes[l - 1])
        if not x.data.is_cuda:
            return Ciphertext(rescale_plain(self, x.data), x.scale / qt)
        top = self.plan.inv(x.data[..., l - 1 : l, :], (l - 1,))  # [..., 1, N]
        t = self.plan.fwd(self._rescale_lift(top, l), self.q_limbs(l - 1))
        return Ciphertext(self._sub_scale(x.data, t, self._qtinv(l)[1]), x.scale / qt)

    def _rescale_lift(self, top: torch.Tensor, l: int) -> torch.Tensor:
        """K7's lift pass alone: the top limb's coefficient-domain CUDA
        rows [..., 1, N] -> [..., l-1, N] (``rescale_lift_plain``)."""
        lead, n = top.shape[:-2], self.n
        kernels.check_cuda("rescale_lift", top, self.q32, self.qneg32, self.r2_32)
        t = torch.empty((*lead, l - 1, n), dtype=torch.int32, device=top.device)
        kernels.check_aligned("rescale_lift", t)
        kernels.launch("imtpu_rescale_lift", "rescale_lift", t, kernels.ptr(top),
                       int(self.all_primes[l - 1]), int(self.qneg_np[l - 1]),
                       kernels.ptr(self.q32), kernels.ptr(self.qneg32), kernels.ptr(self.r2_32),
                       math.prod(lead), l - 1, n)
        kernels.note_shape("lift", math.prod(lead), l - 1, 0, "")
        return t

    def _sub_scale(self, x: torch.Tensor, t: torch.Tensor, cinv: torch.Tensor,
                   add: Optional[torch.Tensor] = None,
                   perms: Optional[torch.Tensor] = None) -> torch.Tensor:
        """K7's sub-scale pass: (x - t) * cinv per limb -> t's shape
        [..., l, N], x's first l limbs read in place.  With ``add`` (see
        ``add_rotated_plain``; t then [R, 2, l, N]) the addend, gathered
        through ``perms``, is added in the same pass."""
        n = self.n
        l = t.shape[-2]
        t = t.contiguous()
        xs, B, x_bstride = kernels.row_blocks(x)
        if t.numel() != B * l * n or x.shape[-2] < l:
            raise ValueError(f"sub_scale: x {tuple(x.shape)} against t {tuple(t.shape)}")
        kernels.check_cuda("sub_scale", xs, contiguous=False)
        kernels.check_cuda("sub_scale", t, cinv, self.q32, self.qneg32)
        add_k = add_r = add_c = perm_r = 0
        if add is not None:
            R = t.shape[0]
            if add.stride(-1) != 1 or add.stride(-2) != n:
                add = add.contiguous()
            if (t.dim() != 4 or t.shape[1] != 2 or add.dim() != 4 or add.shape[0] not in (1, R)
                    or add.shape[1] not in (1, 2) or add.shape[2] != l):
                raise ValueError(f"sub_scale: addend {tuple(add.shape)} for {tuple(t.shape)}")
            kernels.check_cuda("sub_scale", add, contiguous=False)
            add_k, add_c = add.shape[1], add.stride(1)
            add_r = add.stride(0) if add.shape[0] > 1 else 0
            if perms is not None:
                perms = perms.contiguous()
                if perms.dim() != 2 or perms.shape[0] not in (1, R) or perms.shape[1] != n:
                    raise ValueError(f"sub_scale: permutations {tuple(perms.shape)} for R={R}")
                kernels.check_cuda("sub_scale", perms)
                perm_r = n if perms.shape[0] > 1 else 0
        elif perms is not None:
            raise ValueError("sub_scale: a permutation needs an addend")
        out = torch.empty(t.shape, dtype=torch.int32, device=t.device)
        kernels.check_aligned("sub_scale", out)
        kernels.launch("imtpu_sub_scale", "sub_scale", out, kernels.ptr(xs),
                       x_bstride, kernels.ptr(t), kernels.ptr(cinv), kernels.ptr(self.q32),
                       kernels.ptr(self.qneg32), kernels.ptr(add), add_r, add_c, add_k,
                       kernels.ptr(perms), perm_r, B, l, n)
        kernels.note_shape("sub_scale", B, l, add_k, "gathered" if perms is not None else "")
        return out

    # ------------------------------------------------------------------
    # key switching
    # ------------------------------------------------------------------

    def _fbc_consts(self, src: Tuple[int, ...], dst: Tuple[int, ...]) -> FbcConsts:
        """Fast-base-conversion constants from source primes to target
        primes (limb indices into all_primes)."""
        key = (src, dst)
        if key in self._fbc_cache:
            return self._fbc_cache[key]
        src_p = [self.all_primes[i] for i in src]
        dst_p = [self.all_primes[i] for i in dst]
        QG = math.prod(src_p)
        t_std = np.array([pow((QG // q) % q, -1, q) for q in src_p], dtype=np.uint32)[:, None]
        qhat = np.array([[(QG // sq) * R * R % dq for dq in dst_p] for sq in src_p],
                        dtype=np.uint32)
        qg_r2 = np.array([QG * R * R % dq for dq in dst_p], dtype=np.uint32)[:, None]
        inv_q = np.array([1.0 / q for q in src_p], dtype=np.float32)[:, None]
        dev = self.device
        packed = np.concatenate([fbc_pack_targets(src_p, dst_p, self.qneg_np[list(dst)]),
                                 self.q_np[list(src)], self.qneg_np[list(src)], t_std[:, 0],
                                 inv_q[:, 0].view(np.uint32)])
        qs, rinv_s = self._qrow(src)
        qd, rinv_d = self._qrow(dst)
        c = FbcConsts(
            qs=qs, rinv_s=rinv_s, qd=qd, rinv_d=rinv_d,
            t_std=torch.tensor(t_std.astype(np.int64), device=dev),
            qhat=torch.tensor(qhat.astype(np.int64), device=dev),
            qg_r2=torch.tensor(qg_r2.astype(np.int64), device=dev),
            inv_q=torch.tensor(inv_q[:, 0], device=dev),
            packed=mm.to_tensor(packed, dev))
        self._fbc_cache[key] = c
        return c

    def _fbc(self, x: torch.Tensor, src: Tuple[int, ...], dst: Tuple[int, ...],
             shift: Optional[Tuple] = None) -> torch.Tensor:
        """Fast base conversion of coefficient-domain Montgomery residues
        [..., g, N] (basis src) -> [..., t, N] (basis dst), approximate
        (+-1 multiple of Q_src, standard for hybrid key switching); with
        ``shift`` = (pre, post) pairs of ``_limb_pair`` the centred form of
        the mod-down.  Kernel K3 for a CUDA tensor, ``fbc_plain`` for a CPU
        tensor."""
        c = self._fbc_consts(tuple(src), tuple(dst))
        pre, post = shift if shift is not None else ((None, None), (None, None))
        if not x.is_cuda:
            return fbc_plain(x, c, pre[0], post[0])
        x = x.contiguous()
        g, t, n = len(src), len(dst), self.n
        if x.shape[-2] != g or x.shape[-1] != n:
            raise ValueError(f"fbc: data {tuple(x.shape)} does not match {g} limbs")
        batch = x.numel() // (g * n)
        if batch > 65535:
            raise ValueError("fbc: batch exceeds the kernel's grid (65535)")
        out = torch.empty((*x.shape[:-2], t, n), dtype=torch.int32, device=x.device)
        kernels.check_cuda("fbc", x, c.packed, *(v for v in (pre[1], post[1]) if v is not None))
        kernels.check_aligned("fbc", x)
        kernels.launch("imtpu_fbc", "fbc", out, kernels.ptr(x),
                       kernels.ptr(c.packed), kernels.ptr(pre[1]), kernels.ptr(post[1]),
                       batch, g, t, n)
        return out

    def _decompose_consts(self, l: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """K8's constants at level l: the live digits' K3 constant blocks
        concatenated, and int32 [ndig, 3] (first limb, limb count, offset)."""
        key = ("decompose", l)
        if key not in self._const_cache:
            blocks, info, off = [], [], 0
            for g, other in self._digits(l):
                if len(g) > 8 or len(other) > 32:
                    raise ValueError(f"decompose: digit of {len(g)} limbs into {len(other)}")
                packed = self._fbc_consts(g, other).packed
                blocks.append(packed)
                info += [g[0], len(g), off]
                off += packed.numel()
            self._const_cache[key] = (torch.cat(blocks), torch.tensor(
                info, dtype=torch.int32, device=self.device))
        return self._const_cache[key]

    def _decompose_extended(self, poly_eval: torch.Tensor, l: int,
                            perms: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Hoisting precompute: digit-decompose eval-domain polys
        [..., l, N], gathered through the automorphism ``perms`` first
        (int32 [N], or [R, N] for [R, l, N]; see ops.ntt.permute_rows), and
        extend every digit to the full current basis Q_l + P.  Returns
        [..., ndig, l + S, N] eval Montgomery.  On CUDA: K1 inverse (with
        the gather in its loads), K8, one K1 forward over the digit stack;
        ``decompose_plain`` on the CPU."""
        if not poly_eval.is_cuda:
            return decompose_plain(self, poly_eval, l, perms)
        coeff = self.plan.inv(poly_eval, self.q_limbs(l), perms)
        return self.plan.fwd(self._decompose_coeff(coeff, l), self.ext_limbs(l))

    def _decompose_coeff(self, coeff: torch.Tensor, l: int) -> torch.Tensor:
        """K8 alone: coefficient-domain CUDA rows [..., l, N] -> the digit
        stack [..., ndig, l + S, N], still in the coefficient domain
        (``decompose_coeff_plain``)."""
        n = self.n
        consts, info = self._decompose_consts(l)
        ndig, E = info.numel() // 3, l + self.S
        B = coeff.numel() // (l * n)
        if B > 65535:
            raise ValueError("decompose: batch exceeds the kernel's grid (65535)")
        out = torch.empty((*coeff.shape[:-2], ndig, E, n), dtype=torch.int32,
                          device=coeff.device)
        kernels.check_cuda("decompose", coeff, consts, info)
        kernels.check_aligned("decompose", coeff)
        kernels.launch("imtpu_decompose", "decompose", out, kernels.ptr(coeff),
                       l * n, kernels.ptr(consts), kernels.ptr(info), B, ndig, E, n)
        return out

    def _moddown(self, comp: torch.Tensor, l: int, add: Optional[torch.Tensor] = None,
                 perms: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[..., l + S, N] eval over Q_l + P -> [..., l, N] eval over Q_l,
        dividing by P (with centered correction).  With ``add`` (see
        ``add_rotated_plain``; comp then [R, 2, l + S, N]) the rotated c0
        or the relinearized input is added.  On CUDA: K1 inverse of the
        special limbs (read in place), centred K3, K1 forward, K7's
        sub-scale pass; ``moddown_plain`` on the CPU."""
        if not comp.is_cuda:
            return moddown_plain(self, comp, l, add, perms)
        sp, lim = self.sp_limbs(), self.q_limbs(l)
        cp = self.plan.inv(comp[..., l:, :], sp)
        conv = self._fbc(cp, sp, lim, self._centre_shift(l))
        t = self.plan.fwd(conv, lim)
        return self._sub_scale(comp, t, self._pinv(l)[1], add, perms)

    def _ks_mac(self, digs: torch.Tensor, ksk: torch.Tensor, l: int,
                perms: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Key multiply-accumulate over the extended basis, for R
        rotations/relinearizations at once -> [R, 2, l + S, N].

        digs: [ndig, E, N] shared by all R, or [R, ndig, E, N];
        ksk: [dnum, 2, Ltot, N] shared, or [R, dnum, 2, Ltot, N];
        perms: int32 [R, N] automorphisms applied to the digits, or None.
        Kernel K4 for CUDA tensors, ``ks_mac_plain`` for CPU tensors."""
        E = l + self.S
        if not digs.is_cuda:
            q, rinv = self._qrow(self.ext_limbs(l))
            return ks_mac_plain(digs, ksk, l, self.Lq, q, rinv, perms)
        digs = digs.contiguous()
        ksk = ksk.contiguous()
        n = self.n
        ndig = digs.shape[-3]
        d_shared = digs.dim() == 3
        k_shared = ksk.dim() == 4
        sizes = {t.shape[0] for t, shared in ((digs, d_shared), (ksk, k_shared))
                 if not shared}
        if perms is not None:
            sizes.add(perms.shape[0])
        if len(sizes) > 1 or digs.shape[-2] != E or ksk.shape[-2] != self.Ltot:
            raise ValueError(f"ks_mac: inconsistent shapes {tuple(digs.shape)}, "
                             f"{tuple(ksk.shape)}")
        Rn = sizes.pop() if sizes else 1
        if ndig > ksk.shape[-4]:
            raise ValueError("ks_mac: more digits than key rows")
        out = torch.empty((Rn, 2, E, n), dtype=torch.int32, device=digs.device)
        tensors = [digs, ksk, self.q32, self.qneg32] + ([perms] if perms is not None else [])
        kernels.check_cuda("ks_mac", *tensors)
        kernels.launch(
            "imtpu_ks_mac", "ks_mac", out, kernels.ptr(digs),
            0 if d_shared else ndig * E * n, kernels.ptr(perms), kernels.ptr(ksk),
            0 if k_shared else ksk[0].numel(), Rn, ndig, E, l, self.Lq, self.Ltot, n,
            kernels.ptr(self.q32), kernels.ptr(self.qneg32))
        return out

    def _keyswitch_batch(self, digs, ksk, l: int, perms=None, add=None,
                         add_perms=None) -> torch.Tensor:
        """MAC (digits gathered through ``perms``) then mod-down of both
        components -> [R, 2, l, N], with ``add`` gathered through
        ``add_perms`` added (see ``add_rotated_plain``)."""
        return self._moddown(self._ks_mac(digs, ksk, l, perms), l, add, add_perms)

    def keyswitch(self, poly_eval: torch.Tensor, ksk: torch.Tensor) -> Tuple:
        """poly [l, N] x ksk -> (d0, d1) each [l, N] over Q_l."""
        l = poly_eval.shape[-2]
        d = self._keyswitch_batch(self._decompose_extended(poly_eval, l), ksk, l)[0]
        return d[0], d[1]

    def relinearize(self, x: Ciphertext) -> Ciphertext:
        """Relinearize [3, l, N], or a batch [B, 3, l, N] in chunks of
        ``ROW_CHUNK`` batched keyswitches."""
        if x.ncomp == 2:
            return x
        assert x.ncomp == 3
        if x.data.dim() == 3:
            return Ciphertext(self.relinearize_stack(x.data[None])[0], x.scale)
        return Ciphertext(self._by_chunks(x.data, 2, self.relinearize_stack), x.scale)

    def relinearize_stack(self, data: torch.Tensor) -> torch.Tensor:
        """Relinearize a stack of 3-component ciphertexts [R, 3, l, N] ->
        [R, 2, l, N] with one batched keyswitch; c0, c1 are added in the
        mod-down's last pass."""
        l = data.shape[-2]
        return self._keyswitch_batch(self._decompose_extended(data[:, 2], l),
                                     self.relin_key, l, add=data[:, :2])

    def mul_relin(self, x: Ciphertext, y: Ciphertext) -> Ciphertext:
        return self.relinearize(self.mul(x, y))

    # ------------------------------------------------------------------
    # rotations
    # ------------------------------------------------------------------

    def _by_chunks(self, data: torch.Tensor, ncomp: int, fn) -> torch.Tensor:
        """fn over data [R, ...] in chunks of ``ROW_CHUNK`` rows, each
        result [rows, ncomp, l, N] written into one output."""
        R = data.shape[0]
        if R <= self.ROW_CHUNK:
            return fn(data)
        out = None
        for i in range(0, R, self.ROW_CHUNK):
            o = fn(data[i : i + self.ROW_CHUNK])
            if out is None:
                out = torch.empty((R, ncomp, *o.shape[2:]), dtype=o.dtype, device=o.device)
            out[i : i + o.shape[0]] = o
        return out

    def _rotate_rows(self, data: torch.Tensor, perm: torch.Tensor,
                     key: torch.Tensor) -> torch.Tensor:
        """Rotate every row of a stack [R, 2, l, N] by ONE automorphism
        (perm [N], key [dnum, 2, Ltot, N] shared by all rows, never copied
        per row): batched keyswitches of ``ROW_CHUNK`` rows.  The
        automorphism is gathered inside the kernels: c1's in the
        decomposition's inverse NTT, c0's in the mod-down's last pass."""
        l, perm = data.shape[-2], perm[None]

        def one(d):
            digs = self._decompose_extended(d[:, 1], l, perm)
            return self._keyswitch_batch(digs, key, l, add=d[:, :1], add_perms=perm)

        return self._by_chunks(data, 2, one)

    def rotate(self, x: Ciphertext, r: int) -> Ciphertext:
        """EvalRotate: left-rotate slots by r (requires key for this r);
        data [2, l, N], or a batch [B, 2, l, N] with every ciphertext
        rotated by r."""
        if r % self.slots == 0:
            return x
        g = self.rotation_galois(r)
        if g not in self.rot_keys:
            raise KeyError(f"no rotation key for r={r} (g={g})")
        assert x.ncomp == 2
        perm, key = self._rot_entry(g)
        if x.data.dim() == 3:
            return Ciphertext(self._rotate_rows(x.data[None], perm, key)[0], x.scale)
        return Ciphertext(self._rotate_rows(x.data, perm, key), x.scale)

    def rotate_any(self, x: Ciphertext, r: int) -> Ciphertext:
        """One direct keyswitch when a key for exactly r exists (e.g. the
        merge-chain amounts requested via Sender.required_rotations), else
        the signed power-of-two decomposition."""
        if r % self.slots == 0:
            return x
        if self.rotation_galois(r) in self.rot_keys:
            return self.rotate(x, r)
        return self.binary_rotate(x, r)

    def binary_rotate(self, x: Ciphertext, r: int) -> Ciphertext:
        """Arbitrary rotation via signed nearest-power-of-two steps using
        only +-2^k keys (reference binaryRotate)."""
        factor = r
        while factor != 0:
            sign = 1 if factor > 0 else -1
            step = 2 ** int(round(math.log2(abs(factor))))
            if (step * sign) % self.slots != 0:
                x = self.rotate(x, step * sign)
            factor -= step * sign
        return x

    def hoisted_precompute(self, x: Ciphertext) -> torch.Tensor:
        """EvalFastRotationPrecompute: digit-decompose+extend c1 once."""
        return self._decompose_extended(x.data[1], x.limbs)

    def hoisted_rotate(self, x: Ciphertext, digs: torch.Tensor, r: int) -> Ciphertext:
        """EvalFastRotation using precomputed digits."""
        if r % self.slots == 0:
            return x
        g = self.rotation_galois(r)
        perm, key = self._rot_entry(g)
        return Ciphertext(self._hoisted(x, digs, perm[None], key[None])[0], x.scale)

    def _hoisted(self, x: Ciphertext, digs, perms, keys) -> torch.Tensor:
        """Hoisted rotations of x by R automorphisms -> [R, 2, l, N]; the
        digit permutation runs inside the MAC kernel, c0's inside the
        mod-down's last pass."""
        return self._keyswitch_batch(digs, keys, x.limbs, perms, add=x.data[None, :1],
                                     add_perms=perms)

    def _rot_locate(self, rots: Sequence[int]) -> Tuple[int, List[int]]:
        """(set, rows) of the given rotations in the LOWEST key set holding
        all of them."""
        locs = [self.rot_keys[self.rotation_galois(r)] for r in rots]
        common = set(locs[0])
        for d in locs[1:]:
            common &= set(d)
        assert common, "rotations must share one key set"
        sid = min(common)
        return sid, [d[sid] for d in locs]

    def _rot_rows(self, rots: Sequence[int]):
        """Stacked (perms [R, N], keys [R, ...]) for the given rotations,
        from the LOWEST set holding all of them: a zero-copy view when their
        rows are consecutive in that set (a HyDia sender's giant steps
        follow its baby steps), else the rows gathered through a cached
        device index (the perms gathered once, the keys per call)."""
        sid, rows = self._rot_locate(rots)
        perms, keys = self._rot_sets[sid]
        a = rows[0]
        if rows == list(range(a, a + len(rows))):
            return perms[a : a + len(rows)], keys[a : a + len(rows)]
        key = (sid, tuple(rows))
        if key not in self._rot_cache:
            idx = self._index(rows)
            self._rot_cache[key] = (idx, perms[idx])
        idx, p = self._rot_cache[key]
        return p, keys[idx]

    def hoisted_rotate_stack(self, x: Ciphertext, digs: torch.Tensor,
                             rots: Sequence[int]) -> torch.Tensor:
        """Batch of hoisted rotations as one batched keyswitch:
        -> data [len(rots), 2, l, N]."""
        perms, keys = self._rot_rows(rots)
        return self._hoisted(x, digs, perms, keys)

    def rotate_stack(self, data: torch.Tensor, rots: Sequence[int],
                     scale: float) -> torch.Tensor:
        """Rotate a stack of ciphertexts [R, 2, l, N] by per-row rotation
        amounts, as one batched keyswitch."""
        l = data.shape[-2]
        perms, keys = self._rot_rows(rots)
        digs = self._decompose_extended(data[:, 1], l, perms)
        return self._keyswitch_batch(digs, keys, l, add=data[:, :1], add_perms=perms)

    def rotate_rows_binary(self, data: torch.Tensor, rots: Sequence[int]) -> torch.Tensor:
        """Rotate every row of a [R, 2, l, N] stack by its OWN amount using
        only the +2^k keys: one bit stage per bit set in some amount, in
        ascending k.  A stage rotates the rows whose bit is set (one shared
        key, batched keyswitches) and passes the others through; rotating
        only the selected rows gives the JAX package's select of a full
        rotated stack, residue for residue."""
        amounts = [r % self.slots for r in rots]
        assert len(amounts) == data.shape[0]
        nbits = int(math.log2(self.slots))
        used = [k for k in range(nbits) if any((a >> k) & 1 for a in amounts)]
        if not used:
            return data
        sid, rows = self._rot_locate([1 << k for k in used])
        perms, keys = self._rot_sets[sid]
        out = data
        for k, row in zip(used, rows):
            sel = self._index([i for i, a in enumerate(amounts) if (a >> k) & 1])
            rot = self._rotate_rows(out.index_select(0, sel), perms[row], keys[row])
            out = out.index_copy(0, sel, rot)
        return out

    def eval_sum(self, x: Ciphertext, m: int) -> Ciphertext:
        """Every slot j becomes sum of slots j..j+m-1 (cyclic): log2(m)
        rotate-and-add steps over the power-of-two key-set prefix; data
        [2, l, N] or a batch [B, 2, l, N] (every ciphertext summed)."""
        if m <= 1:
            return x
        steps = int(math.log2(m))
        perms, keys = self._rot_rows([1 << k for k in range(steps)])
        mod = self._mod(x.limbs)
        carry = x.data if x.data.dim() == 4 else x.data[None]
        for k in range(steps):
            carry = mm.residue_op("add", carry, self._rotate_rows(carry, perms[k], keys[k]), mod)
        return Ciphertext(carry if x.data.dim() == 4 else carry[0], x.scale)

    # ------------------------------------------------------------------
    # scale alignment
    # ------------------------------------------------------------------

    def align_to(self, x: Ciphertext, limbs: int, scale: float) -> Ciphertext:
        """Bring x to exactly (limbs, scale) using free limb drops and, if
        the scale differs, one spare level (multiply by 1.0 at the
        correcting scale, then rescale)."""
        if x.limbs == limbs and abs(math.log2(x.scale / scale)) < 1e-9:
            return x
        if abs(math.log2(x.scale / scale)) < 1e-9:
            return self.drop_to(x, limbs)
        assert x.limbs > limbs, "no spare level for scale alignment"
        x = self.drop_to(x, limbs + 1)
        qt = int(self.all_primes[limbs])
        y = self.rescale(self.mul_scalar(x, 1.0, scale * qt / x.scale))
        # exact by construction up to float rounding of sigma
        return Ciphertext(y.data, scale)

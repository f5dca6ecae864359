"""Negacyclic number-theoretic transform over RNS limbs (port of
image_matching_tpu/ops/ntt.py).

Same tables and the same output order as the JAX plan: the 2N-th root psi
is merged into the twiddles (psi^brv(i) tables), forward maps
natural-order coefficients to the bit-reversed evaluation order, inverse
undoes it including the 1/N factor.  Data is int32 ``[..., L, N]`` in
Montgomery form, one limb per row; ``limbs`` names the table row of each
of the L rows.  Because every output is a canonical residue, any correct
wiring over these tables is bit-identical to the JAX plan, and
``auto_perm`` (derived from the transform itself) matches too.

``NttPlan.fwd`` / ``inv`` launch the CUDA kernel K1 (``csrc/ntt.cu``) for a
CUDA tensor and run the plain torch version (``ntt_fwd_plain`` /
``ntt_inv_plain``) for a CPU tensor.  K1 reads a strided batch of limb
blocks in place and can gather the input through an automorphism
permutation on its way in; it runs as two passes (strided columns, then
contiguous sub-blocks; mirrored for the inverse), so many blocks share a
row and few-row launches still fill the card.  Where a launch holds each
limb in several batch rows, a row-pass block walks R' of them
(``rows_per_block``), staging its twiddles once.  The JAX plan's
uniform-stage loop tables exist only to keep XLA graphs small and are not
ported.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import kernels
from . import modmath as mm

MIN_KERNEL_N = 1 << 8   # K1's row pass: a warp holds a sub-block of 256
MAX_KERNEL_N = 1 << 16  # K1's two passes: 2^8 x 2^8
MAX_MODULUS = 1 << 31   # K1 keeps residues below 2q between its stages, in 32 bits
# the batched row pass's choices of R', largest first, each with the least
# grid it takes: below those, fewer rows a block ran faster (ntt_bench
# --sweep on the H100: R' 8 won from 640 blocks, 4 from 512)
ROWS_PER_BLOCK = ((8, 640), (4, 512))


def rows_per_block(batch: int, L: int, logn: int) -> int:
    """R': the batch rows of one limb that a block of K1's batched row pass
    walks (``csrc/ntt.cu`` ``ntt_rows_batch_kernel``), for a launch of
    ``batch`` x ``L`` rows of N = 2^logn: the first of ROWS_PER_BLOCK whose
    grid, L x ceil(batch / R') row groups times the row's tiles of four
    sub-blocks, holds its least number of blocks; 1 (``ntt_rows_kernel``,
    a block a row) where none does."""
    sub = logn - 8
    tiles = 1 << (sub - min(sub, 2))
    for rb, least in ROWS_PER_BLOCK:
        if batch >= rb and L * -(-batch // rb) * tiles >= least:
            return rb
    return 1


def _bit_reverse_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _pow_table(base: int, n: int, q: int) -> np.ndarray:
    """[base^0, ..., base^{n-1}] mod q, vectorized square-and-multiply."""
    exps = np.arange(n, dtype=np.uint64)
    result = np.ones(n, dtype=np.uint64)
    b = np.uint64(base % q)
    qq = np.uint64(q)
    k = 0
    while (1 << k) < n:
        mask = (exps >> np.uint64(k)) & np.uint64(1)
        result = np.where(mask == 1, result * b % qq, result)
        b = b * b % qq
        k += 1
    return result


def _psi_tables(n: int, q: int, psi: int):
    """(psis, ipsis, ninv): psi^brv(i) and psi^-brv(i) tables plus n^{-1},
    standard form, uint32 numpy."""
    brv = _bit_reverse_perm(n)
    psis = _pow_table(psi, n, q)[brv].astype(np.uint32)
    ipsis = _pow_table(pow(psi, -1, q), n, q)[brv].astype(np.uint32)
    return psis, ipsis, pow(n, -1, q)


def ntt_fwd_stages(x: torch.Tensor, psis: torch.Tensor, q: torch.Tensor, lo: int, hi: int,
                   nblk: int = 1, blk: int = 0, inner: int = 1) -> torch.Tensor:
    """Forward (Cooley-Tukey) stages with group counts m = lo, 2 lo, ..., <
    hi of a virtual row of V elements, on int64 x [..., L, n].  x's last
    axis holds block ``blk`` of ``nblk`` equal contiguous blocks of that
    row, each element ``inner`` residues wide (a column of ``inner``
    transforms side by side), so V = nblk * n / inner; stage m pairs
    elements V / (2m) apart and needs m >= nblk (no pair crosses a block).
    Its twiddles are rows psis[m + g] of the whole transform's table, g the
    global group.  The whole transform is lo = 1, hi = n; a slot shard's
    transform splits it (parallel/tensor.py)."""
    lead = x.shape[:-1]
    L, n = x.shape[-2], x.shape[-1]
    V = nblk * (n // inner)
    qv = q.long().view(L, 1, 1)
    m = lo
    while m < hi:
        ml = m // nblk
        x = x.reshape(*lead, ml, 2, V // (2 * m) * inner)
        w = psis[:, m + blk * ml:m + (blk + 1) * ml].long().reshape(L, ml, 1)
        u = x[..., 0, :]
        v = x[..., 1, :] * w % qv
        s = u + v
        d = u - v
        x = torch.stack([torch.where(s >= qv, s - qv, s),
                         torch.where(d < 0, d + qv, d)], dim=-2)
        m *= 2
    return x.reshape(*lead, n)


def ntt_inv_stages(x: torch.Tensor, ipsis: torch.Tensor, q: torch.Tensor, lo: int, hi: int,
                   nblk: int = 1, blk: int = 0, inner: int = 1) -> torch.Tensor:
    """Inverse (Gentleman-Sande) stages with group counts h = hi / 2, ...,
    lo (descending) of a virtual row, on int64 x [..., L, n], laid out as
    in ``ntt_fwd_stages``; twiddles ipsis[h + g].  No 1/N factor."""
    lead = x.shape[:-1]
    L, n = x.shape[-2], x.shape[-1]
    V = nblk * (n // inner)
    qv = q.long().view(L, 1, 1)
    h = hi // 2
    while h >= lo:
        hl = h // nblk
        x = x.reshape(*lead, hl, 2, V // (2 * h) * inner)
        w = ipsis[:, h + blk * hl:h + (blk + 1) * hl].long().reshape(L, hl, 1)
        u = x[..., 0, :]
        v = x[..., 1, :]
        s = u + v
        d = u - v
        x = torch.stack([torch.where(s >= qv, s - qv, s),
                         torch.where(d < 0, d + qv, d) * w % qv], dim=-2)
        h //= 2
    return x.reshape(*lead, n)


def ntt_fwd_plain(a: torch.Tensor, psis: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain forward NTT.  a: int [..., L, N]; psis: [L, N] twiddle rows of
    those limbs; q: int64 [L].  Cooley-Tukey stages, as host_ntt_fwd."""
    return ntt_fwd_stages(a.long(), psis, q, 1, a.shape[-1]).int()


def ntt_inv_plain(a: torch.Tensor, ipsis: torch.Tensor, q: torch.Tensor,
                  ninv: torch.Tensor) -> torch.Tensor:
    """Plain inverse NTT (Gentleman-Sande, then 1/N), as host_ntt_inv.
    ninv: int64 [L]."""
    L = a.shape[-2]
    x = ntt_inv_stages(a.long(), ipsis, q, 1, a.shape[-1])
    return (x * ninv.long().view(L, 1) % q.long().view(L, 1)).int()


class NttPlan:
    """NTT tables for a fixed prime chain (Q limbs + specials), each below
    2^31, on one device: the card unless the caller asks for the CPU
    (without a GPU the default raises).  Device tables are int32
    ``[L_total, N]``; each transform takes a tuple of limb indices naming
    the rows that take part."""

    def __init__(self, n: int, primes: Sequence[int], roots: Sequence[int],
                 device="cuda"):
        if any(not 1 < q < MAX_MODULUS for q in primes):
            raise ValueError(f"ntt: every modulus must lie in (1, 2^31), not {list(primes)}")
        self.n = n
        self.logn = n.bit_length() - 1
        self.primes = tuple(primes)
        self.device = kernels.resolve_device(device)
        L = len(primes)
        psis = np.empty((L, n), dtype=np.uint32)
        ipsis = np.empty((L, n), dtype=np.uint32)
        ninv = np.empty((L,), dtype=np.uint32)
        for i, (q, psi) in enumerate(zip(primes, roots)):
            psis[i], ipsis[i], ninv[i] = _psi_tables(n, q, psi)
        self.psis_np = psis  # host copies (encoding, keygen)
        self.ipsis_np = ipsis
        dev = self.device
        self.psis = mm.to_tensor(psis, dev)
        self.ipsis = mm.to_tensor(ipsis, dev)
        self.psis_sh = mm.to_tensor(
            np.stack([mm.host_shoup(psis[i], q) for i, q in enumerate(primes)]), dev)
        self.ipsis_sh = mm.to_tensor(
            np.stack([mm.host_shoup(ipsis[i], q) for i, q in enumerate(primes)]), dev)
        self.ninv = mm.to_tensor(ninv, dev)
        self.ninv_sh = mm.to_tensor(
            np.array([mm.host_shoup(np.array(ninv[i]), q) for i, q in enumerate(primes)],
                     dtype=np.uint32), dev)
        self.q = mm.to_tensor(np.array(primes, dtype=np.uint32), dev)
        self._idx_cache = {}
        self._rows_per_block: Dict[Tuple[int, int], int] = {}  # (batch, L) -> R'
        # K1 launches by their row count (batch x limbs), filled only where
        # K1 launches: which row counts the kernel has to serve
        self.rows_hist: Dict[int, int] = {}
        # exponent map: eval position j holds m(psi^{exp[j]})
        self._exp = self._derive_exponents()
        pos = np.full(2 * n, -1, dtype=np.int64)
        pos[self._exp] = np.arange(n)
        self._pos_of_exp = pos
        self._auto_cache = {}

    def replica(self, device) -> "NttPlan":
        """The same plan with its tables copied to ``device`` (host tables
        shared; the limb-index cache starts empty)."""
        dev = kernels.canonical_device(device)
        r = copy.copy(self)
        for k, v in vars(self).items():
            if isinstance(v, torch.Tensor):
                setattr(r, k, v.to(dev, copy=True))
        r.device = dev
        r._idx_cache = {}
        r.rows_hist = {}
        return r

    def _derive_exponents(self) -> np.ndarray:
        """eval position -> exponent of psi (relative to NTT(X)[0]), via
        NTT(X) and a discrete log; see the JAX plan for why relative
        exponents give the same permutations."""
        n = self.n
        q = self.primes[0]
        a = np.zeros(n, dtype=np.uint64)
        a[1] = 1
        vals = host_ntt_fwd(a, q, self.psis_np[0].astype(np.uint64))
        table = {}
        g = int(vals[0])
        x = 1
        for e in range(2 * n):
            table[x] = e
            x = x * g % q
        exps = np.array([table[int(v)] for v in vals], dtype=np.int64)
        assert np.all(exps % 2 == 1), "exponent table not odd — NTT wiring bug"
        return exps

    def auto_perm(self, g: int) -> np.ndarray:
        """Index permutation P with out_eval[j] = in_eval[P[j]] implementing
        m(X) -> m(X^g) in the evaluation domain (g odd, mod 2N); int32."""
        g = g % (2 * self.n)
        if g not in self._auto_cache:
            perm = self._pos_of_exp[(g * self._exp) % (2 * self.n)]
            assert np.all(perm >= 0)
            self._auto_cache[g] = perm.astype(np.int32)
        return self._auto_cache[g]

    def limb_index(self, limbs: Tuple[int, ...]) -> torch.Tensor:
        key = tuple(limbs)
        if key not in self._idx_cache:
            self._idx_cache[key] = torch.tensor(key, dtype=torch.int32,
                                                device=self.device)
        return self._idx_cache[key]

    def fwd(self, a: torch.Tensor, limbs: Tuple[int, ...],
            perm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Forward NTT of [..., L, N] Montgomery coefficients (natural order)
        -> evaluation form (bit-reversed order).  ``perm`` (see
        ``permute_rows``) gathers the input coefficients first."""
        if a.is_cuda:
            return self._launch(a, limbs, False, perm)
        return self.fwd_plain(permute_rows(a, perm), limbs)

    def inv(self, a: torch.Tensor, limbs: Tuple[int, ...],
            perm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Inverse NTT: evaluation form -> natural-order coefficients,
        including the 1/N scaling.  ``perm`` (see ``permute_rows``)
        gathers the input's evaluation slots first: a Galois automorphism
        applied on the way in."""
        if a.is_cuda:
            return self._launch(a, limbs, True, perm)
        return self.inv_plain(permute_rows(a, perm), limbs)

    def fwd_plain(self, a: torch.Tensor, limbs: Tuple[int, ...]) -> torch.Tensor:
        """The plain forward transform on any device."""
        idx = self.limb_index(limbs).long()
        return ntt_fwd_plain(a, self.psis[idx], self.q[idx])

    def inv_plain(self, a: torch.Tensor, limbs: Tuple[int, ...]) -> torch.Tensor:
        """The plain inverse transform on any device."""
        idx = self.limb_index(limbs).long()
        return ntt_inv_plain(a, self.ipsis[idx], self.q[idx], self.ninv[idx])

    def _launch(self, a: torch.Tensor, limbs, inverse: bool,
                perm: Optional[torch.Tensor]) -> torch.Tensor:
        L, n = a.shape[-2], a.shape[-1]
        if L != len(limbs) or n != self.n:
            raise ValueError(f"ntt: data {tuple(a.shape)} does not match "
                             f"{len(limbs)} limbs of N={self.n}")
        if not MIN_KERNEL_N <= n <= MAX_KERNEL_N:
            raise ValueError(f"ntt kernel: N must lie in [{MIN_KERNEL_N}, {MAX_KERNEL_N}]")
        src, batch, bstride = kernels.row_blocks(a)
        perm_bstride = 0
        if perm is not None:
            perm = perm.contiguous()
            if perm.shape[-1] != n or perm.dim() > 2 or (
                    perm.dim() == 2 and perm.shape[0] not in (1, batch)):
                raise ValueError(f"ntt: permutation {tuple(perm.shape)} for {batch} rows")
            perm_bstride = n if perm.dim() == 2 and perm.shape[0] > 1 else 0
            kernels.check_cuda("ntt", perm)
        idx = self.limb_index(limbs)
        tw, tw_sh = (self.ipsis, self.ipsis_sh) if inverse else (self.psis, self.psis_sh)
        kernels.check_cuda("ntt", idx, tw, tw_sh, self.q, self.ninv, self.ninv_sh)
        kernels.check_cuda("ntt", src, contiguous=False)
        out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
        rb = self._rows_per_block.get((batch, L))
        if rb is None:
            rb = self._rows_per_block[batch, L] = rows_per_block(batch, L, self.logn)
        direction = "inv" if inverse else "fwd"
        kernels.launch(
            "imtpu_ntt", "ntt_" + direction,
            out, kernels.ptr(src), bstride, kernels.ptr(perm), perm_bstride,
            kernels.ptr(idx), batch * L, L, self.logn, kernels.ptr(tw), kernels.ptr(tw_sh),
            kernels.ptr(self.q), kernels.ptr(self.ninv), kernels.ptr(self.ninv_sh),
            int(inverse), rb)
        kernels.note_shape("ntt_rows", batch, L, rb, direction)
        rows = batch * L
        self.rows_hist[rows] = self.rows_hist.get(rows, 0) + 1
        return out

    def launch_pass(self, out: torch.Tensor, a: torch.Tensor, limbs: Tuple[int, ...],
                    inverse: bool, cols: bool, blk_off: int = 0,
                    perm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One pass of K1 alone (``imtpu_ntt_pass``) for a slot shard
        (parallel/tensor.py), into ``out`` [..., L, w], w = N / D, which it
        returns.  ``cols``: the column pass over the shard's [2^a, w / 2^a]
        column block of each row (forward: reads ``a``, which may be
        ``out``; inverse: in place in ``out``, with 1/N); else the row pass
        over the row's w / 256 sub-blocks, the first at global sub-block
        ``blk_off``, reading ``a`` [..., L, w] or, gathered through ``perm``
        ([w] or [B, w] of global indices), a full-width source [..., L, N].
        CUDA only: the plain versions are ``ntt_fwd_stages`` /
        ``ntt_inv_stages``."""
        L, w = out.shape[-2], out.shape[-1]
        logw = w.bit_length() - 1
        src, batch, bstride = kernels.row_blocks(a)
        if (L != len(limbs) or a.shape[-2] != L or w != 1 << logw or not out.is_contiguous()
                or src.numel() // (L * src.shape[-1]) != out.numel() // (L * w)
                or src.shape[-1] != (self.n if perm is not None else w)):
            raise ValueError(f"ntt pass: data {tuple(a.shape)} into {tuple(out.shape)} for "
                             f"{len(limbs)} limbs of N={self.n}")
        perm_bstride = 0
        if perm is not None:
            perm = perm.contiguous()
            if perm.shape[-1] != w or perm.dim() > 2 or (
                    perm.dim() == 2 and perm.shape[0] not in (1, batch)):
                raise ValueError(f"ntt pass: permutation {tuple(perm.shape)} for {batch} rows")
            perm_bstride = w if perm.dim() == 2 and perm.shape[0] > 1 else 0
            kernels.check_cuda("ntt", perm)
        idx = self.limb_index(limbs)
        tw, tw_sh = (self.ipsis, self.ipsis_sh) if inverse else (self.psis, self.psis_sh)
        kernels.check_cuda("ntt", out, idx, tw, tw_sh, self.q, self.ninv, self.ninv_sh)
        kernels.check_cuda("ntt", src, contiguous=False)
        name = ("ntt_inv" if inverse else "ntt_fwd") + ("_cols" if cols else "_rows")
        kernels.launch(
            "imtpu_ntt_pass", name, out, kernels.ptr(src), bstride, src.shape[-1],
            kernels.ptr(perm), perm_bstride, kernels.ptr(idx), batch * L, L, self.logn, logw,
            int(cols), blk_off, kernels.ptr(tw), kernels.ptr(tw_sh), kernels.ptr(self.q),
            kernels.ptr(self.ninv), kernels.ptr(self.ninv_sh), int(inverse))
        return out


def permute_rows(a: torch.Tensor, perm: Optional[torch.Tensor]) -> torch.Tensor:
    """a [..., L, N] with its last axis gathered through perm: int [N]
    (every row), or [B, N] with one permutation per [L, N] block of a
    [B, L, N] (plain torch; the kernels gather inside their loads).  perm
    may be narrower than a's rows (a slot shard's own slots of a full-width
    source)."""
    if perm is None:
        return a
    if perm.dim() == 1 or perm.shape[0] == 1:
        return a.index_select(-1, perm.reshape(-1).long())
    idx = perm.long()[:, None, :].expand(a.shape[0], a.shape[-2], perm.shape[-1])
    return torch.gather(a, -1, idx)


# ---------------------------------------------------------------------------
# Host-side transforms (numpy uint64, standard form) — key generation and
# encoding; identical wiring to the device transforms.
# ---------------------------------------------------------------------------


def host_ntt_fwd(a: np.ndarray, q: int, psis: np.ndarray) -> np.ndarray:
    """Forward negacyclic NTT on host.  a: uint64[..., n] standard form,
    natural order -> bit-reversed eval order.  psis: table from _psi_tables."""
    n = a.shape[-1]
    lead = a.shape[:-1]
    a = a.astype(np.uint64) % np.uint64(q)
    psis = psis.astype(np.uint64)
    m = 1
    while m < n:
        t = n // (2 * m)
        a = a.reshape(*lead, m, 2, t)
        s = psis[m : 2 * m].reshape(m, 1)
        u = a[..., 0, :]
        v = a[..., 1, :] * s % np.uint64(q)
        a = np.stack([(u + v) % np.uint64(q), (u - v + np.uint64(q)) % np.uint64(q)], axis=-2)
        m *= 2
    return a.reshape(*lead, n)


def host_ntt_inv(a: np.ndarray, q: int, ipsis: np.ndarray, ninv: int) -> np.ndarray:
    n = a.shape[-1]
    lead = a.shape[:-1]
    a = a.astype(np.uint64) % np.uint64(q)
    ipsis = ipsis.astype(np.uint64)
    m = n
    while m > 1:
        h = m // 2
        t = n // m
        a = a.reshape(*lead, h, 2, t)
        s = ipsis[h : 2 * h].reshape(h, 1)
        u = a[..., 0, :]
        v = a[..., 1, :]
        a = np.stack(
            [(u + v) % np.uint64(q), (u - v + np.uint64(q)) * s % np.uint64(q)],
            axis=-2,
        )
        m //= 2
    a = a.reshape(*lead, n)
    return a * np.uint64(ninv) % np.uint64(q)

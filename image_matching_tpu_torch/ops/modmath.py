"""RNS residue arithmetic on torch tensors (plain versions) plus the host
constant helpers.

Port of image_matching_tpu/ops/modmath.py.  Residues are stored as
``torch.int32``: every prime is below 2^31, so the bit pattern equals the
JAX package's uint32.  CPU torch cannot add, shift or compare uint32, so
these plain versions compute in int64 and return int32.  Each JAX result
is a fully reduced residue, so the exact identities

    mont_mul(a, b)  == a * b * R^{-1} mod q      (R = 2^32)
    shoup_mul(a, w) == a * w mod q

give bit-identical values without 16-bit half products (``mul32_wide``
exists only because the TPU has no 64-bit multiply).  Per-limb constants
are int64 tensors broadcastable against the data (``[l, 1]`` against
``[..., l, N]``): ``q`` and ``rinv`` = R^{-1} mod q.

The CUDA kernels use the device-function versions in ``csrc/modmath.cuh``;
the standalone residue ops between kernels (``residue_op``, ``row_sum``)
dispatch on the tensor's device: kernel K11 (``csrc/modarith.cu``) for a
CUDA tensor, the plain versions here for a CPU tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import kernels

R = 1 << 32


def mont_mul(a, b, q, rinv):
    """Montgomery product a * b * R^{-1} mod q (a * b < 2^63)."""
    return ((a.long() * b.long()) % q * rinv % q).int()


def shoup_mul(a, w, q):
    """a * w mod q for a standard-form constant w (the Shoup companion of
    the JAX version is an implementation detail of the same value)."""
    return (a.long() * w.long() % q).int()


def mod_add(a, b, q):
    s = a.long() + b.long()
    return torch.where(s >= q, s - q, s).int()


def mod_sub(a, b, q):
    d = a.long() - b.long()
    return torch.where(d < 0, d + q, d).int()


def mod_neg(a, q):
    a = a.long()
    return torch.where(a == 0, a, q - a).int()


def reduce_small(x, q):
    """x mod q (the JAX version assumes x < 16 q and subtracts)."""
    return (x.long() % q).int()


def mont_dot(a, b, dim, q, rinv, chunk: int = 64):
    """sum_k a_k * b_k * R^{-1} mod q over axis ``dim``: the Montgomery form
    of the dot product of Montgomery operands.  Each product is reduced
    before the sum (in chunks of ``chunk`` terms to bound the int64
    temporaries), so any contraction length is exact."""
    K = a.shape[dim]
    acc = None
    for k0 in range(0, K, chunk):
        ak = a.narrow(dim, k0, min(chunk, K - k0)).long()
        bk = b.narrow(dim, k0, min(chunk, K - k0)).long()
        part = (ak * bk % q).sum(dim)
        acc = part if acc is None else acc + part
    return (acc % q * rinv % q).int()


# ---------------------------------------------------------------------------
# K11: standalone residue arithmetic (csrc/modarith.cu) for CUDA tensors,
# the functions above for CPU tensors: the tensor's device decides.
# ---------------------------------------------------------------------------

OPS = {"add": 0, "sub": 1, "neg": 2, "mul": 3}


@dataclasses.dataclass(frozen=True)
class Moduli:
    """The moduli of limbs 0..l-1: int64 [l, 1] ``q`` and ``rinv`` for the
    plain versions, and the context's int32 tables of every prime
    (``q32``, ``qneg32`` = -q^-1 mod 2^32, ``r1_32`` = R mod q, ``r2_32`` =
    R^2 mod q, indexed by limb) for K11."""

    q: torch.Tensor
    rinv: torch.Tensor
    q32: torch.Tensor
    qneg32: torch.Tensor
    r1_32: torch.Tensor
    r2_32: torch.Tensor


def residue_op_plain(op: str, a, b, q, rinv, head: Optional[int] = None):
    """Plain version of ``residue_op``: the JAX package's mod_add, mod_sub,
    mod_neg or mont_mul (b a tensor broadcastable against a, or a per-limb
    constant pair whose int64 half is used)."""
    if isinstance(b, tuple):
        b = b[0]
    fn = {"add": lambda x: mod_add(x, b, q), "sub": lambda x: mod_sub(x, b, q),
          "neg": lambda x: mod_neg(x, q), "mul": lambda x: mont_mul(x, b, q, rinv)}[op]
    if head is None or head >= a.shape[-3]:
        return fn(a)
    return torch.cat([fn(a[..., :head, :, :]), a[..., head:, :, :].int()], dim=-3)


def modarith_args(op: str, a: torch.Tensor, b, head: Optional[int] = None):
    """What K11's elementwise pass is given for ``residue_op(op, a, b, m,
    head)``, on any device: (a's storage, its block stride, b's storage,
    its block stride, b's form 0 same shape / 1 plane / 2 per limb, the
    components per ciphertext, the head, the [l, N] blocks, l, N).  a and
    a same-shape b are read in place where one stride addresses them."""
    l, n = a.shape[-2], a.shape[-1]
    if head is not None and a.dim() < 3:
        raise ValueError(f"residue_op: {op} on {tuple(a.shape)} (head {head})")
    src, B, a_bstride = kernels.row_blocks(a)
    kcomp = 1 if head is None else a.shape[-3]
    headk = 1 if head is None else min(head, kcomp)
    bt, b_bstride, b_mode = None, 0, 0
    if op != "neg":
        if isinstance(b, tuple):
            bt, b_mode = b[1].contiguous(), 2
            if bt.numel() != l:
                raise ValueError(f"residue_op: per-limb constant of {bt.numel()} limbs, data {l}")
        elif b.dim() == 2 and a.dim() > 2:
            bt, b_mode = b.contiguous(), 1
            if tuple(bt.shape) != (l, n):
                raise ValueError(f"residue_op: plane {tuple(b.shape)} against {tuple(a.shape)}")
        else:
            want = a.shape if head is None else (*a.shape[:-3], headk, l, n)
            if tuple(b.shape) != tuple(want):
                raise ValueError(f"residue_op: operand {tuple(b.shape)} against {tuple(want)}")
            bt, _, b_bstride = kernels.row_blocks(b)
    return src, a_bstride, bt, b_bstride, b_mode, kcomp, headk, B, l, n


def residue_op(op: str, a: torch.Tensor, b, m: Moduli, head: Optional[int] = None):
    """out = a + b, a - b, -a (b None) or the Montgomery product a * b * R^-1
    mod q (op "add", "sub", "neg", "mul") over residues a [..., l, N] of
    limbs 0..l-1.  b is a tensor of a's shape, an [l, N] plane broadcast
    over a's leading axes (a plaintext), or a per-limb constant given as the
    pair (int64 [l, 1], int32 [l]).  With ``head`` (a [..., k, l, N], any
    leading batch axes), the op applies to the first ``head`` components
    of every ciphertext, a[..., :head, :, :] (b then has that shape or
    broadcasts), and the others pass through.  No element depends on
    another ciphertext of the batch.  Kernel K11 for CUDA tensors, the
    plain version for CPU tensors."""
    if not a.is_cuda:
        return residue_op_plain(op, a, b, m.q, m.rinv, head)
    if op not in OPS or a.shape[-2] > m.q32.numel():
        raise ValueError(f"residue_op: {op} on {tuple(a.shape)} (head {head})")
    src, a_bstride, bt, b_bstride, b_mode, kcomp, headk, B, l, n = modarith_args(op, a, b, head)
    if bt is not None:
        kernels.check_cuda("residue_op", bt, contiguous=b_mode != 0)
    kernels.check_cuda("residue_op", src, contiguous=False)
    kernels.check_cuda("residue_op", m.q32, m.qneg32)
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    kernels.check_aligned("residue_op", out)
    kernels.launch("imtpu_modarith", "modarith", out, kernels.ptr(src), a_bstride,
                   kernels.ptr(bt), b_bstride, b_mode, OPS[op], kcomp, headk, B, l, n,
                   kernels.ptr(m.q32), kernels.ptr(m.qneg32))
    kernels.note_shape(op, B, l, 0 if head is None else headk,
                       "" if op == "neg" else ("same", "plane", "limb")[b_mode])
    return out


def row_sum_plain(rows, q):
    """Plain version of ``row_sum``: the JAX package's chain of mod_adds."""
    acc = rows[0]
    for r in rows[1:]:
        acc = mod_add(acc, r, q)
    return acc


def row_sum(rows: torch.Tensor, m: Moduli) -> torch.Tensor:
    """Sum over the leading axis of rows [R, ..., l, N] mod q -> [..., l, N]:
    K11's row-sum pass for CUDA tensors (64-bit sums reduced once: the same
    canonical residues, reduced without a division), the plain version for
    CPU tensors."""
    if not rows.is_cuda:
        return row_sum_plain(rows, m.q)
    l, n = rows.shape[-2], rows.shape[-1]
    if rows.dim() < 3 or l > m.q32.numel():
        raise ValueError(f"row_sum: rows {tuple(rows.shape)}")
    if not rows[0].is_contiguous():
        rows = rows.contiguous()
    R, B = rows.shape[0], rows[0].numel() // (l * n)
    kernels.check_cuda("row_sum", rows, contiguous=False)
    kernels.check_cuda("row_sum", m.q32, m.qneg32, m.r1_32, m.r2_32)
    out = torch.empty(rows.shape[1:], dtype=torch.int32, device=rows.device)
    kernels.check_aligned("row_sum", out)
    kernels.launch("imtpu_mod_sum", "mod_sum", out, kernels.ptr(rows),
                   rows.stride(0), R, B, l, n, kernels.ptr(m.q32), kernels.ptr(m.qneg32),
                   kernels.ptr(m.r1_32), kernels.ptr(m.r2_32))
    kernels.note_shape("row_sum", B, l, R, "")
    return out


# ---------------------------------------------------------------------------
# Host-side (numpy / python int) helpers for constant generation
# ---------------------------------------------------------------------------


def host_mont_constants(q: int):
    """Return (qneg_inv, r1, r2, r3) for prime q: -q^{-1} mod 2^32, and
    R, R^2, R^3 mod q."""
    qinv = pow(q, -1, R)
    qneg_inv = (R - qinv) % R
    return qneg_inv, R % q, (R * R) % q, (R * R * R) % q


def host_to_mont(x: np.ndarray, q: int) -> np.ndarray:
    """Standard residues in [0, q) -> Montgomery form (exact via uint64)."""
    return ((x.astype(np.uint64) * np.uint64(R % q)) % np.uint64(q)).astype(np.uint32)


def host_from_mont(x: np.ndarray, q: int) -> np.ndarray:
    rinv = pow(R, -1, q)
    return ((x.astype(np.uint64) * np.uint64(rinv)) % np.uint64(q)).astype(np.uint32)


def host_shoup(w: np.ndarray, q: int) -> np.ndarray:
    """floor(w * 2^32 / q) for constant arrays (exact, via uint64)."""
    return ((w.astype(np.uint64) << np.uint64(32)) // np.uint64(q)).astype(np.uint32)


def host_pow16_mont(q: int) -> np.ndarray:
    """uint32[4]: 2^{16k} * R mod q (the JAX mont_dot lane fold)."""
    return np.array([(1 << (16 * k)) * R % q for k in range(4)], dtype=np.uint32)


def host_rinv(q: int) -> int:
    """R^{-1} mod q."""
    return pow(R, -1, q)


def to_tensor(x: np.ndarray, device) -> torch.Tensor:
    """uint32 residues (numpy) -> int32 tensor with the same bits."""
    x = np.ascontiguousarray(x, dtype=np.uint32)
    if not x.flags.writeable:  # torch.from_numpy wants a writable buffer
        x = x.copy()
    return torch.from_numpy(x.view(np.int32)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 residue tensor -> uint32 numpy array with the same bits."""
    return t.detach().cpu().numpy().view(np.uint32)

"""Senders: server-side homomorphic similarity + compare pipelines for
the five approaches (port of image_matching_tpu/matching/senders.py):
Baseline (1), GROTE (2), Blind-Match (3), HERS (4) and HyDia (5).

``ct_dot``, the diagonal contraction, launches kernel K2
(``csrc/ct_dot.cu``) for CUDA tensors and runs ``ct_dot_plain`` for CPU
tensors; ``ct_dot_seeded``, the streamed senders' contraction of a
seed-compressed group, launches K2's seeded variant (c1 drawn in
registers) or runs ``ct_dot_seeded_plain``; the modular sums of many rows
launch K11's row sum (``mm.row_sum``).  The JAX module's jit runners and segments have no
counterpart (PyTorch runs eagerly), and its ``vmap``/``lax.map`` over
score ciphertexts, DB batches and groups become Python loops or a leading
batch axis in chunks of ``CkksContext.ROW_CHUNK`` (of ``compare_chunk()``
for the compare circuit).
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..ckks import poly_eval
from ..ckks.context import CkksContext, Ciphertext
from ..ops import kernels
from ..ops import modmath as mm
from ..ops import prng
from ..utils import spans
from . import packing
from .config import MatchConfig
from .enrollers import BaseDB, BlindDB, DiagDB, HersDB


def ct_dot_plain(ctx: CkksContext, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Plain version of ``ct_dot`` (same shapes and values)."""
    l = min(A.shape[-2], B.shape[-2])
    A = A[..., :l, :]
    B = B[..., :l, :]
    q, rinv = ctx._qrow(ctx.q_limbs(l))
    kdim = B.dim() - 4  # the contraction axis (1 when B has a block axis)
    A = A.reshape((1,) * kdim + tuple(A.shape))
    a0, a1 = A.select(kdim + 1, 0), A.select(kdim + 1, 1)
    b0, b1 = B.select(kdim + 1, 0), B.select(kdim + 1, 1)
    c0 = mm.mont_dot(a0, b0, kdim, q, rinv)
    c2 = mm.mont_dot(a1, b1, kdim, q, rinv)
    c1 = mm.mont_dot(torch.cat([a0, a1], dim=kdim), torch.cat([b1, b0], dim=kdim),
                     kdim, q, rinv)
    return torch.stack([c0, c1, c2], dim=-3)


def ct_dot(ctx: CkksContext, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Sum_k A_k (x) B_k for stacks of 2-component ciphertexts
    A [K, 2, la, N] and B [K, 2, lb, N] -> unrelinearized 3-component data
    [3, l, N], l = min(la, lb) (the higher operand's top limbs are dropped:
    free modulus reduction).  B may carry a leading block axis,
    [nb, K, 2, lb, N] -> [nb, 3, l, N], each block contracted with A.

    The hot kernel of every similarity computation: kernel K2 for CUDA
    tensors, ``ct_dot_plain`` for CPU tensors."""
    if not A.is_cuda:
        return ct_dot_plain(ctx, A, B)
    blocked = B.dim() == 5
    Bb = B if blocked else B[None]
    A = A.contiguous()
    Bb = Bb.contiguous()
    K, _, LA, n = A.shape
    nb, KB, _, LB, _ = Bb.shape
    if KB != K or A.shape[1] != 2 or Bb.shape[2] != 2 or n != ctx.n:
        raise ValueError(f"ct_dot: shapes {tuple(A.shape)} and {tuple(B.shape)}")
    l = min(LA, LB)
    _check_grid("ct_dot", l)
    out = torch.empty((nb, 3, l, n), dtype=torch.int32, device=A.device)
    kernels.check_cuda("ct_dot", A, Bb, ctx.q32, ctx.qneg32, ctx.r1_32, ctx.r2_32)
    kernels.launch("imtpu_ct_dot", "ct_dot", out, kernels.ptr(A),
                   kernels.ptr(Bb), K, nb, l, n, LA, LB, kernels.ptr(ctx.q32),
                   kernels.ptr(ctx.qneg32), kernels.ptr(ctx.r1_32), kernels.ptr(ctx.r2_32))
    return out if blocked else out[0]


def _check_grid(name: str, l: int):
    if l > 65535:
        raise ValueError(f"{name}: {l} limbs exceed the kernel's grid (65535)")


def ct_dot_seeded_plain(ctx: CkksContext, A: torch.Tensor, c0: torch.Tensor, seed: int,
                        group: int, blocks: int, valid: bool = True) -> torch.Tensor:
    """Plain version of ``ct_dot_seeded``: ``ct_dot_plain`` over the stack of
    c0 and its c1 (``uniform_residues_plain``, zero with c0 for a padding
    group)."""
    BK, L, n = c0.shape
    if valid:
        c1 = prng.uniform_residues_plain(seed, group, (BK, L, n), ctx.q32, ctx.r1_32)
    else:
        c0 = c1 = torch.zeros((BK, L, n), dtype=torch.int32, device=c0.device)
    B = torch.stack([c0, c1], dim=1).reshape(blocks, BK // blocks, 2, L, n)
    return ct_dot_plain(ctx, A, B)


def ct_dot_seeded(ctx: CkksContext, A: torch.Tensor, c0: torch.Tensor, seed: int, group: int,
                  blocks: int, valid: bool = True) -> torch.Tensor:
    """The contraction of A [K, 2, la, N] with the nb = ``blocks`` blocks of
    K seed-compressed ciphertexts of one group, c0 int32 [nb*K, L, N]
    (``store.groups[g]`` where it lies, a staging buffer or a card-to-card
    copy) and c1 = ``ctx.expand_c1(seed, group, nb*K, L)``: what
    ``ct_dot(ctx, A, stack([c0, c1], 1).reshape(nb, K, 2, L, N))``
    computes, [nb, 3, l, N] with l = min(la, L).  The c1 counter runs over
    the group's L limbs whatever l is.  ``valid=False`` is a padding group,
    an exact encryption of 0 (c0 and c1 zero: the JAX module's ``c1 *
    valid``): c0 is not read and the result is zero.

    K2's seeded variant for CUDA tensors (c1 drawn in registers with K5's
    Threefry, never written), ``ct_dot_seeded_plain`` for CPU tensors."""
    BK, L, n = c0.shape
    K, two, LA, nA = A.shape
    if two != 2 or nA != n or n != ctx.n or K * blocks != BK:
        raise ValueError(f"ct_dot_seeded: A {tuple(A.shape)} against c0 {tuple(c0.shape)} "
                         f"in {blocks} blocks")
    if not A.is_cuda:
        return ct_dot_seeded_plain(ctx, A, c0, seed, group, blocks, valid)
    l = min(LA, L)
    if not valid:
        return torch.zeros((blocks, 3, l, n), dtype=torch.int32, device=A.device)
    _check_grid("ct_dot_seeded", l)
    A = A.contiguous()
    out = torch.empty((blocks, 3, l, n), dtype=torch.int32, device=A.device)
    kernels.check_cuda("ct_dot_seeded", A, c0, ctx.q32, ctx.qneg32, ctx.r1_32, ctx.r2_32)
    kernels.launch("imtpu_ct_dot_seeded", "ct_dot_seeded", out, kernels.ptr(A),
                   kernels.ptr(c0), K, blocks, l, n, LA, L, kernels.ptr(ctx.q32),
                   kernels.ptr(ctx.qneg32), kernels.ptr(ctx.r1_32), kernels.ptr(ctx.r2_32),
                   seed & prng.M32, group & prng.M32)
    return out


def compare_chunk() -> int:
    """Scores per stack of the compare circuit: ``IMTPU_COMPARE_CHUNK``, 16
    by default (the JAX package's knob).  Each score of a stack holds about
    deg/2 ciphertexts of Chebyshev basis at once, so the chunk bounds the
    circuit's device memory (``streaming._reserve_bytes``)."""
    return int(os.environ.get("IMTPU_COMPARE_CHUNK", "16"))


class Sender:
    """Abstract sender (reference include/sender.h)."""

    def __init__(self, ctx: CkksContext, cfg: MatchConfig, num_vectors: int):
        self.ctx = ctx
        self.cfg = cfg
        self.num_vectors = num_vectors

    def _compare_many(self, scores: Iterable[Ciphertext]) -> List[Ciphertext]:
        """chebyshevCompare over a batch of same-shape score ciphertexts."""
        return self._compare_many_with(scores, self.cfg.match_threshold)

    def _compare_many_with(self, scores: Iterable[Ciphertext], thr: float) -> List[Ciphertext]:
        """One score alone takes one compare circuit; more are stacked,
        [B, 2, l, N], up to ``compare_chunk()`` per stack, and each stack
        takes one compare circuit (the JAX package's vmap over the scores
        and its segments' chunks).  No op of the circuit reduces across the
        stack, so each flag equals that score's own, residue for residue.
        Each circuit runs in an ``imtpu.compare`` span."""
        scores = list(scores)
        if len(scores) == 1:
            with spans.span("compare", {"scores": 1}):
                return [poly_eval.chebyshev_compare(self.ctx, scores[0], thr,
                                                    self.cfg.comp_depth)]
        chunk = compare_chunk()
        out: List[Ciphertext] = []
        for i in range(0, len(scores), chunk):
            out += self._compare_stack(scores[i : i + chunk], thr)
        return out

    def _compare_stack(self, scores: List[Ciphertext], thr: float) -> List[Ciphertext]:
        """One compare circuit over the stack of ``scores`` (one shape, one
        scale) -> their flags."""
        scale = scores[0].scale
        shape = scores[0].data.shape
        for s in scores[1:]:
            self.ctx._check_scales(scale, s.scale)
            if s.data.shape != shape:
                raise ValueError(f"compare: scores of shapes {tuple(shape)} and "
                                 f"{tuple(s.data.shape)} in one stack")
        with spans.span("compare", {"scores": len(scores)}):
            stack = Ciphertext(torch.stack([s.data for s in scores]), scale)
            flags = poly_eval.chebyshev_compare(self.ctx, stack, thr, self.cfg.comp_depth)
            return [Ciphertext(d, flags.scale) for d in flags.data]

    def _membership_reduce(self, flags: List[Ciphertext]) -> Ciphertext:
        """EvalAddManyInPlace + EvalSum(batch): flags of one shape and
        scale are summed in one pass (K11's row sum on CUDA)."""
        ctx = self.ctx
        acc = flags[0]
        if len(flags) > 1 and all(f.data.shape == acc.data.shape for f in flags):
            for f in flags[1:]:
                ctx._check_scales(acc.scale, f.scale)
            acc = Ciphertext(mm.row_sum(torch.stack([f.data for f in flags]),
                                        ctx._mod(acc.limbs)), acc.scale)
        else:
            for f in flags[1:]:
                acc = ctx.add(acc, f)
        return ctx.eval_sum(acc, ctx.slots)

    def compute_similarity(self, query: List[Ciphertext]) -> List[Ciphertext]:
        raise NotImplementedError

    def membership_scenario(self, query: List[Ciphertext]) -> Ciphertext:
        return self._membership_reduce(self._compare_many(self.compute_similarity(query)))

    def index_scenario(self, query: List[Ciphertext]) -> List[Ciphertext]:
        return self._compare_many(self.compute_similarity(query))

    def required_rotations(self) -> List[int]:
        """Rotation indices whose keys must exist (power-of-two keys are
        always generated separately)."""
        return []

    def run_membership(self, query_cts: List[Ciphertext]) -> Ciphertext:
        return self.membership_scenario(query_cts)

    def run_index(self, query_cts: List[Ciphertext]) -> List[Ciphertext]:
        return self.index_scenario(query_cts)


def shard_view(sender: Sender, ctx: CkksContext, data: Optional[torch.Tensor] = None) -> Sender:
    """A shallow copy of ``sender`` that computes with ``ctx`` (a context
    replica on a shard's device) and, when ``data`` is given, over that
    block of its DB's group axis instead of the whole; the sender itself is
    left as it is."""
    view = copy.copy(sender)
    view.ctx = ctx
    if data is not None:
        view.db = dataclasses.replace(sender.db, data=data)
    return view


def diag_rotations(dim: int, bsgs: bool, n1: int) -> List[int]:
    """Rotation keys a HyDia sender needs: the n1-1 baby and n2-1 giant
    steps of BSGS, else the reference's dim-1 rotations."""
    if bsgs:
        return list(range(1, n1)) + [n1 * j for j in range(1, dim // n1)]
    return list(range(1, dim))


def diag_query_stack(ctx: CkksContext, qct: Ciphertext, n1: int) -> torch.Tensor:
    """The query and its n1-1 baby rotations, [n1, 2, l, N]: one batched
    hoisted keyswitch."""
    if n1 == 1:
        return qct.data[None]
    digs = ctx.hoisted_precompute(qct)
    rot = ctx.hoisted_rotate_stack(qct, digs, list(range(1, n1)))
    return torch.cat([qct.data[None], rot], dim=0)


def diag_group_score(ctx: CkksContext, t3: torch.Tensor, n1: int,
                     prod_scale: float) -> Ciphertext:
    """Similarity score ciphertext of one diagonal group from its blocked
    contraction with the query stack, t3 [n2, 3, l, N] (``ct_dot`` or
    ``ct_dot_seeded`` in n2 = dim / n1 blocks): relinearize, giant
    rotations (BSGS), rescale, in an ``imtpu.score`` span."""
    with spans.span("score"):
        n2 = t3.shape[0]
        if n2 == 1:
            return ctx.rescale_score(ctx.relinearize(Ciphertext(t3[0], prod_scale)))
        inners = ctx.relinearize_stack(t3)  # [n2, 2, l, N]
        # giant rotations: one batched keyswitch over stacked rows
        rot = ctx.rotate_stack(inners[1:], [n1 * j for j in range(1, n2)], prod_scale)
        mod = ctx._mod(inners.shape[-2])
        summed = mm.residue_op("add", inners[0], mm.row_sum(rot, mod), mod)
        return ctx.rescale_score(Ciphertext(summed, prod_scale))


class DiagonalSender(Sender):
    """Approach 5, HyDia: diagonal matrix-vector products with hoisted
    rotations; BSGS variant by default (diagonals pre-rotated at
    enrollment: n1-1 hoisted baby rotations of the query plus n2-1 giant
    rotations per group), else the reference's dim-1 hoisted rotations."""

    def __init__(self, ctx, cfg, db: DiagDB):
        super().__init__(ctx, cfg, db.num_vectors)
        self.db = db

    def required_rotations(self) -> List[int]:
        return diag_rotations(self.cfg.vector_dim, self.db.bsgs, self.db.n1)

    def compute_similarity(self, query: List[Ciphertext]) -> List[Ciphertext]:
        qct = query[0]
        n1 = self.db.n1 if self.db.bsgs else self.cfg.vector_dim
        Q = diag_query_stack(self.ctx, qct, n1)
        prod_scale = qct.scale * self.db.scale
        scores = []
        for dbd in self.db.data:  # [dim, 2, l, N] per group
            # all inner sums: one contraction in dim / n1 blocks
            t3 = ct_dot(self.ctx, Q, dbd.reshape(-1, n1, *dbd.shape[1:]))
            scores.append(diag_group_score(self.ctx, t3, n1, prod_scale))
        return scores


def generate_query_helper(ctx: CkksContext, cfg: MatchConfig, query_ct: Ciphertext,
                          index: int) -> Ciphertext:
    """Server-side expansion of a single replicated-query ciphertext into
    the dimension-major form: mask feature ``index``, EvalSum over
    vector_dim to fill all slots, rescale (reference generateQueryHelper)."""
    mask = np.zeros(ctx.slots)
    mask[index::cfg.vector_dim] = 1.0
    pt = ctx.encode_cached(("qh_mask", cfg.vector_dim, index), mask, query_ct.limbs,
                           ctx.params.scale)
    out = ctx.eval_sum(ctx.mul_plain(query_ct, pt), cfg.vector_dim)  # rotations pre-rescale
    return ctx.rescale(out)


def expand_query_alt(ctx: CkksContext, cfg: MatchConfig, qct: Ciphertext) -> List[Ciphertext]:
    """All vector_dim ``generate_query_helper`` expansions (the JAX
    package's vmap becomes a loop)."""
    return [generate_query_helper(ctx, cfg, qct, j) for j in range(cfg.vector_dim)]


def hers_query_stack(ctx: CkksContext, cfg: MatchConfig,
                     query: List[Ciphertext]) -> Tuple[torch.Tensor, float]:
    """The HERS query as one stack [dim, 2, l, N] and its scale; a single
    replicated-query ciphertext (encryptQueryAlt) is expanded first."""
    if cfg.hers_alt_query and len(query) == 1:
        query = expand_query_alt(ctx, cfg, query[0])
    return torch.stack([c.data for c in query]), query[0].scale


def hers_matrix_score(ctx: CkksContext, cfg: MatchConfig, Q: torch.Tensor, dbd: torch.Tensor,
                      q_scale: float, db_scale: float) -> Ciphertext:
    """Score ciphertext of one HERS matrix dbd [dim, 2, l, N]: score =
    sum_j q_j (*) d_j as one contraction (ct_dot, K=dim), relinearize,
    rescale; with ``faithful_hers`` the reference's per-term product,
    relinearization and rescale, then the modular sum."""
    if not cfg.faithful_hers:
        t3 = ct_dot(ctx, Q, dbd)
        return ctx.rescale_score(ctx.relinearize(Ciphertext(t3, q_scale * db_scale)))
    outs = [ctx.rescale_score(ctx.relinearize(ctx.mul(Ciphertext(Q[j], q_scale),
                                                      Ciphertext(dbd[j], db_scale))))
            for j in range(Q.shape[0])]
    acc = mm.row_sum(torch.stack([o.data for o in outs]), ctx._mod(outs[0].limbs))
    return Ciphertext(acc, outs[0].scale)


class HersSender(Sender):
    """Approach 4 (HERS): dimension-major DB; score(m) = sum_j q_j (*)
    d_{m,j}.  Needs only the power-of-two rotation keys (the membership
    EvalSum and the alt query's expansion)."""

    def __init__(self, ctx, cfg, db: HersDB):
        super().__init__(ctx, cfg, db.num_vectors)
        self.db = db

    def compute_similarity(self, query: List[Ciphertext]) -> List[Ciphertext]:
        Q, sq = hers_query_stack(self.ctx, self.cfg, query)
        return [hers_matrix_score(self.ctx, self.cfg, Q, dbd, sq, self.db.scale)
                for dbd in self.db.data]  # [dim, 2, l, N] per matrix


class BaseSender(Sender):
    """Approach 1 (Baseline): sequential DB, one inner product per batch
    ciphertext, then the order-preserving merge."""

    def __init__(self, ctx, cfg, db: BaseDB):
        super().__init__(ctx, cfg, db.num_vectors)
        self.db = db

    def required_rotations(self) -> List[int]:
        # direct keys for the merge chain: one keyswitch per step instead of
        # the signed power-of-two decomposition (ctx.rotate_any)
        return packing.merge_chain_rotations(self.ctx.slots, self.cfg.vector_dim)

    def _raw_scores(self, query: List[Ciphertext]) -> List[Ciphertext]:
        """Per batch ciphertext: the product with the query, relinearize,
        EvalSum(dim) BEFORE rescaling (its rotate-add noise stays far below
        the product scale), rescale_score; over a leading batch axis in
        chunks of ``ROW_CHUNK`` ciphertexts."""
        ctx, dim, qct = self.ctx, self.cfg.vector_dim, query[0]
        out: List[Ciphertext] = []
        for i in range(0, self.db.data.shape[0], ctx.ROW_CHUNK):
            rows = self.db.data[i : i + ctx.ROW_CHUNK]
            prod = torch.stack([ctx.mul(qct, Ciphertext(d, self.db.scale)).data for d in rows])
            r = ctx.relinearize(Ciphertext(prod, qct.scale * self.db.scale))
            r = ctx.rescale_score(ctx.eval_sum(r, dim))
            out += [Ciphertext(d, r.scale) for d in r.data]
        return out

    def compute_similarity(self, query: List[Ciphertext]) -> List[Ciphertext]:
        return packing.merge_ciphers(self.ctx, self._raw_scores(query), self.cfg.vector_dim)


def grote_row_len(slots: int) -> int:
    """Row length of GROTE's near-square arrangement of the scores."""
    return 2 ** math.ceil(math.log2(slots) / 2)


class GroteSender(BaseSender):
    """Approach 2 (GROTE): baseline scores + alpha-norm group testing over a
    near-square arrangement."""

    def required_rotations(self) -> List[int]:
        # base merge chain + the alpha-row merge chain (row_len dimension)
        row_len = grote_row_len(self.ctx.slots)
        return sorted(set(BaseSender.required_rotations(self)
                          + packing.merge_chain_rotations(self.ctx.slots, row_len)))

    def _alpha_squares(self, ct: Ciphertext) -> Ciphertext:
        ctx = self.ctx
        for _ in range(self.cfg.alpha_depth):
            ct = ctx.rescale(ctx.relinearize(ctx.square(ct)))
        return ct

    def _alpha_product(self, s: Ciphertext) -> Ciphertext:
        """s^(2^alpha_depth) times s, relinearized (at s's level when the
        squares' level is lower)."""
        ctx = self.ctx
        a = self._alpha_squares(s)
        l = min(a.limbs, s.limbs)
        return ctx.mul_relin(ctx.drop_to(a, l), ctx.drop_to(s, l))

    def alpha_norm_rows(self, scores: List[Ciphertext], row_len: int) -> List[Ciphertext]:
        """reference alphaNormRows: per score ciphertext (one at a time, the
        width cap of the JAX package's batch), the alpha product, EvalSum
        over a row before the rescale, then the merge of the rows."""
        ctx = self.ctx
        alist = [ctx.rescale(ctx.eval_sum(self._alpha_product(s), row_len)) for s in scores]
        return packing.merge_ciphers(ctx, alist, row_len)

    def alpha_norm_columns(self, scores: List[Ciphertext], row_len: int) -> List[Ciphertext]:
        """reference alphaNormColumns: per score ciphertext the alpha
        product, the doubling rotate-add chain over the rows at the
        un-rescaled product scale, the first-row mask, two rescales; then
        the columns packed by the combine tree."""
        ctx = self.ctx
        batch = ctx.slots
        rmask = np.zeros(batch)
        rmask[:row_len] = 1.0
        alist = []
        for s in scores:
            a = self._alpha_product(s)
            j = row_len
            while j < batch:
                a = ctx.add(a, ctx.binary_rotate(a, -j))
                j *= 2
            m = ctx.encode_cached(("grote_rowmask", row_len), rmask, a.limbs, ctx.params.scale)
            alist.append(ctx.rescale(ctx.rescale(ctx.mul_plain(a, m))))
        if len(alist) == 1:
            return alist
        out_n = math.ceil(len(scores) * row_len / batch)
        return packing._tree_pack(ctx, alist, row_len, out_n)

    def membership_scenario(self, query: List[Ciphertext]) -> Ciphertext:
        scores = self.compute_similarity(query)
        if self.cfg.faithful_grote:
            # the reference computes colCipher here and never uses it: the
            # eager port computes it, waits for it and discards it, so the
            # timed membership pays the reference's work
            cols = self.alpha_norm_columns(scores, grote_row_len(self.ctx.slots))
            if cols[0].data.is_cuda:
                torch.cuda.synchronize(cols[0].data.device)
            del cols
        return self._membership_reduce(self._compare_many(scores))

    def index_scenario(self, query: List[Ciphertext]) -> List[Ciphertext]:
        row_len = grote_row_len(self.ctx.slots)
        scores = self.compute_similarity(query)
        rows = self.alpha_norm_rows(scores, row_len)
        cols = self.alpha_norm_columns(scores, row_len)
        thr = self.cfg.match_threshold
        for _ in range(self.cfg.alpha_depth):
            thr = thr * thr
        return self._compare_many_with(rows, thr) + self._compare_many_with(cols, thr)


class BlindSender(Sender):
    """Approach 3 (Blind-Match): chunked DB, per matrix the chunk
    contraction (K2), relinearize, log rotate-add over the chunk, then the
    compression."""

    def __init__(self, ctx, cfg, db: BlindDB):
        super().__init__(ctx, cfg, db.num_vectors)
        self.db = db

    def compute_similarity(self, query: List[Ciphertext]) -> List[Ciphertext]:
        ctx, cl = self.ctx, self.cfg.chunk_len
        Q = torch.stack([c.data for c in query])  # [cpv, 2, l, N]
        prod_scale = query[0].scale * self.db.scale
        scores: List[Ciphertext] = []
        for i in range(0, self.db.data.shape[0], ctx.ROW_CHUNK):
            t3 = ct_dot(ctx, Q, self.db.data[i : i + ctx.ROW_CHUNK])  # [m, 3, l, N]
            ct = ctx.relinearize(Ciphertext(t3, prod_scale))
            # log rotate-add over the chunk at the full product scale
            ct = ctx.rescale_score(ctx.eval_sum(ct, cl))
            scores += [Ciphertext(d, ct.scale) for d in ct.data]
        return packing.compress_ciphers(ctx, scores, cl)


SENDERS = {1: BaseSender, 2: GroteSender, 3: BlindSender, 4: HersSender, 5: DiagonalSender}


def make_sender(approach: int, ctx: CkksContext, cfg: MatchConfig, db) -> Sender:
    if approach not in SENDERS:
        raise ValueError(f"approach must be 1..5, got {approach}")
    return SENDERS[approach](ctx, cfg, db)

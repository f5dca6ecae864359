"""Slot-packing operations: order-preserving merge and order-permuting
compression (port of image_matching_tpu/matching/packing.py).

Both repack scattered similarity scores into dense ciphertexts using
plaintext masks (multiplicative levels) and rotate-adds.  The JAX
package's ``vmap``/``lax.map`` over many ciphertexts becomes a leading
batch axis processed in chunks of ``CkksContext.ROW_CHUNK``; a rotation
by one amount over a stack is one batched keyswitch with one shared key;
the modular adds and the accumulation of many rows launch kernel K11 on
CUDA tensors.
"""

from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch

from ..ckks.context import Ciphertext, CkksContext
from ..ops import modmath as mm


def merge_chain_rotations(slots: int, dimension: int) -> List[int]:
    """Rotation amounts of merge_single's doubling chain for `dimension`
    ((dimension-1)*2^j): senders request direct keys for these via
    required_rotations so each chain step is ONE keyswitch."""
    out = []
    output_size = slots // dimension
    i = 1
    while i < output_size:
        out.append((dimension - 1) * i)
        i *= 2
    return out


def merge_mask(ctx: CkksContext, dimension: int, segment: int, limbs: int, scale: float):
    """Mask with `segment` ones every dimension*segment slots (reference
    generateMergeMask)."""
    batch = ctx.slots
    mask = np.zeros(batch)
    i = 0
    while i < batch:
        mask[i : i + segment] = 1.0
        i += dimension * segment
    return ctx.encode_cached(("merge_mask", dimension, segment), mask, limbs, scale)


def merge_single(ctx: CkksContext, ct: Ciphertext, dimension: int, defer: bool = False):
    """Pack every dimension-th slot to the front (reference
    mergeSingleCipher).  Consumes 2 levels.  ``ct`` may be one ciphertext
    or a batch [B, 2, l, N], every one packed the same way.

    Rescales are DEFERRED past the rotate-add chain: each rotation's
    keyswitch noise is amplified by the doubling partial sums, so the chain
    runs at the un-rescaled mask-product scale.  With defer=True, returns
    (ct, pending_rescales)."""
    batch = ctx.slots
    output_size = batch // dimension
    padding = 1
    rot_factor = dimension - 1
    pending = 0
    i = 1
    while i < output_size:
        if i >= padding:
            m = merge_mask(ctx, dimension, i, ct.limbs, ctx.params.scale)
            ct = ctx.mul_plain(ct, m)
            pending += 1
            padding = i * dimension
        ct = ctx.add(ct, ctx.rotate_any(ct, rot_factor * i))
        i *= 2
    m = merge_mask(ctx, dimension, output_size, ct.limbs, ctx.params.scale)
    ct = ctx.mul_plain(ct, m)
    pending += 1
    # every current caller has dimension >= sqrt(slots), so pending stays
    # <= 2; a smaller dimension would grow the accumulated scale
    # s*Delta^pending past the modulus headroom
    assert pending <= 2, (
        f"merge_single accumulated {pending} deferred rescales "
        f"(dimension {dimension} < sqrt(slots)); rescale earlier")
    if defer:
        return ct, pending
    for _ in range(pending):
        ct = ctx.rescale(ct)
    return ct


def _batched(ctx: CkksContext, fn: Callable[[Ciphertext], Ciphertext],
             cts: List[Ciphertext]) -> List[Ciphertext]:
    """fn over a list of same-shape ciphertexts, run on a leading batch
    axis in chunks of ``ctx.ROW_CHUNK`` (the JAX package's capped vmap)."""
    if len(cts) == 1:
        return [fn(cts[0])]
    out: List[Ciphertext] = []
    for i in range(0, len(cts), ctx.ROW_CHUNK):
        res = fn(Ciphertext(torch.stack([c.data for c in cts[i : i + ctx.ROW_CHUNK]]),
                            cts[0].scale))
        out += [Ciphertext(d, res.scale) for d in res.data]
    return out


def _rotate_and_pack(ctx: CkksContext, cts: List[Ciphertext], amounts: List[int],
                     out_idx: List[int], out_n: int) -> List[Ciphertext]:
    """Rotate ct[i] left by amounts[i] (ctx.rotate_rows_binary) and sum the
    rows mod q into out_n output ciphertexts per out_idx (K11's row sum)."""
    stacked = torch.stack([c.data for c in cts])
    rotated = ctx.rotate_rows_binary(stacked, amounts)
    mod = ctx._mod(stacked.shape[-2])
    outs = []
    for oc in range(out_n):
        rows = [i for i, o in enumerate(out_idx) if o == oc]
        if rows == list(range(rows[0], rows[-1] + 1)):
            sel = rotated[rows[0] : rows[-1] + 1]
        else:
            sel = rotated.index_select(0, ctx._index(rows))
        outs.append(Ciphertext(mm.row_sum(sel, mod), cts[0].scale))
    return outs


def _tree_pack(ctx: CkksContext, cts: List[Ciphertext], step: int,
               out_n: int) -> List[Ciphertext]:
    """Pack rows whose target amounts follow the uniform pattern
    amounts[i] = -(step*i) mod slots, out_idx[i] = (step*i)//slots — the
    merge/alpha layout — via a pairwise combine tree:

        T^(l+1)_j = T^(l)_{2j} + rot(T^(l)_{2j+1}, -step*2^l)

    Each level is ONE fixed-amount rotation (a power of two, covered by the
    -2^k keys) over a halving stack.  ``step`` must be a power of two."""
    if step <= 0 or step & (step - 1):
        raise ValueError(f"_tree_pack: step {step} is not a power of two")
    batch = ctx.slots
    data = torch.stack([c.data for c in cts])
    R = data.shape[0]
    gsz = batch // step  # rows per output ciphertext
    pad = out_n * gsz - R
    if pad:
        # zero rows are exact encryptions of 0: rotations and adds keep
        # them inert
        data = torch.cat([data, data.new_zeros((pad,) + data.shape[1:])])
    mod = ctx._mod(data.shape[-2])
    cur = data.reshape(out_n, gsz, *data.shape[1:])
    lvl = 0
    while cur.shape[1] > 1:
        even = cur[:, 0::2]
        odd = cur[:, 1::2]
        # move the odd subtree RIGHT by step*2^l slots = left-rotate by its
        # negative
        s = (step << lvl) % batch
        if s:
            perm, key = ctx._rot_entry(ctx.rotation_galois(-s))
            flat = odd.reshape(-1, *data.shape[1:])
            odd = ctx._rotate_rows(flat, perm, key).reshape(odd.shape)
        cur = mm.residue_op("add", even, odd, mod)
        lvl += 1
    return [Ciphertext(cur[oc, 0], cts[0].scale) for oc in range(out_n)]


def merge_ciphers(ctx: CkksContext, cts: List[Ciphertext], dimension: int) -> List[Ciphertext]:
    """Merge many ciphertexts' every-dimension-th slots into few dense
    ciphertexts, order preserving (reference mergeCiphers).  The packing
    rotations run at the deferred (pre-rescale) scale; the pending rescales
    land on the few packed outputs."""
    batch = ctx.slots
    per = batch // dimension
    out_n = math.ceil(per * len(cts) / batch)
    pend = [0]

    def one(c):
        out, p = merge_single(ctx, c, dimension, defer=True)
        pend[0] = p
        return out

    merged = _batched(ctx, one, cts)
    outs = merged if len(merged) == 1 else _tree_pack(ctx, merged, per, out_n)
    done = []
    for o in outs:
        for _ in range(pend[0]):
            o = ctx.rescale(o)
        done.append(o)
    return done


def compress_ciphers(ctx: CkksContext, cts: List[Ciphertext],
                     dimension: int) -> List[Ciphertext]:
    """Blind-Match compression: keep every dimension-th slot, permuted
    packing (reference compressCiphers).  Consumes 1 level."""
    batch = ctx.slots
    out_n = math.ceil(len(cts) / dimension)
    maskv = np.zeros(batch)
    maskv[::dimension] = 1.0

    def mask_one(c: Ciphertext) -> Ciphertext:
        # rescale deferred past the packing rotations (see merge_ciphers)
        m = ctx.encode_cached(("compress_mask", dimension), maskv, c.limbs, ctx.params.scale)
        return ctx.mul_plain(c, m)

    masked = _batched(ctx, mask_one, cts)
    if len(masked) == 1:
        return [ctx.rescale(masked[0])]
    amounts = [-(i % dimension) % batch for i in range(len(masked))]
    out_idx = [i // dimension for i in range(len(masked))]
    outs = _rotate_and_pack(ctx, masked, amounts, out_idx, out_n)
    return [ctx.rescale(o) for o in outs]

"""Homomorphic polynomial evaluation: Chebyshev series (Paterson-Stockmeyer
over the Chebyshev basis) and power-basis polynomials, plus the hybrid
sign/compare circuit (port of image_matching_tpu/ckks/poly_eval.py).

Pure orchestration over the context, kept line for line with the JAX
version so that the same operations run in the same order: the outputs are
bit-identical for identical inputs and keys.  The JAX module's jit-segment
helpers (``BasisShim``, ``compare_stage_*``) have no counterpart: PyTorch
runs eagerly.

Chebyshev interpolation of the step function composed with Cheon's f4
degree-9 polynomial, then a +1 shift so match indicators sum additively
(reference chebyshevCompare).  A degree-59 series costs 6 levels, f4
costs 4: 10 total = COMP_DEPTH.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

from .context import CkksContext, Ciphertext

# Cheon et al. f4 composite-sign polynomial coefficients (power basis)
F4_COEFS = [
    0.0, 315.0 / 128.0, 0.0, -420.0 / 128.0, 0.0,
    378.0 / 128.0, 0.0, -180.0 / 128.0, 0.0, 35.0 / 128.0,
]

# signDepth -> Chebyshev degree (reference DEPTH_TO_DEGREE)
DEPTH_TO_DEGREE = {7: 5, 8: 13, 9: 27, 10: 59, 11: 119, 12: 247,
                   13: 495, 14: 1007, 15: 2031}


def chebyshev_coefficients(f, degree: int, a: float = -1.0, b: float = 1.0) -> np.ndarray:
    """Chebyshev interpolation coefficients of f on [a, b] at degree+1
    Chebyshev nodes (same construction OpenFHE uses)."""
    m = degree + 1
    theta = (np.arange(m) + 0.5) * np.pi / m
    x = np.cos(theta)
    xs = 0.5 * (b - a) * x + 0.5 * (a + b)
    fv = np.array([f(v) for v in xs], dtype=np.float64)
    j = np.arange(m)[:, None]
    c = (2.0 / m) * (fv[None, :] * np.cos(j * theta[None, :])).sum(axis=1)
    c[0] *= 0.5
    return c


class _DryCt:
    """Metadata-only ciphertext (limbs, scale) for dry-run depth/scale
    planning of the Paterson-Stockmeyer recursion."""

    __slots__ = ("limbs", "scale", "ncomp")

    def __init__(self, limbs: int, scale: float, ncomp: int = 2):
        self.limbs = limbs
        self.scale = scale
        self.ncomp = ncomp


class _DryCtx:
    """Mirror of CkksContext's scale/limb bookkeeping with no data: runs
    _ChebBasis/_PowerBasis/_eval_ps symbolically so a (baby size k)
    configuration can be validated — same asserts, zero compute."""

    def __init__(self, all_primes, scale: float):
        self.all_primes = all_primes
        self.params = type("P", (), {"scale": scale})()

    def _chk(self, a: float, b: float):
        if abs(math.log2(a) - math.log2(b)) > 1e-6:
            raise ValueError(f"scale mismatch: {a} vs {b}")

    def add(self, x, y):
        l = min(x.limbs, y.limbs)
        self._chk(x.scale, y.scale)
        return _DryCt(l, x.scale, max(x.ncomp, y.ncomp))

    def add_scalar(self, x, c):
        return _DryCt(x.limbs, x.scale, x.ncomp)

    def neg(self, x):
        return _DryCt(x.limbs, x.scale, x.ncomp)

    def drop_to(self, x, l):
        assert x.limbs >= l
        return _DryCt(l, x.scale, x.ncomp)

    def rescale(self, x):
        assert x.limbs >= 2, "cannot rescale below guard level"
        return _DryCt(x.limbs - 1, x.scale / self.all_primes[x.limbs - 1], x.ncomp)

    def square(self, x):
        return _DryCt(x.limbs, x.scale * x.scale, 3)

    def mul(self, x, y):
        l = min(x.limbs, y.limbs)
        return _DryCt(l, x.scale * y.scale, 3)

    def relinearize(self, x):
        return _DryCt(x.limbs, x.scale, 2)

    def mul_relin(self, x, y):
        return self.relinearize(self.mul(x, y))

    def mul_scalar(self, x, c, sigma):
        return _DryCt(x.limbs, x.scale * sigma, x.ncomp)

    def align_to(self, x, limbs, scale):
        if x.limbs == limbs and abs(math.log2(x.scale / scale)) < 1e-9:
            return x
        if abs(math.log2(x.scale / scale)) < 1e-9:
            return self.drop_to(x, limbs)
        assert x.limbs > limbs, "no spare level for scale alignment"
        return _DryCt(limbs, scale, x.ncomp)


def _smart_add(ctx: CkksContext, x: Ciphertext, y: Ciphertext) -> Ciphertext:
    """Add with automatic exact alignment of (limbs, scale)."""
    if x.limbs == y.limbs and abs(math.log2(x.scale / y.scale)) < 1e-9:
        return ctx.add(x, y)
    if x.limbs == y.limbs:
        # both need a spare level; align to one fewer limb at scheme scale
        tgt = x.limbs - 1
        sc = ctx.params.scale
        return ctx.add(ctx.align_to(x, tgt, sc), ctx.align_to(y, tgt, sc))
    deep, shallow = (x, y) if x.limbs < y.limbs else (y, x)
    return ctx.add(deep, ctx.align_to(shallow, deep.limbs, deep.scale))


class _ChebBasis:
    """Builds T_1..T_k plus power-of-two giants from a ciphertext input."""

    def __init__(self, ctx: CkksContext, x: Ciphertext, max_deg: int, k: int = 8):
        self.ctx = ctx
        self.B: Dict[int, Ciphertext] = {1: x}
        k = min(k, max(2, max_deg))
        for i in range(2, k + 1):
            self._build(i)
        self.baby_k = k
        self.giants = []
        g = k
        while 2 * g <= max_deg:
            self._double(g)
            g *= 2
            self.giants.append(g)

    def _double(self, i: int):
        ctx = self.ctx
        t = ctx.rescale(ctx.relinearize(ctx.square(self.B[i])))
        t = ctx.add(t, t)  # 2*T_i^2 (exact doubling, no level)
        self.B[2 * i] = ctx.add_scalar(t, -1.0)

    def _build(self, i: int):
        ctx = self.ctx
        if i in self.B:
            return
        if i % 2 == 0 and i // 2 in self.B:
            self._double(i // 2)
            return
        # T_i = 2*T_a*T_b - T_{a-b}
        a = (i + 1) // 2
        b = i - a
        ta, tb = self.B[a], self.B[b]
        l = min(ta.limbs, tb.limbs)
        prod = ctx.rescale(ctx.mul_relin(ctx.drop_to(ta, l), ctx.drop_to(tb, l)))
        prod = ctx.add(prod, prod)  # 2 T_a T_b
        if a == b:
            self.B[i] = ctx.add_scalar(prod, -1.0)
        else:
            diff = self.B[a - b]
            self.B[i] = _smart_add(ctx, prod, ctx.neg(diff))


def _cheb_divmod(c: List[float], m: int):
    """Divide a Chebyshev-basis polynomial by T_m:
    c(x) = q(x) * T_m(x) + r(x), deg r < m."""
    c = list(c)
    d = len(c) - 1
    q = [0.0] * (d - m + 1)
    for i in range(d, m - 1, -1):
        ci = c[i]
        c[i] = 0.0
        if ci == 0.0:
            continue
        if i == m:
            q[0] += ci
        else:
            q[i - m] += 2.0 * ci
            j = abs(i - 2 * m)
            c[j] -= ci
    return q, c[:m]


_MIN_SIGMA = float(2 ** 24)  # minimum plaintext scale for coefficient precision


def _retag(ct, scale: float):
    """Same ciphertext with its scale metadata replaced (exact-by-
    construction adjustments).  Works for real and dry ciphertexts."""
    if isinstance(ct, Ciphertext):
        return Ciphertext(ct.data, scale)
    return _DryCt(ct.limbs, scale, ct.ncomp)


def _term_to(ctx: CkksContext, ct: Ciphertext, c: float, tgt_l: int,
             tgt_s: float) -> Ciphertext:
    """c * ct brought to exactly (tgt_l, tgt_s) via a coefficient multiply
    at a freely chosen plaintext scale (plus rescales only when the raw
    sigma would be too small for coefficient precision)."""
    sigma = tgt_s / ct.scale
    j = 0
    while sigma < _MIN_SIGMA:
        sigma *= ctx.all_primes[tgt_l + j]
        j += 1
    assert ct.limbs >= tgt_l + j, "no headroom for coefficient scale"
    t = ctx.mul_scalar(ctx.drop_to(ct, tgt_l + j), float(c), sigma)
    for _ in range(j):
        t = ctx.rescale(t)
    return _retag(t, tgt_s)  # exact by construction of sigma


def _combo(ctx: CkksContext, basis: Dict[int, Ciphertext],
           coeffs: Sequence[float], tgt_l: int, tgt_s: float) -> Ciphertext:
    """sum_i coeffs[i] * B_i + coeffs[0] at exactly (tgt_l, tgt_s)."""
    terms = [(i, c) for i, c in enumerate(coeffs) if i > 0 and abs(c) > 1e-13]
    if not terms:
        z = _term_to(ctx, basis[1], 0.0, tgt_l, tgt_s)
        return ctx.add_scalar(z, float(coeffs[0]) if len(coeffs) else 0.0)
    out = None
    for i, c in terms:
        term = _term_to(ctx, basis[i], c, tgt_l, tgt_s)
        out = term if out is None else ctx.add(out, term)
    if abs(coeffs[0]) > 1e-13:
        out = ctx.add_scalar(out, float(coeffs[0]))
    return out


def _eval_ps(ctx: CkksContext, basis, coeffs: List[float], divmod_fn) -> Ciphertext:
    """Shared Paterson-Stockmeyer recursion with top-down (limbs, scale)
    targets: every addition combines operands at identical (limbs, scale),
    so no alignment levels are burned."""

    def rec(c: List[float], tgt_l: int, tgt_s: float) -> Ciphertext:
        d = len(c) - 1
        while d > 0 and abs(c[d]) < 1e-13:
            c = c[:d]
            d -= 1
        if d <= basis.baby_k:
            return _combo(ctx, basis.B, c, tgt_l, tgt_s)
        m = basis.baby_k
        for g in basis.giants:
            if g <= d:
                m = g
        qc, rc = divmod_fn(c, m)
        tm = basis.B[m]
        assert tgt_l < tm.limbs, "target below giant's level"
        drop = 1.0
        for i in range(tgt_l, tm.limbs - 1):
            drop *= ctx.all_primes[i]
        s_q = tgt_s * drop * ctx.all_primes[tm.limbs - 1] / tm.scale
        qq = rec(qc, tm.limbs, s_q)
        prod = ctx.mul_relin(qq, tm)
        for _ in range(tm.limbs - tgt_l):
            prod = ctx.rescale(prod)
        prod = _retag(prod, tgt_s)  # exact by construction of s_q
        rr = rec(rc, tgt_l, tgt_s)
        return ctx.add(prod, rr)

    top_l = min(b.limbs for b in basis.B.values()) - 1
    return rec(coeffs, top_l, ctx.params.scale)


_PLAN_CACHE: Dict = {}


def plan_baby_k(ctx: CkksContext, limbs: int, scale: float,
                coeffs: Sequence[float], basis_cls, divmod_fn) -> int:
    """Pick the baby-step size k for Paterson-Stockmeyer by dry-running
    the exact recursion on (limbs, scale) metadata for each candidate and
    keeping the shallowest (then smallest-basis) one that satisfies every
    scale/headroom constraint."""
    key = (limbs, round(math.log2(scale) * 1e6), len(coeffs),
           round(float(np.sum(np.asarray(coeffs))) * 1e9), basis_cls.__name__)
    if key in _PLAN_CACHE:
        return _PLAN_CACHE[key]
    deg = len(coeffs) - 1
    dry = _DryCtx(ctx.all_primes, ctx.params.scale)
    best = None
    k = 2
    while k <= max(2, deg):
        try:
            basis = basis_cls(dry, _DryCt(limbs, scale), deg, k=k)
            out = _eval_ps(dry, basis, list(coeffs), divmod_fn)
            cost = (limbs - out.limbs, len(basis.B), k)
            if best is None or cost < best:
                best = cost
        except (AssertionError, ValueError):
            pass
        k *= 2
    if best is None:
        raise ValueError(
            f"no viable Paterson-Stockmeyer split for degree {deg} at "
            f"{limbs} limbs, scale 2^{math.log2(scale):.1f}"
        )
    _PLAN_CACHE[key] = best[2]
    return best[2]


def eval_chebyshev_series(ctx: CkksContext, x: Ciphertext, coeffs: Sequence[float]) -> Ciphertext:
    """Evaluate sum c_i T_i(x) with Paterson-Stockmeyer over the Chebyshev
    basis (OpenFHE EvalChebyshevSeries equivalent)."""
    coeffs = list(np.asarray(coeffs, dtype=np.float64))
    while len(coeffs) > 1 and abs(coeffs[-1]) < 1e-13:
        coeffs.pop()
    deg = len(coeffs) - 1
    k = plan_baby_k(ctx, x.limbs, x.scale, coeffs, _ChebBasis, _cheb_divmod)
    basis = _ChebBasis(ctx, x, deg, k=k)
    return _eval_ps(ctx, basis, coeffs, _cheb_divmod)


def eval_chebyshev_function(ctx: CkksContext, x: Ciphertext, f, degree: int,
                            a: float = -1.0, b: float = 1.0) -> Ciphertext:
    """OpenFHE EvalChebyshevFunction equivalent on [-1, 1]."""
    assert a == -1.0 and b == 1.0, "general domain not needed by reference"
    return eval_chebyshev_series(ctx, x, chebyshev_coefficients(f, degree, a, b))


class _PowerBasis:
    """x, x^2, ..., x^k and power-of-two giants."""

    def __init__(self, ctx: CkksContext, x: Ciphertext, max_deg: int, k: int = 4):
        self.ctx = ctx
        self.B: Dict[int, Ciphertext] = {1: x}
        k = min(k, max(1, max_deg))
        for i in range(2, k + 1):
            self._build(i)
        self.baby_k = k
        self.giants = []
        g = k
        while 2 * g <= max_deg:
            self.B[2 * g] = ctx.rescale(ctx.relinearize(ctx.square(self.B[g])))
            g *= 2
            self.giants.append(g)

    def _build(self, i: int):
        ctx = self.ctx
        if i % 2 == 0:
            h = self.B[i // 2]
            self.B[i] = ctx.rescale(ctx.relinearize(ctx.square(h)))
        else:
            a, b = self.B[i - 1], self.B[1]
            l = min(a.limbs, b.limbs)
            self.B[i] = ctx.rescale(ctx.mul_relin(ctx.drop_to(a, l), ctx.drop_to(b, l)))


def eval_poly_ps(ctx: CkksContext, x: Ciphertext, coeffs: Sequence[float]) -> Ciphertext:
    """Power-basis polynomial via Paterson-Stockmeyer (OpenFHE EvalPoly
    equivalent; used for Cheon's f4, depth 4 at degree 9)."""
    coeffs = list(np.asarray(coeffs, dtype=np.float64))
    while len(coeffs) > 1 and abs(coeffs[-1]) < 1e-13:
        coeffs.pop()
    deg = len(coeffs) - 1
    divmod_fn = lambda c, m: (list(c[m:]), list(c[:m]))
    k = plan_baby_k(ctx, x.limbs, x.scale, coeffs, _PowerBasis, divmod_fn)
    basis = _PowerBasis(ctx, x, deg, k=k)
    return _eval_ps(ctx, basis, coeffs, divmod_fn)


def chebyshev_compare(ctx: CkksContext, x: Ciphertext, delta: float,
                      sign_depth: int = 10) -> Ciphertext:
    """Approximate x -> {2 if x >= delta, 0 otherwise}: Chebyshev step
    approximation composed with Cheon's f4, then +1 so results add."""
    if sign_depth < 7 or sign_depth > 15:
        raise ValueError("chebyshevCompare requires depth in [7, 15]")
    degree = DEPTH_TO_DEGREE[sign_depth]
    y = eval_chebyshev_function(ctx, x, lambda v: 1.0 if v >= delta else -1.0, degree)
    z = eval_poly_ps(ctx, y, F4_COEFS)
    return ctx.add_scalar(z, 1.0)

"""Plain reference of encrypted face matching's answers (approaches 4 and 5).

A query's answer, in plain numbers:

- the score of gallery entry i is the cosine of the query and entry i
  (both L2-normalised, zero rows staying zero);
- its flag is ``f4(T(score)) + 1``, where T is the Chebyshev interpolant of
  the step ``+1 if x >= threshold else -1`` on [-1, 1] at
  ``DEPTH_TO_DEGREE[sign_depth] + 1`` Chebyshev nodes, and f4 is Cheon et
  al.'s degree-9 composite sign polynomial (the artifact's
  chebyshevCompare: about 2 for a match, about 0 otherwise);
- an index answer holds every entry's flag, entry i in slot i % slots of
  answer ciphertext i // slots;
- a membership answer holds the sum of all flags in every slot.

Everything is float64.  Each function takes tensors on any device and
computes there; TF32 plays no part in float64 products.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

# Cheon et al.'s f4 in the power basis (degree 9, odd)
F4_COEFS = (0.0, 315.0 / 128.0, 0.0, -420.0 / 128.0, 0.0,
            378.0 / 128.0, 0.0, -180.0 / 128.0, 0.0, 35.0 / 128.0)

# sign depth -> degree of the Chebyshev interpolant (the artifact's table)
DEPTH_TO_DEGREE = {7: 5, 8: 13, 9: 27, 10: 59, 11: 119, 12: 247,
                   13: 495, 14: 1007, 15: 2031}

ROW_BLOCK = 1 << 16  # gallery rows normalised and scored at a time


def step_coefficients(threshold: float, degree: int) -> torch.Tensor:
    """Chebyshev coefficients c_0..c_degree of the step at ``threshold``,
    interpolated at the degree + 1 Chebyshev nodes of the first kind:
    c_j = 2/m sum_k f(x_k) cos(j theta_k), c_0 halved."""
    m = degree + 1
    theta = (torch.arange(m, dtype=torch.float64) + 0.5) * math.pi / m
    f = torch.where(torch.cos(theta) >= threshold, 1.0, -1.0).to(torch.float64)
    j = torch.arange(m, dtype=torch.float64)[:, None]
    c = (2.0 / m) * (f[None, :] * torch.cos(j * theta[None, :])).sum(dim=1)
    c[0] *= 0.5
    return c


def chebyshev_eval(x: torch.Tensor, coefs: Sequence[float]) -> torch.Tensor:
    """sum_j coefs[j] T_j(x) by Clenshaw's recurrence."""
    c = [float(v) for v in coefs]
    b1 = torch.zeros_like(x)
    b2 = torch.zeros_like(x)
    x2 = 2.0 * x
    for cj in reversed(c[1:]):
        b1, b2 = x2 * b1 - b2 + cj, b1
    return x * b1 - b2 + c[0]


def power_eval(x: torch.Tensor, coefs: Sequence[float]) -> torch.Tensor:
    """sum_j coefs[j] x^j by Horner's rule."""
    out = torch.full_like(x, float(coefs[-1]))
    for cj in reversed(coefs[:-1]):
        out = out * x + float(cj)
    return out


def flags_of(scores: torch.Tensor, threshold: float, sign_depth: int) -> torch.Tensor:
    """The compare circuit's value for each score: f4(T(score)) + 1."""
    coefs = step_coefficients(threshold, DEPTH_TO_DEGREE[sign_depth])
    return power_eval(chebyshev_eval(scores, coefs.tolist()), F4_COEFS) + 1.0


def normalize(x: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit L2 norm in float64; zero rows stay zero."""
    x = x.to(torch.float64)
    m = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return torch.where(m == 0, x, x / torch.where(m == 0, torch.ones_like(m), m))


def scores_of(gallery: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Cosine of every gallery row [n, d] with every query [p, d] -> [n, p],
    float64, the gallery taken ``ROW_BLOCK`` rows at a time."""
    q = normalize(queries.to(gallery.device)).T
    out = torch.empty((gallery.shape[0], q.shape[1]), dtype=torch.float64,
                      device=gallery.device)
    for i in range(0, gallery.shape[0], ROW_BLOCK):
        out[i:i + ROW_BLOCK] = normalize(gallery[i:i + ROW_BLOCK]) @ q
    return out


class Answers:
    """The reference's answers to every query of a pool against one
    gallery: ``index(p)`` the flags of query p, one per gallery entry, and
    ``membership(p)`` their sum."""

    def __init__(self, gallery: torch.Tensor, queries: torch.Tensor, threshold: float,
                 sign_depth: int):
        self.flags = flags_of(scores_of(gallery, queries), threshold, sign_depth)  # [n, p]
        self.totals = self.flags.sum(dim=0)

    def index(self, p: int) -> torch.Tensor:
        return self.flags[:, p]

    def membership(self, p: int) -> float:
        return float(self.totals[p])

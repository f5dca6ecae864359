"""The gallery and the query pool of a run, made from its seed.

The gallery follows the identity structure of the artifact's accuracy
campaign (synthetic FRGC-like embeddings): ``identities`` unit prototypes,
each enrolled as ``per_identity`` noisy copies (per-component noise
``noise / sqrt(dim)``, so a copy's cosine with its prototype is about
``1 / (1 + noise^2)``).  The pool holds ``matches`` fresh noisy copies of
enrolled identities and ``queries - matches`` noisy copies of prototypes
that are not enrolled (strangers), in an order drawn from the seed.  Each
query also gets ``borderline`` planted gallery entries whose cosine with
it is drawn uniformly from ``borderline_band``, written over gallery rows
drawn from the seed, so the compare circuit is exercised around the
threshold.  The gallery keeps exactly its configured size.

Everything is drawn by one ``torch.Generator`` on the device, in a few
large calls: the same seed gives the same inputs on the same kind of
device.  The gallery is float32 (embeddings as a face model emits them),
the queries float64.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class Data:
    gallery: torch.Tensor   # [n, dim] float32, on the host
    queries: torch.Tensor   # [pool, dim] float64, on the host
    is_match: torch.Tensor  # [pool] bool: the query's identity is enrolled


def make(cfg: dict, pool: dict, seed: int, device) -> Data:
    """The data of a configuration's ``data`` section and a traffic mix's
    ``pool`` section, from ``seed``."""
    d = cfg["data"]
    n_ids, per, dim = d["identities"], d["per_identity"], cfg["guarantees"]["vector_dim"]
    n = n_ids * per
    if n != cfg["guarantees"]["gallery_vectors"]:
        raise ValueError(f"{n_ids} identities x {per} copies is not the gallery's "
                         f"{cfg['guarantees']['gallery_vectors']} vectors")
    p, matches, b = pool["queries"], pool["matches"], pool["borderline"]
    lo, hi = pool["borderline_band"]
    sd = d["noise"] / math.sqrt(dim)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 64))

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=device, dtype=dtype)

    protos = randn(n_ids + p - matches, dim, dtype=torch.float64)
    protos /= torch.linalg.vector_norm(protos, dim=1, keepdim=True)
    gallery = randn(n, dim).mul_(sd)
    gallery += protos[:n_ids].float().repeat_interleave(per, dim=0)
    ids = torch.randint(0, n_ids, (matches,), generator=gen, device=device)
    queries = torch.cat([protos[ids], protos[n_ids:]]) + sd * randn(p, dim, dtype=torch.float64)
    order = torch.randperm(p, generator=gen, device=device)
    queries, is_match = queries[order], (order < matches)
    # borderline plants: v = c u + sqrt(1 - c^2) w, w a unit vector orthogonal
    # to the query's direction u, so cosine(v, query) = c
    rows = torch.randperm(n, generator=gen, device=device)[:p * b].reshape(p, b)
    c = lo + (hi - lo) * torch.rand(p, b, 1, generator=gen, device=device, dtype=torch.float64)
    u = (queries / torch.linalg.vector_norm(queries, dim=1, keepdim=True))[:, None, :]
    w = randn(p, b, dim, dtype=torch.float64)
    w -= (w * u).sum(-1, keepdim=True) * u
    w /= torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    gallery[rows.reshape(-1)] = (c * u + torch.sqrt(1.0 - c * c) * w).reshape(-1, dim).float()
    return Data(gallery.cpu(), queries.cpu(), is_match.cpu())

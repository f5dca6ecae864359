"""Offline enrollment of a streamed HyDia gallery into the on-disk c0 cache
(``matching/streaming.py``), so that later streamed setups of either
package load the gallery instead of encrypting it again.

    python3 -m image_matching_tpu_torch.harness.enroll_cache --log2n 20 \\
        [--ring 32768] [--seed 0] [--device cuda]

The arguments, the scheme (``MatchConfig()``, HyDia's depth, 128-bit
security from ring 32768 up), the context's and the dataset's seed and so
the cache key are those of the JAX package's ``tools/enroll_cache.py``;
with seed 0 the key is also that of ``utils/slice_profile.py --streamed``
at the same size.  The host C++ engine enrolls, group by group (an
interrupted run resumes); the context's device holds only its keys, so
``--device cpu`` writes the same bytes.  The cache goes to
``IMTPU_STORE_DIR``, by default ``<repo>/.dbcache``: 2^20 vectors take 64
groups, 60.1 GB at ring 32768.  On CUDA the store this run returns keeps
its groups in page-locked host memory (``resident_budget=0``), as a setup
would.
"""

from __future__ import annotations

import argparse
import sys
import time

from ..ckks.context import CkksContext
from ..ckks.params import SchemeParams, compute_required_depth
from ..matching import streaming
from ..matching.config import MatchConfig
from ..utils.io import gen_dataset


def enroll(log2n: int, ring: int = 32768, seed: int = 0,
           device="cuda") -> streaming.DiagStore:
    """Enroll ``gen_dataset(2^log2n, 512, seed)`` with the native engine into
    the c0 cache (loading it instead when it is complete) and return the
    store."""
    cfg = MatchConfig()
    depth = compute_required_depth(5, cfg.comp_depth, cfg.alpha_depth)
    params = SchemeParams.create(ring_dim=ring, mult_depth=depth,
                                 security="128c" if ring >= 32768 else "none")
    ctx = CkksContext(params, seed=seed, device=device)
    _, db = gen_dataset(1 << log2n, cfg.vector_dim, seed=seed)
    return streaming.enroll_diag_streamed(ctx, cfg, db, engine="native", resident_budget=0,
                                          verbose=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2n", type=int, default=20, help="gallery size 2^log2n")
    ap.add_argument("--ring", type=int, default=32768)
    ap.add_argument("--seed", type=int, default=0, help="context and dataset seed")
    ap.add_argument("--device", default="cuda", help="the context's device (its keys)")
    args = ap.parse_args(argv)
    if streaming._cache_dir() is None:
        ap.error("IMTPU_STORE_DIR is empty: the cache is off, nothing would be written")
    t0 = time.perf_counter()
    store = enroll(args.log2n, args.ring, args.seed, args.device)
    print(f"# enrolled {store.num_groups} groups in {time.perf_counter() - t0:.1f}s "
          f"-> {streaming._cache_dir()}", file=sys.stderr)


if __name__ == "__main__":
    main()

"""Artifact runner: all five approaches on a 2^10 planted-match dataset,
basic correctness checks, latency.csv accumulation (the reference's
run_artifact.sh equivalent; the port's counterpart of tools/run_artifact.py).

Usage: python -m image_matching_tpu_torch.harness.run_artifact
           [--log2n 10] [--ring-dim 32768] [--csv docs/results_torch/latency.csv]
           [--device cuda]

Exits non-zero unless every approach decrypts membership True and finds the
planted vector 0 in its index.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import List, Tuple

from ..utils import io as dio
from .latency import run as latency_run

DEFAULT_CSV = os.path.join("docs", "results_torch", "latency.csv")


def run(log2n: int = 10, ring_dim: int = 32768, vector_dim: int = 512,
        csv_path: str = DEFAULT_CSV, device="cuda") -> Tuple[List[dict], List[int]]:
    """Write the planted-match dataset of 2^log2n vectors to a temporary
    `.dat`, run each approach through the latency CLI's ``run`` and check
    it.  Returns the rows and the approaches that failed."""
    if csv_path and os.path.dirname(csv_path):
        os.makedirs(os.path.dirname(csv_path), exist_ok=True)
    query, db = dio.gen_dataset(1 << log2n, vector_dim, seed=0)
    rows, failures = [], []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dataset.dat")
        dio.write_dataset(path, query, db)
        for approach in (1, 2, 3, 4, 5):
            print(f"\n===== approach {approach} =====")
            row = latency_run(path, approach, csv_path, ring_dim, vector_dim, device=device)
            ok = row["membership_result"] is True and 0 in row["index_result"]
            print(f"correctness: {'PASS' if ok else 'FAIL'}")
            rows.append(row)
            if not ok:
                failures.append(approach)
    return rows, failures


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2n", type=int, default=10)
    ap.add_argument("--ring-dim", type=int, default=32768)
    ap.add_argument("--vector-dim", type=int, default=512)
    ap.add_argument("--csv", default=DEFAULT_CSV)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    args = ap.parse_args()
    _, failures = run(args.log2n, args.ring_dim, args.vector_dim, args.csv, args.device)
    if failures:
        print(f"FAILED approaches: {failures}")
        sys.exit(1)
    print("\nall approaches passed basic correctness checks")


if __name__ == "__main__":
    main()

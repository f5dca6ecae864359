"""FRGC-scale accuracy campaign with near-threshold borderline planting
(the port's counterpart of tools/accuracy_campaign.py): every query gets
`--borderline` planted cross-identity entries with cosine in [0.38, 0.50],
so the hybrid sign approximation is exercised straddling
MATCH_THRESHOLD=0.44 (the encrypted analog of the reference's
signApprox.csv validation).

Appends reference-format rows to accuracy.csv and writes
accuracy_summary.json with the aggregate table, the near-threshold
disagreement census, and the score-parity maximum; "hw" is the card's name
and power limit as nvidia-smi reports them.

  python -m image_matching_tpu_torch.harness.accuracy_campaign --queries 50 --borderline 2
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
from typing import List, Optional

from ..matching.config import MatchConfig
from . import accuracy

OUT_DIR = os.path.join("docs", "results_torch")
PARITY_TOL = 1e-4


def card_name(device) -> str:
    """The card's name and power limit (nvidia-smi), or the device's name
    where it is not a CUDA device."""
    if str(device).startswith("cuda"):
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return str(device)


def summarize(rows: List[dict], *, n_ids: int, per_id: int, queries: int,
              borderline: int, ring: int, approach: int, hw: str,
              ts: Optional[str] = None) -> dict:
    """tools/accuracy_campaign.py's summary of the campaign's rows, the
    same keys."""
    tot = {k: sum(r[f"enc_{k}"] for r in rows) for k in ("tp", "fn", "tn", "fp")}
    ptot = {k: sum(r[f"plain_{k}"] for r in rows) for k in ("tp", "fn", "tn", "fp")}
    agree = sum(1 for r in rows
                if all(r[f"enc_{k}"] == r[f"plain_{k}"]
                       for k in ("tp", "fn", "tn", "fp")))
    summary = {
        "db_vectors": n_ids * per_id + queries * borderline,
        "n_identities": n_ids,
        "queries": queries,
        "borderline_planted_per_query": borderline,
        "borderline_band_cosine": [0.38, 0.50],
        "ring_dim": ring,
        "scale_bits": 30,
        "security": "HEStd_128_classic" if ring >= 32768 else "none",
        "comp_depth": MatchConfig().comp_depth,
        "approach": approach,
        "store": "streamed seed-compressed (c0-only)",
        "enc_equals_plain_queries": agree,
        "totals_encrypted": {"TP": tot["tp"], "FN": tot["fn"],
                             "TN": tot["tn"], "FP": tot["fp"]},
        "totals_plaintext": {"TP": ptot["tp"], "FN": ptot["fn"],
                             "TN": ptot["tn"], "FP": ptot["fp"]},
        "near_threshold": {
            "band": f"plain cosine within +-{accuracy.NEAR_BAND} of 0.44",
            "entries_total": sum(r["near_count"] for r in rows),
            "enc_plain_decision_disagreements":
                sum(r["near_disagree"] for r in rows),
            "min_margin_seen": min((r["near_margin_min"] for r in rows
                                    if r["near_margin_min"] is not None),
                                   default=None),
        },
        "decision_disagreements_total": sum(r["disagree"] for r in rows),
        "max_score_parity_err": max(r["max_score_err"] for r in rows),
        "parity_tolerance": PARITY_TOL,
        "note": ("synthetic identity-labeled embeddings at FRGC 2.0 scale "
                 "stand in for the non-redistributable FRGC files "
                 "(reference src/main_accuracy.cpp:75-97), with planted "
                 "cross-identity borderline pairs straddling the 0.44 "
                 "threshold so the sign approximation is exercised where "
                 "the reference validates it (tools/figures/signApprox.csv). "
                 "Encrypted index pipeline of the PyTorch/CUDA port vs the "
                 f"plaintext cosine oracle at these parameters on {hw}."),
        "hw": hw,
    }
    if ts:
        summary["ts"] = ts
    return summary


def campaign(queries: int = 50, approach: int = 5, n_ids: int = 11057, per_id: int = 4,
             borderline: int = 2, ring: int = 32768, vector_dim: int = 512,
             csv_path: str = os.path.join(OUT_DIR, "accuracy.csv"), device="cuda",
             ts: Optional[str] = None) -> dict:
    """Enroll the streamed gallery once, run the queries with parity and
    return the summary."""
    if csv_path and os.path.dirname(csv_path):
        os.makedirs(os.path.dirname(csv_path), exist_ok=True)
    rows = accuracy.run(0, approach, csv_path=csv_path, ring_dim=ring, vector_dim=vector_dim,
                        n_ids=n_ids, per_id=per_id, n_queries=queries, parity=True,
                        streamed=True, borderline=borderline, device=device)
    return summarize(rows, n_ids=n_ids, per_id=per_id, queries=queries,
                     borderline=borderline, ring=ring, approach=approach,
                     hw=card_name(device), ts=ts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=50)
    ap.add_argument("--approach", type=int, default=5)
    ap.add_argument("--n-ids", type=int, default=11057)
    ap.add_argument("--per-id", type=int, default=4)
    ap.add_argument("--borderline", type=int, default=2)
    ap.add_argument("--ring", type=int, default=32768)
    ap.add_argument("--vector-dim", type=int, default=512)
    ap.add_argument("--csv", default=os.path.join(OUT_DIR, "accuracy.csv"))
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "accuracy_summary.json"))
    ap.add_argument("--ts", default="", help="UTC timestamp for the artifact")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    args = ap.parse_args()
    summary = campaign(args.queries, args.approach, args.n_ids, args.per_id, args.borderline,
                       args.ring, args.vector_dim, args.csv, args.device, args.ts or None)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))
    print(f"-> {args.out}")


if __name__ == "__main__":
    main()

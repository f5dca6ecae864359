"""Accuracy harness: the `ImageMatchingAccuracy` equivalent (reference
src/main_accuracy.cpp), reporting TP/FN/TN/FP of the encrypted pipeline
against identity ground truth, side by side with the plaintext
cosine-similarity oracle, and the 1e-4 score-parity check
(reference src/main_accuracy.cpp:354-364); the port of
image_matching_tpu/harness/accuracy.py.

Usage (single query, like the reference binary):
  python -m image_matching_tpu_torch.harness.accuracy <query_idx> <approach>
      [--csv accuracy.csv] [--ring-dim 32768] [--vector-dim 512]
      [--n-ids 64] [--per-id 4] [--parity] [--device cuda]

Sweep mode (enrolls once, runs queries 0..N-1, the reference's
run-over-50-queries campaign, src/main_accuracy.cpp:75-97):
  python -m image_matching_tpu_torch.harness.accuracy 0 <approach> --all 50 ...

FRGC-format files (reference test/frgc2-*.dat|txt layouts:
db = "N" then N*dim floats; query = n_queries*dim floats;
id files = one integer per vector) are used when passed via
--db-file/--query-file/--dbid-file/--qid-file; otherwise a synthetic
identity-labeled dataset stands in (the real FRGC 2.0 embeddings are not
redistributable).

Runs on the card unless ``--device cpu`` is given; without a GPU the
default raises.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np

from ..ckks.context import CkksContext
from ..matching.config import MatchConfig
from ..matching.protocol import MatchingProtocol
from ..matching import vector_utils as vu
from ..utils import io as dio
from .latency import scheme_params

CSV_HEADER = (
    "Query Subject Index,Query Subject ID,True Positives,False Negatives,"
    "True Negatives,False Positives\n"
)
NEAR_BAND = 0.06  # plain cosines within this of the threshold: the near census


def load_frgc(db_file: str, query_file: str, dbid_file: str, qid_file: str,
              vector_dim: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Read the reference's FRGC-format files (src/main_accuracy.cpp:45-97):
    db = first token N, then N*dim floats; query = n*dim floats (n inferred);
    id files = one integer per vector."""
    db_tokens = np.loadtxt(db_file, dtype=np.float64).ravel()
    n = int(db_tokens[0])
    db = db_tokens[1 : 1 + n * vector_dim].reshape(n, vector_dim)
    queries = np.loadtxt(query_file, dtype=np.float64).ravel().reshape(-1, vector_dim)
    db_ids = np.loadtxt(dbid_file, dtype=np.int64).ravel()[:n]
    q_ids = np.loadtxt(qid_file, dtype=np.int64).ravel()[: queries.shape[0]]
    return db, db_ids, queries, q_ids


def _build_protocol(approach: int, db: np.ndarray, cfg: MatchConfig,
                    ring_dim: int, scale_bits: int, seed: int,
                    streamed: bool = False, device="cuda",
                    ctx_kw: Optional[dict] = None) -> MatchingProtocol:
    ctx = CkksContext(scheme_params(approach, cfg, ring_dim, scale_bits), seed=seed,
                      device=device, **(ctx_kw or {}))
    return MatchingProtocol.setup(approach, db, cfg, ctx=ctx, streamed=streamed)


def _query_counts(proto: MatchingProtocol, query: np.ndarray, qid: int,
                  db: np.ndarray, db_ids: np.ndarray, cfg: MatchConfig,
                  parity: bool) -> dict:
    qcts = proto.encrypt_query(query)
    enc_matches = set(proto.decrypt_index(proto.index(qcts)))

    sims = vu.cosine_similarity(vu.normalize(query)[None, :], vu.normalize(db))
    plain_matches = set(np.nonzero(sims >= cfg.match_threshold)[0].tolist())

    max_err = None
    if parity:
        # the reference's (commented-out) encrypted-vs-plaintext score
        # check at 1e-4 (src/main_accuracy.cpp:354-364), by position: the
        # scores past the gallery are the last group's padding
        scores = proto.sender.compute_similarity(qcts)
        vals = proto.receiver.decrypt_scores(scores)[: db.shape[0]]
        max_err = float(np.abs(vals - sims).max())

    counts = {"enc": [0, 0, 0, 0], "plain": [0, 0, 0, 0]}  # TP FN TN FP
    for i in range(db.shape[0]):
        same = db_ids[i] == qid
        for kind, matches in (("enc", enc_matches), ("plain", plain_matches)):
            hit = i in matches
            if same and hit:
                counts[kind][0] += 1
            elif same and not hit:
                counts[kind][1] += 1
            elif not same and not hit:
                counts[kind][2] += 1
            else:
                counts[kind][3] += 1
    # near-threshold census: entries whose plaintext cosine lies within
    # +-NEAR_BAND of the match threshold are the ones the hybrid sign
    # approximation actually has to get right (the encrypted analog of the
    # reference's signApprox.csv validation); report how many there are
    # and on how many encrypted and plaintext DECISIONS differ
    near = np.abs(sims - cfg.match_threshold) <= NEAR_BAND
    near_idx = set(np.nonzero(near)[0].tolist())
    disagree = enc_matches.symmetric_difference(plain_matches)
    return {"counts": counts, "max_err": max_err,
            "near_count": int(near.sum()),
            "near_disagree": len(disagree & near_idx),
            "disagree": len(disagree),
            "near_margin_min": (float(np.abs(sims[near]
                                             - cfg.match_threshold).min())
                                if near.any() else None)}


def run(query_idx: int, approach: int, csv_path: str = "accuracy.csv",
        ring_dim: int = 32768, vector_dim: int = 512, n_ids: int = 64,
        per_id: int = 4, seed: int = 0, scale_bits: int = 30,
        n_queries: Optional[int] = None, parity: bool = False,
        streamed: bool = False, borderline: int = 0,
        db_file: Optional[str] = None, query_file: Optional[str] = None,
        dbid_file: Optional[str] = None, qid_file: Optional[str] = None,
        device="cuda", ctx_kw: Optional[dict] = None) -> list:
    """Run one query (query_idx) or a sweep (n_queries set): enroll once,
    evaluate each query's encrypted index scenario against identity ground
    truth, append reference-format rows to accuracy.csv.  ``ctx_kw`` goes
    to the CkksContext (its noise hooks, for tests); the default adds
    nothing."""
    cfg = MatchConfig(vector_dim=vector_dim)
    if db_file:
        db, db_ids, queries, q_ids = load_frgc(
            db_file, query_file, dbid_file, qid_file, vector_dim)
    else:
        db, db_ids, queries, q_ids = dio.gen_identity_dataset(
            n_ids, per_id, max(n_queries or 0, query_idx + 1), vector_dim,
            seed=seed, borderline=borderline)

    proto = _build_protocol(approach, db, cfg, ring_dim, scale_bits, seed,
                            streamed=streamed, device=device, ctx_kw=ctx_kw)

    todo = range(n_queries) if n_queries else [query_idx]
    rows = []
    for qi in todo:
        qid = int(q_ids[qi])
        res = _query_counts(proto, queries[qi], qid, db, db_ids, cfg, parity)
        counts = res["counts"]
        row = {
            "query_idx": qi, "query_id": qid,
            "enc_tp": counts["enc"][0], "enc_fn": counts["enc"][1],
            "enc_tn": counts["enc"][2], "enc_fp": counts["enc"][3],
            "plain_tp": counts["plain"][0], "plain_fn": counts["plain"][1],
            "plain_tn": counts["plain"][2], "plain_fp": counts["plain"][3],
            "max_score_err": res["max_err"],
            "near_count": res["near_count"],
            "near_disagree": res["near_disagree"],
            "disagree": res["disagree"],
            "near_margin_min": res["near_margin_min"],
        }
        rows.append(row)
        msg = (f"query {qi} (id {qid}): encrypted TP/FN/TN/FP = "
               f"{counts['enc']}  plaintext = {counts['plain']}")
        if res["near_count"]:
            msg += (f"  near-threshold: {res['near_count']} entries, "
                    f"{res['near_disagree']} enc/plain disagreements")
        if parity:
            ok = "OK" if res["max_err"] <= 1e-4 else "FAIL"
            msg += f"  score parity max|err| = {res['max_err']:.2e} [{ok}]"
        print(msg)
        if csv_path:
            new = not os.path.exists(csv_path)
            with open(csv_path, "a") as f:
                if new:
                    f.write(CSV_HEADER)
                f.write(
                    f"{qi},{qid},{counts['enc'][0]},{counts['enc'][1]},"
                    f"{counts['enc'][2]},{counts['enc'][3]}\n"
                )
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("query_idx", type=int)
    ap.add_argument("approach", type=int, choices=range(1, 6))
    ap.add_argument("--all", type=int, default=None, metavar="N",
                    help="sweep queries 0..N-1 (enrolls once)")
    ap.add_argument("--csv", default="accuracy.csv")
    ap.add_argument("--ring-dim", type=int, default=32768)
    ap.add_argument("--scale-bits", type=int, default=30)
    ap.add_argument("--vector-dim", type=int, default=512)
    ap.add_argument("--n-ids", type=int, default=64)
    ap.add_argument("--per-id", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parity", action="store_true",
                    help="also check encrypted-vs-plaintext scores at 1e-4")
    ap.add_argument("--borderline", type=int, default=0,
                    help="planted cross-identity entries per query with "
                         "cosine in [0.38, 0.50] (straddles the 0.44 "
                         "threshold; exercises the sign approximation)")
    ap.add_argument("--streamed", action="store_true",
                    help="seed-compressed streamed DB store (c0-only; "
                         "fits FRGC-scale DBs next to the compare "
                         "workspace in device memory)")
    ap.add_argument("--db-file", help="FRGC-format database file")
    ap.add_argument("--query-file", help="FRGC-format query file")
    ap.add_argument("--dbid-file", help="database identity labels")
    ap.add_argument("--qid-file", help="query identity labels")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    args = ap.parse_args()
    run(args.query_idx, args.approach, args.csv, args.ring_dim,
        args.vector_dim, args.n_ids, args.per_id, seed=args.seed,
        scale_bits=args.scale_bits, n_queries=args.all, parity=args.parity,
        streamed=args.streamed, borderline=args.borderline,
        db_file=args.db_file, query_file=args.query_file,
        dbid_file=args.dbid_file, qid_file=args.qid_file, device=args.device)


if __name__ == "__main__":
    main()

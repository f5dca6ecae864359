"""Figure generation from latency.csv runs — the reference's
generate_figures.sh + tools/figures/*.py equivalents:

  * membership / identification scalability (log-log server compute vs DB
    size, one line per approach)
  * end-to-end time vs network bandwidth at a fixed DB size (computation +
    analytic transfer time from ciphertext counts x ciphertext bytes /
    bandwidth — the reference models the network the same way,
    tools/figures/15{Membership,Index}Totals.csv)
  * sign-approximation accuracy sweep (chebyshevCompare fixture,
    tools/figures/signApproxAll.py)

The port of image_matching_tpu/harness/figures.py, on the port's own
parameters and sign approximation.  matplotlib is imported only inside the
plotting functions: the module, ciphertext_bytes and sign_approx_table need
none.

Usage: python -m image_matching_tpu_torch.harness.figures latency.csv [outdir]
"""

from __future__ import annotations

import csv
import os
import sys
from collections import defaultdict

import numpy as np

BANDWIDTHS = {  # label -> bytes/sec (reference tools/figures/idBandwidth.py)
    "64 Kbps": 8192,
    "2 Mbps": 262144,
    "1 Gbps": 134217728,
    "20 Gbps": 2684354560,
}


def _load(csv_path):
    rows = []
    with open(csv_path) as f:
        for row in csv.DictReader(f):
            rows.append(row)
    return rows


_APPROACH_IDS = {"Baseline": 1, "GROTE": 2, "Blind": 3, "HERS": 4,
                 "Diagonal": 5}


def ciphertext_bytes(approach_name: str = "Diagonal",
                     ring_dim: int = 32768) -> int:
    """Serialized size of one fresh 2-component ciphertext at the scheme
    parameters this approach actually runs with (limb count from the
    approach's depth plan — reference models bandwidth from serialized
    ciphertext sizes the same way, tools/figures/15IndexTotals.csv)."""
    from ..ckks.params import SchemeParams, compute_required_depth
    from ..matching.config import MatchConfig

    cfg = MatchConfig()
    depth = compute_required_depth(
        _APPROACH_IDS.get(approach_name, 5), cfg.comp_depth, cfg.alpha_depth)
    params = SchemeParams.create(
        ring_dim=ring_dim, mult_depth=depth,
        security="128c" if ring_dim >= 32768 else "none")
    return 2 * len(params.q_primes) * ring_dim * 4


def generate(csv_path: str, outdir: str = "figures"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(outdir, exist_ok=True)
    rows = _load(csv_path)

    # scalability: per-approach membership/index compute vs DB size
    for phase, col in (("membership", "Membership Computation (seconds)"),
                       ("identification", "Index Computation (seconds)")):
        series = defaultdict(list)
        for r in rows:
            series[r["Experimental Approach"]].append(
                (int(r["Database Size (vectors)"]), float(r[col]))
            )
        plt.figure(figsize=(6, 4))
        for name, pts in sorted(series.items()):
            pts.sort()
            plt.loglog([p[0] for p in pts], [p[1] for p in pts],
                       marker="o", label=name)
        plt.xlabel("database size (vectors)")
        plt.ylabel("server computation (s)")
        plt.title(f"{phase} scalability (GPU)")
        plt.grid(True, which="both", alpha=0.3)
        plt.legend()
        plt.tight_layout()
        plt.savefig(os.path.join(outdir, f"{phase}_scalability.png"), dpi=150)
        plt.close()

    # bandwidth: end-to-end = compute + (query + result cts) * bytes / bw
    # (reference generate_figures.sh:7-13 emits both the membership and the
    # identification variant).  The reference fixes ONE DB size for these
    # figures (2^15, tools/figures/15IndexTotals.csv); mixing per-approach
    # sizes in one plot would not be comparable, so use the largest size
    # measured for EVERY approach (fall back to each approach's largest,
    # flagged in the title, only when no common size exists).
    names = sorted({r["Experimental Approach"] for r in rows})
    sizes_by_name = {
        name: {int(r["Database Size (vectors)"]) for r in rows
               if r["Experimental Approach"] == name}
        for name in names
    }
    common = set.intersection(*sizes_by_name.values()) if names else set()
    fixed_size = max(common) if common else None
    for phase, comp_col, size_col in (
        ("membership", "Membership Computation (seconds)",
         "Membership Result Size (ciphertexts)"),
        ("identification", "Index Computation (seconds)",
         "Index Result Size (ciphertexts)"),
    ):
        plt.figure(figsize=(6, 4))
        for name in names:
            pool = [r for r in rows if r["Experimental Approach"] == name]
            if fixed_size is not None:
                pool = [r for r in pool
                        if int(r["Database Size (vectors)"]) == fixed_size]
            biggest = max(
                pool, key=lambda r: int(r["Database Size (vectors)"]))
            comp = float(biggest[comp_col]) + float(
                biggest["Query Encryption (seconds)"]
            )
            n_cts = int(biggest["Query Size (ciphertexts)"]) + int(
                biggest[size_col]
            )
            ct_bytes = ciphertext_bytes(name)
            xs, ys = [], []
            for label, bw in BANDWIDTHS.items():
                xs.append(bw)
                ys.append(comp + n_cts * ct_bytes / bw)
            plt.loglog(xs, ys, marker="s", label=name)
        plt.xlabel("network bandwidth (B/s)")
        plt.ylabel(f"end-to-end {phase} (s)")
        title = (f"{phase} vs bandwidth @ {fixed_size} vectors"
                 if fixed_size is not None else
                 f"{phase} vs bandwidth (per-approach largest size!)")
        plt.title(title)
        plt.grid(True, which="both", alpha=0.3)
        plt.legend()
        plt.tight_layout()
        plt.savefig(os.path.join(outdir, f"{phase}_bandwidth.png"), dpi=150)
        plt.close()
    print(f"figures written to {outdir}/")


def sign_approx_plot(outpath: str = "figures/sign_approx.png",
                     delta: float = 0.44, degree: int = 59):
    """Plot of the composed sign approximation vs pure Chebyshev — the
    reference's tools/figures/signApproxAll.py figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..ckks import poly_eval as pe

    cheb = pe.chebyshev_coefficients(
        lambda v: 1.0 if v >= delta else -1.0, degree
    )
    xs = np.linspace(-1, 1, 801)
    y = np.polynomial.chebyshev.chebval(xs, cheb)
    composed = np.polyval(pe.F4_COEFS[::-1], y) + 1.0
    target = np.where(xs >= delta, 2.0, 0.0)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(9, 4))
    ax1.plot(xs, y, label=f"Chebyshev deg {degree}")
    ax1.plot(xs, composed, label="composed (Cheb ∘ f4) + 1")
    ax1.plot(xs, target, "k--", lw=0.8, label="target step")
    ax1.axvline(delta, color="gray", lw=0.5)
    ax1.set_xlabel("score x")
    ax1.legend(fontsize=8)
    ax2.semilogy(xs, np.abs(composed - target) + 1e-18)
    ax2.set_xlabel("score x")
    ax2.set_ylabel("|composed − target|")
    ax2.grid(True, which="both", alpha=0.3)
    fig.tight_layout()
    os.makedirs(os.path.dirname(outpath) or ".", exist_ok=True)
    fig.savefig(outpath, dpi=150)
    plt.close(fig)


def sign_approx_table(outpath: str = "figures/sign_approx.csv",
                      delta: float = 0.44, degree: int = 59):
    """Numeric fixture for the composed sign approximation (float64 model
    of chebyshevCompare) — reference tools/figures/signApprox.csv."""
    from ..ckks import poly_eval as pe

    cheb = pe.chebyshev_coefficients(
        lambda v: 1.0 if v >= delta else -1.0, degree
    )
    xs = np.linspace(-1, 1, 401)
    y = np.polynomial.chebyshev.chebval(xs, cheb)
    f4 = np.polyval(pe.F4_COEFS[::-1], y)
    composed = f4 + 1.0
    os.makedirs(os.path.dirname(outpath) or ".", exist_ok=True)
    with open(outpath, "w") as f:
        f.write("x,chebyshev,composed,target\n")
        for x, c, comp in zip(xs, y, composed):
            tgt = 2.0 if x >= delta else 0.0
            f.write(f"{x},{c},{comp},{tgt}\n")
    return xs, composed


if __name__ == "__main__":
    path = sys.argv[1] if len(sys.argv) > 1 else "latency.csv"
    out = sys.argv[2] if len(sys.argv) > 2 else "figures"
    generate(path, out)
    sign_approx_table(os.path.join(out, "sign_approx.csv"))
    sign_approx_plot(os.path.join(out, "sign_approx.png"))

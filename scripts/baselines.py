#!/usr/bin/env python
"""CPU baseline tree methods for the experiment harness.

The reference compares DIPPER against 10 external NJ/placement tools on
identical distance matrices (/root/reference/scripts/experiment.sh:24-34).
None of those binaries are installable in this image, so we provide the
two classic distance-methods that ARE runnable here as sanity baselines:

  - nj     vectorized NumPy neighbor-joining (same selection criterion
           as the reference's neighborJoining.cu:117-148; O(N^3) total,
           O(N^2) vectorized per iteration — usable to ~5K taxa)
  - upgma  scipy.cluster.hierarchy average linkage (UPGMA)

Input is either a lower-triangular PHYLIP matrix (--matrix) or a FASTA
whose mash matrix we compute on CPU (--fasta; JAX_PLATFORMS=cpu is
forced so the baseline never touches the GPU). Reports wall-clock and
nRF vs --true for each method as one JSON line per method.

Usage:
  python scripts/baselines.py --matrix in.phy --true true.nwk
  python scripts/baselines.py --fasta in.fa --true true.nwk --methods upgma
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def nj_vectorized(D: np.ndarray):
    """Neighbor-joining minimizing d(i,j) - (U(i)+U(j))/(n-2), first
    minimum in scan order (reference tie semantics,
    neighborJoining.cu:136-147). Returns newick."""
    n = D.shape[0]
    # subtrees carried as newick strings; T{i} placeholders renamed at
    # the end (keeps this file standalone)
    snwk = [f"T{i}" for i in range(n)]
    cur = D.astype(np.float64).copy()
    m = n
    while m > 2:
        U = cur.sum(axis=1)
        Q = cur - (U[:, None] + U[None, :]) / (m - 2)
        np.fill_diagonal(Q, np.inf)
        flat = np.argmin(Q)
        x, y = divmod(flat, m)
        if x > y:
            x, y = y, x
        d = cur[x, y]
        blx = (d + (U[x] - U[y]) / (m - 2)) / 2
        bly = d - blx
        # negative-branch clamp, shifting remainder (reference :231-232)
        if blx < 0:
            bly -= blx
            blx = 0.0
        if bly < 0:
            blx -= bly
            bly = 0.0
        merged = f"({snwk[x]}:{blx:.9g},{snwk[y]}:{bly:.9g})"
        drest = (cur[x] + cur[y] - d) / 2
        keep = np.ones(m, dtype=bool)
        keep[[x, y]] = False
        new_row = drest[keep]
        sub_idx = np.where(keep)[0]
        nxt = np.empty((m - 1, m - 1))
        nxt[:-1, :-1] = cur[np.ix_(sub_idx, sub_idx)]
        nxt[-1, :-1] = new_row
        nxt[:-1, -1] = new_row
        nxt[-1, -1] = 0.0
        snwk = [snwk[i] for i in sub_idx] + [merged]
        cur = nxt
        m -= 1
    d = cur[0, 1]
    return f"({snwk[0]}:{d / 2:.9g},{snwk[1]}:{d / 2:.9g});"


def upgma_scipy(D: np.ndarray):
    from scipy.cluster.hierarchy import average
    from scipy.spatial.distance import squareform

    Z = average(squareform(D, checks=False))
    n = D.shape[0]
    snwk = [f"T{i}" for i in range(n)] + [None] * (n - 1)
    heights = [0.0] * n + [0.0] * (n - 1)
    for i, (a, b, h, _) in enumerate(Z):
        a, b = int(a), int(b)
        ha, hb = h / 2 - heights[a], h / 2 - heights[b]
        snwk[n + i] = f"({snwk[a]}:{ha:.9g},{snwk[b]}:{hb:.9g})"
        heights[n + i] = h / 2
    return snwk[-1] + ";"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--matrix", default=None)
    ap.add_argument("--fasta", default=None)
    ap.add_argument("--true", dest="true_tree", default=None)
    ap.add_argument("--methods", default="nj,upgma")
    ap.add_argument("-k", type=int, default=15)
    ap.add_argument("-s", type=int, default=1000)
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()

    if args.matrix:
        from dipper_tpu.io.phylip import read_phylip_lower_triangular

        names, D = read_phylip_lower_triangular(args.matrix)
    elif args.fasta:
        os.environ["JAX_PLATFORMS"] = "cpu"
        from dipper_tpu.io.fasta import read_fasta
        from dipper_tpu.sketch.minhash import sketch_sequences
        from dipper_tpu.distance.mash import mash_distance_matrix_device

        names, seqs = read_fasta(args.fasta)
        sk = sketch_sequences(seqs, args.k, args.s)
        D = np.asarray(mash_distance_matrix_device(sk, args.k, args.s,
                                                   dtype="float64"))
    else:
        ap.error("one of --matrix/--fasta required")

    for method in args.methods.split(","):
        t0 = time.time()
        if method == "nj":
            nwk = nj_vectorized(D)
        elif method == "upgma":
            nwk = upgma_scipy(D)
        else:
            raise SystemExit(f"unknown method {method}")
        secs = time.time() - t0
        # rename T{i} placeholders to real names (quote-safe)
        import re

        nwk = re.sub(r"T(\d+)(?=[:,)])",
                     lambda mm: "'" + names[int(mm.group(1))].replace(
                         "'", "") + "'", nwk)
        nrf = None
        if args.true_tree:
            from dipper_tpu.utils.treecmp import rf_distance_fast

            nrf = rf_distance_fast(nwk, open(args.true_tree).read())[1]
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            with open(os.path.join(args.out_dir, f"{method}.nwk"), "w") as f:
                f.write(nwk + "\n")
        print(json.dumps({"method": method, "n": len(names),
                          "time_s": round(secs, 2), "nrf_vs_true": nrf}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Accuracy context table: is placement nRF within noise of NJ?

The reference's accuracy pitch is placement ~= NJ quality, established
by cross-tool NJ agreement on identical matrices
(/root/reference/scripts/experiment.sh:24-34, nrf.sh:26-36). This
harness settles the same question for dipper-tpu: one f64 distance
matrix per dataset (mash from unaligned FASTA, or JC from aligned)
feeds every method, so any nRF gap between methods is ENGINE error,
and the gap between the matrix methods and the true tree is FRONTEND
noise (mash/JC distance estimation error at these branch lengths).

Methods per dataset (all on the identical matrix):
  nj-baseline    vectorized NumPy NJ (scripts/baselines.py)
  upgma          scipy average linkage
  dipper-nj      CLI -i d -m 2 (device NJ engine)
  dipper-place   CLI -i d -m 1 (k-closest placement)
  dipper-exact   CLI -i d -m 0 (exact lim-propagation placement)

Appends JSON rows to accuracy_results.jsonl and prints a markdown
table. Runs entirely on CPU (JAX_PLATFORMS=cpu) so it never contends
with chip benchmarks.

Usage:
  python scripts/accuracy_table.py -n 500 2048 5000
  python scripts/accuracy_table.py -n 2048 --aligned   # JC frontend
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

os.environ["JAX_PLATFORMS"] = "cpu"


def build_matrix(prefix: str, aligned: bool, k: int, ss: int,
                 dist_type: int) -> tuple[list, np.ndarray]:
    from dipper_tpu.io.fasta import read_fasta

    names, seqs = read_fasta(prefix + ".fa")
    if aligned:
        from dipper_tpu.distance.msa import msa_distance_matrix_device
        from dipper_tpu.io.encode import batch_codes, encode_4bit_codes

        codes, _ = batch_codes(seqs, encode_4bit_codes, pad_value=4)
        D = np.asarray(msa_distance_matrix_device(
            codes, dist_type, dtype="float64"))
    else:
        from dipper_tpu.distance.mash import mash_distance_matrix_device
        from dipper_tpu.sketch.minhash import sketch_sequences

        sk = sketch_sequences(seqs, k, ss)
        D = np.asarray(mash_distance_matrix_device(
            sk, k, ss, dtype="float64"))
    return names, D


def run_cli_matrix(phy: str, out: str, mode_flags: list[str]) -> float:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    t0 = time.time()
    subprocess.run(
        [sys.executable, "-m", "dipper_tpu.cli", "-i", "d",
         "-I", phy, "-O", out] + mode_flags,
        check=True, env=env, cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return time.time() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, nargs="+", default=[500, 2048, 5000])
    ap.add_argument("-L", type=int, default=10000)
    ap.add_argument("--aligned", action="store_true",
                    help="aligned dataset + JC matrix instead of mash")
    ap.add_argument("-k", type=int, default=15)
    ap.add_argument("-s", type=int, default=1000)
    ap.add_argument("-d", type=int, default=2, help="MSA model (JC=2)")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--blen-scale", type=float, default=None,
                    help="branch scale for make_dataset (aligned default"
                         " 1.0 saturates JC at depth — pass ~0.3)")
    ap.add_argument("--workdir", default="/tmp/dipper_acc")
    ap.add_argument("--methods", default="nj-baseline,upgma,dipper-nj,"
                    "dipper-place,dipper-exact,dipper-dc",
                    help="comma list (dipper-exact is ~100x dipper-place"
                         " on CPU; drop it for large n)")
    args = ap.parse_args()
    sel = set(args.methods.split(","))

    from dipper_tpu.io.phylip import write_phylip_lower_triangular
    from dipper_tpu.utils.treecmp import rf_distance_fast
    from baselines import nj_vectorized, upgma_scipy

    os.makedirs(args.workdir, exist_ok=True)
    kind = "jc" if args.aligned else "mash"
    if args.blen_scale is not None:
        kind += f"_b{args.blen_scale:g}"
    rows = []
    for n in args.n:
        prefix = os.path.join(
            args.workdir, f"acc_{kind}_n{n}_L{args.L}_s{args.seed}")
        if not os.path.exists(prefix + ".fa"):
            cmd = [sys.executable,
                   os.path.join(REPO, "scripts/make_dataset.py"),
                   "-n", str(n), "-L", str(args.L),
                   "--seed", str(args.seed), "-o", prefix]
            if args.aligned:
                cmd.append("--aligned")
            if args.blen_scale is not None:
                cmd += ["--blen-scale", str(args.blen_scale)]
            subprocess.run(cmd, check=True)
        true_nwk = open(prefix + ".true.nwk").read()

        t0 = time.time()
        names, D = build_matrix(prefix, args.aligned, args.k, args.s,
                                args.d)
        print(f"[acc] n={n} {kind} matrix in {time.time()-t0:.1f}s",
              file=sys.stderr)
        phy = prefix + ".phy"
        write_phylip_lower_triangular(names, D, phy)

        import re

        def nrf_of(nwk: str) -> float:
            return rf_distance_fast(nwk, true_nwk)[1]

        res = {}
        if "nj-baseline" in sel:
            t0 = time.time()
            nwk = nj_vectorized(D)
            nwk = re.sub(r"T(\d+)(?=[:,)])",
                         lambda mm: names[int(mm.group(1))], nwk)
            res["nj-baseline"] = (nrf_of(nwk), time.time() - t0)
        if "upgma" in sel:
            t0 = time.time()
            nwk = upgma_scipy(D)
            nwk = re.sub(r"T(\d+)(?=[:,)])",
                         lambda mm: names[int(mm.group(1))], nwk)
            res["upgma"] = (nrf_of(nwk), time.time() - t0)

        for tag, flags in (("dipper-nj", ["-m", "2"]),
                           ("dipper-place", ["-m", "1"]),
                           ("dipper-exact", ["-m", "0"])):
            if tag not in sel:
                continue
            out = os.path.join(
                args.workdir, f"out_{kind}_n{n}_s{args.seed}_{tag}.nwk")
            secs = run_cli_matrix(phy, out, flags)
            res[tag] = (nrf_of(open(out).read()), secs)
            print(f"[acc] n={n} {tag}: nRF={res[tag][0]:.4f} "
                  f"({secs:.0f}s)", file=sys.stderr)

        if "dipper-dc" in sel:
            # D&C on the SAME matrix (the CLI mirrors the reference's
            # matrix+DC rejection, so call the engine directly): forced
            # -m 3 semantics with the auto backbone N // 20
            from dipper_tpu.dc import build_dc_tree_from_matrix
            from dipper_tpu.utils.params import Param

            t0 = time.time()
            pdc = Param(in_format="d", dtype="float64",
                        backbone_size=max(4, n // 20),
                        batch_size=max(4, n // 20))
            nwk = build_dc_tree_from_matrix(D, names, pdc)
            res["dipper-dc"] = (nrf_of(nwk), time.time() - t0)
            print(f"[acc] n={n} dipper-dc (B={pdc.backbone_size}): "
                  f"nRF={res['dipper-dc'][0]:.4f} "
                  f"({res['dipper-dc'][1]:.0f}s)", file=sys.stderr)

        row = {"n": n, "L": args.L, "frontend": kind, "seed": args.seed,
               "nrf": {k2: round(v[0], 4) for k2, v in res.items()},
               "secs": {k2: round(v[1], 1) for k2, v in res.items()},
               "ts": int(time.time())}
        rows.append(row)
        with open(os.path.join(REPO, "accuracy_results.jsonl"), "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row))

    methods = [m for m in ("nj-baseline", "upgma", "dipper-nj",
                           "dipper-place", "dipper-exact", "dipper-dc")
               if m in sel]
    print("\n| n | frontend | " + " | ".join(methods) + " |")
    print("|" + "---|" * (len(methods) + 2))
    for row in rows:
        print(f"| {row['n']} | {row['frontend']} | "
              + " | ".join(f"{row['nrf'][m]:.4f}" for m in methods)
              + " |")


if __name__ == "__main__":
    main()

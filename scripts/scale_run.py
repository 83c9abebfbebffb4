#!/usr/bin/env python
"""Reference-scale benchmark runs with time-to-tree capture.

Mirrors the reference's measurement methodology
(scripts/experiment.sh:98-123 of the reference: `/usr/bin/time` wall-
clock to Newick + VmPeak): generates (or reuses) an AliSim-class
synthetic dataset (scripts/make_dataset.py), runs the dipper-tpu CLI
as a subprocess, and records:

  - wall-clock time-to-tree (the whole process, input to Newick)
  - the CLI's own phase breakdown (sketch / insert / ...)
  - ms/insertion (parsed from the chunk progress lines)
  - peak RSS (MaxRSS from /usr/bin/time; the reference polls VmPeak)
  - nRF vs the generating true tree (O(N) hash comparator)

Results append to scale_results.jsonl in the work directory (default
<repo>/.scale, git-ignored) and print as one JSON object.

Usage:
  python scripts/scale_run.py -n 30000 --mode placement
  python scripts/scale_run.py -n 100000 --mode placement --chunk 8192
  python scripts/scale_run.py -n 100000 --mode dc
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

MODE_FLAGS = {
    "placement": ["-m", "1"],   # k-closest
    "exact": ["-m", "0"],       # exact placement (reference -m 0 quirk)
    "nj": ["-m", "2"],
    "dc": ["-m", "3"],
    "auto": [],
}


def ensure_dataset(n: int, L: int, seed: int, workdir: str) -> str:
    prefix = os.path.join(workdir, f"ds_n{n}_L{L}_s{seed}")
    if not (os.path.exists(prefix + ".fa")
            and os.path.exists(prefix + ".true.nwk")):
        print(f"[scale] generating dataset {prefix}.fa", file=sys.stderr)
        subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts/make_dataset.py"),
             "-n", str(n), "-L", str(L), "--seed", str(seed),
             "-o", prefix],
            check=True)
    return prefix


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, required=True)
    ap.add_argument("-L", type=int, default=10000)
    ap.add_argument("--mode", default="placement", choices=MODE_FLAGS)
    ap.add_argument("-k", type=int, default=15)
    ap.add_argument("-s", type=int, default=1000)
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--precision", default="f32")
    ap.add_argument("--workdir", default=os.path.join(REPO, ".scale"))
    ap.add_argument("--save-state", default=None,
                    help="checkpoint path passed through to the CLI")
    ap.add_argument("--load-state", default=None,
                    help="resume checkpoint passed through to the CLI")
    ap.add_argument("--no-prefix-caps", action="store_true",
                    help="pass --no-prefix-caps to the CLI (one compile"
                         " instead of one per pow2 cap bucket)")
    ap.add_argument("--no-nrf", action="store_true")
    ap.add_argument("--tag", default=None)
    ap.add_argument("--timeout", type=int, default=86400)
    args = ap.parse_args()

    os.makedirs(args.workdir, exist_ok=True)
    prefix = ensure_dataset(args.n, args.L, args.seed, args.workdir)
    out_nwk = os.path.join(
        args.workdir, f"out_{args.mode}_n{args.n}_L{args.L}.nwk")

    cmd = [sys.executable, "-m", "dipper_tpu.cli",
           "-i", "r", "-I", prefix + ".fa", "-O", out_nwk,
           "-k", str(args.k), "-s", str(args.s),
           "--precision", args.precision,
           "--state-chunk", str(args.chunk)] + MODE_FLAGS[args.mode]
    if args.save_state:
        cmd += ["--save-state", args.save_state]
    if args.load_state:
        cmd += ["--load-state", args.load_state]
    if args.no_prefix_caps:
        cmd += ["--no-prefix-caps"]

    t0 = time.time()
    # no /usr/bin/time in this image (the reference's experiment.sh
    # uses it); MaxRSS of the child comes from wait4 rusage instead
    import resource

    # stream the child's stderr live to our stderr AND a log file so
    # long runs are observable while in flight
    log_path = os.path.join(args.workdir,
                            f"run_{args.mode}_n{args.n}.log")
    print("[scale] run:", " ".join(cmd), file=sys.stderr)
    stderr_lines = []
    with open(log_path, "w") as logf:
        proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, text=True,
                                cwd=REPO, bufsize=1)
        for line in proc.stderr:
            stderr_lines.append(line)
            sys.stderr.write(line)
            sys.stderr.flush()
            logf.write(line)
            logf.flush()
        proc.wait(timeout=args.timeout)
    if proc.returncode != 0:
        raise SystemExit(proc.returncode)
    stderr = "".join(stderr_lines)
    maxrss_kb = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    wall_s = time.time() - t0

    phases = dict(re.findall(r"^([A-Za-z][\w /-]*) in: (\d+) ms", stderr,
                             re.M))
    ins_ms = [float(x) for x in
              re.findall(r"\(([\d.]+) ms/insertion", stderr)]
    tree_ms = None
    m = re.search(r"Tree Created in: (\d+) ms", stderr)
    if m:
        tree_ms = int(m.group(1))

    nrf = None
    if not args.no_nrf:
        from dipper_tpu.utils.treecmp import rf_distance_fast

        t1 = time.time()
        nrf = rf_distance_fast(open(out_nwk).read(),
                               open(prefix + ".true.nwk").read())[1]
        print(f"[scale] nRF={nrf:.4f} ({time.time()-t1:.1f}s)",
              file=sys.stderr)

    row = {
        "tag": args.tag or f"{args.mode}_n{args.n}",
        "mode": args.mode, "n": args.n, "L": args.L,
        "k": args.k, "sketch": args.s, "chunk": args.chunk,
        "precision": args.precision,
        "time_to_tree_s": round(wall_s, 1),
        "tree_created_ms": tree_ms,
        "phases_ms": {k2: int(v) for k2, v in phases.items()},
        "ms_per_insertion": (round(sum(ins_ms) / len(ins_ms), 3)
                             if ins_ms else None),
        "max_rss_mb": (maxrss_kb // 1024 if maxrss_kb else None),
        "nrf_vs_true": nrf,
        "ts": int(time.time()),
    }
    with open(os.path.join(args.workdir, "scale_results.jsonl"), "a") as f:
        f.write(json.dumps(row) + "\n")
    print(json.dumps(row, indent=2))


if __name__ == "__main__":
    main()

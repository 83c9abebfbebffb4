#!/usr/bin/env python
"""Run dipper-tpu's main paths once on NVIDIA GPUs and check the results.

    python chip_smoke.py           # one GPU
    python chip_smoke.py --four    # four GPUs: the sharded paths only

One GPU, in one process (CPU reference runs are children with
JAX_PLATFORMS=cpu, which never open the card):

  0. preflight: card, JAX, `make -B -C native` (portable host flags and
     the sm_90a mash kernel), which sketcher the CLI uses;
  1. kernels at real widths: mash intersection counts, 512 queries x
     30,000 bank rows at sketch 1000, bitwise against the XLA merge on
     the card and against the serial walk (tests/oracle.py) on sampled
     pairs; MSA pair counts of 256 x 4,096 rows of L = 10,000 exactly
     against NumPy, distances within 1e-6 relative of NumPy f64;
  2. headline: `-i r -m 1` on 30,000 raw taxa x 10,000 bp, twice (trees
     byte-identical), and at 2,000 taxa against a CPU child;
  3. the other modes: `-i d` NJ on an 8,000-taxon additive matrix (RF 0
     against the generating tree), `-i m -d 2` NJ on 2,000 aligned taxa
     against a CPU child, `-i r -m 3` D&C on 20,000 taxa twice (trees
     byte-identical), `--add` of 5,000 queries onto a 5,000-taxon
     backbone, exact placement of 5,000 aligned taxa.

With --four (and then nothing else): `-i d` NJ at 8,000 taxa, `-i r -m
3` D&C at 20,000 taxa and sharded k-closest placement at 30,000 taxa,
each on four GPUs and on one.

Data is simulated from seeds by scripts/make_dataset.py. Any failed
phase raises, so the script exits non-zero; it prints no result line
when JAX finds no GPU or when run outside the repository. The last line
of stdout is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Sizes (module constants so a CPU rehearsal can shrink them).
SKETCH = 1000
KMER = 15
SEQ_LEN = 10_000
MASH_BANK, MASH_QUERIES, MASH_ORACLE_PAIRS = 30_000, 512, 64
MSA_QUERIES, MSA_BANK = 256, 4096
DATASETS = {  # name: (taxa, kind, seed)
    "raw30k": (30_000, "raw", 11),
    "raw2k": (2_000, "raw", 12),
    "raw20k": (20_000, "raw", 13),
    "raw10k": (10_000, "raw", 14),
    "aln2k": (2_000, "aligned", 15),
    "aln5k": (5_000, "aligned", 16),
    "mat8k": (8_000, "matrix", 17),
}
FOUR_DATASETS = ("mat8k", "raw20k", "raw30k")


def log(msg: str):
    print(msg, flush=True)


class Datasets:
    """Background make_dataset.py children (numpy only, no JAX)."""

    def __init__(self, workdir: str, names):
        self.workdir = workdir
        self.procs = {}
        for name in names:
            n, kind, seed = DATASETS[name]
            cmd = [sys.executable, os.path.join(REPO, "scripts",
                                                "make_dataset.py"),
                   "-n", str(n), "-L", str(SEQ_LEN), "--seed", str(seed),
                   "-o", self.prefix(name)]
            cmd += {"raw": [], "aligned": ["--aligned", "--blen-scale", "0.1"],
                    "matrix": ["--matrix"]}[kind]
            logf = open(self.prefix(name) + ".log", "w")
            self.procs[name] = (subprocess.Popen(
                cmd, stdout=logf, stderr=subprocess.STDOUT), logf)

    def prefix(self, name: str) -> str:
        return os.path.join(self.workdir, name)

    def get(self, name: str) -> str:
        proc, logf = self.procs[name]
        if proc.wait() != 0:
            raise RuntimeError(f"make_dataset {name} failed: see "
                               f"{self.prefix(name)}.log")
        logf.close()
        return self.prefix(name)

    def stop(self):
        for proc, logf in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            logf.close()


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def run_cli(argv) -> tuple[float, str]:
    """dipper_tpu.cli.main in this process; returns (seconds, its
    stderr log). A non-zero exit raises."""
    from dipper_tpu.cli import main as cli_main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(_Tee(sys.stderr, buf)):
        rc = cli_main(list(argv))
    dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli {' '.join(argv)} exited {rc}")
    return dt, buf.getvalue()


class CpuRefs:
    """CLI commands run in CPU-only children (JAX_PLATFORMS=cpu: they
    never open the card), started early because the CPU is slow."""

    def __init__(self, work: str):
        self.work = work
        self.procs = {}

    def start(self, name: str, argv):
        out = os.path.join(self.work, f"{name}_cpu.nwk")
        logf = open(os.path.join(self.work, f"{name}_cpu.log"), "w")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        proc = subprocess.Popen(
            [sys.executable, "-m", "dipper_tpu.cli", *argv, "-O", out],
            cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=logf)
        self.procs[name] = (proc, logf, out)

    def get(self, name: str) -> str:
        """Wait for the child; returns its Newick path."""
        proc, logf, out = self.procs[name]
        if proc.wait() != 0:
            raise RuntimeError(f"CPU reference {name} failed: see "
                               f"{logf.name}")
        logf.close()
        return out

    def stop(self):
        for proc, logf, _ in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            logf.close()


def phase_lines(text: str) -> str:
    keep = [ln for ln in text.splitlines()
            if re.search(r" in: \d+ ms|ms/insertion|Using ", ln)]
    return "\n".join("    " + ln for ln in keep)


def read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def nrf(tree_path: str, true_path: str) -> tuple[int, float]:
    from dipper_tpu.utils.treecmp import rf_distance_fast

    return rf_distance_fast(read(tree_path).decode(),
                            read(true_path).decode())


def compare_trees(label: str, a: str, b: str) -> int:
    """0 if two Newick files are byte-identical; else print and return
    their RF distance (and the largest branch-length difference)."""
    if read(a) == read(b):
        log(f"  {label}: byte-identical")
        return 0
    from dipper_tpu.utils.treecmp import rf_distance_fast

    rf, n = rf_distance_fast(read(a).decode(), read(b).decode())
    la = np.array(re.findall(rb":([-0-9.e+]+)", read(a)), float)
    lb = np.array(re.findall(rb":([-0-9.e+]+)", read(b)), float)
    dl = (float(np.max(np.abs(np.sort(la) - np.sort(lb))))
          if la.shape == lb.shape else float("nan"))
    log(f"  {label}: DIFFER: RF={rf} nRF={n:.6f}, largest sorted "
        f"branch-length difference {dl:.3g}")
    return rf


def peak_bytes() -> list:
    import jax

    return [(d.memory_stats() or {}).get("peak_bytes_in_use")
            for d in jax.devices()]


def timed(fn, *args, reps: int = 3) -> tuple[float, object]:
    """Warm-up call, then the best of `reps` calls, each ended with
    block_until_ready."""
    import jax

    out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase0_preflight(card: str):
    import jax

    log(f"[0] card: {card}")
    log(f"[0] jax {jax.__version__}, devices {jax.devices()}")
    t0 = time.perf_counter()
    r = subprocess.run(["make", "-B", "-C", os.path.join(REPO, "native"),
                        f"PYTHON={sys.executable}", "all", "gpu"],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"native build failed:\n{r.stdout}\n{r.stderr}")
    from dipper_tpu.distance.mash_gpu import register_kernel
    from dipper_tpu.sketch import native

    register_kernel()
    log(f"[0] native/ rebuilt in {time.perf_counter() - t0:.1f} s; "
        f"sketcher: {'native host' if native.available() else 'device'}")


def phase1_kernels(ds: Datasets):
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import oracle
    from dipper_tpu.distance.mash import (
        mash_pairwise_inter, pad_ranks, rank_compress_host)
    from dipper_tpu.distance.msa import (
        build_channels, msa_tiled_block, one_hot_channels, pair_counts)
    from dipper_tpu.io.fasta import read_fasta
    from dipper_tpu.sketch.native import sketch_sequences_native

    # --- mash: CUDA kernel vs XLA merge vs the serial walk
    _, seqs = read_fasta(ds.get("raw30k") + ".fa")
    ranks = pad_ranks(rank_compress_host(
        sketch_sequences_native(seqs[:MASH_BANK], KMER, SKETCH)))
    del seqs
    step = max(1, MASH_BANK // MASH_QUERIES)
    q_host = ranks[step // 2::step][:MASH_QUERIES]
    bank, q = jax.device_put(ranks), jax.device_put(q_host)
    kern = jax.jit(lambda b, x: mash_pairwise_inter(
        b, x, sketch_size=SKETCH))
    xla = jax.jit(lambda b, x: mash_pairwise_inter(
        b, x, sketch_size=SKETCH, impl="map"))
    t_k, got = timed(kern, bank, q)
    t_x, want = timed(xla, bank, q)
    got, want = np.asarray(got), np.asarray(want)
    pairs = got.size
    assert got.shape == (len(q_host), len(ranks)) and got.dtype == np.int32
    if not np.array_equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"mash kernel != XLA merge on {bad} pairs")
    rng = np.random.default_rng(0)
    for _ in range(MASH_ORACLE_PAIRS):
        i, j = int(rng.integers(len(q_host))), int(rng.integers(len(ranks)))
        w = oracle.mash_inter(ranks[j, :SKETCH], q_host[i, :SKETCH], SKETCH)
        if got[i, j] != w:
            raise AssertionError(f"mash kernel != serial walk at ({i},{j})")
    log(f"[1] mash {got.shape[0]} x {got.shape[1]} at sketch {SKETCH}: "
        f"counts equal the XLA merge bitwise and the serial walk on "
        f"{MASH_ORACLE_PAIRS} sampled pairs (mean inter "
        f"{got.mean():.2f})")
    log(f"[1] mash kernel {t_k * 1e3:.3f} ms ({pairs / t_k:.4g} pairs/s); "
        f"XLA merge (impl='map') {t_x * 1e3:.3f} ms "
        f"({pairs / t_x:.4g} pairs/s); ratio {t_x / t_k:.2f}x")
    del bank, q

    # --- MSA: int8 pair counts and distances vs NumPy
    rng = np.random.default_rng(1)
    root = rng.integers(0, 4, SEQ_LEN)
    rows = []
    for rate in rng.uniform(0.05, 0.25, MSA_QUERIES + MSA_BANK):
        s = root.copy()
        m = rng.random(SEQ_LEN) < rate
        s[m] = rng.integers(0, 4, int(m.sum()))
        s[rng.random(SEQ_LEN) < 0.05] = 4
        rows.append(s)
    codes = np.stack(rows).astype(np.uint8)
    cq, cb = codes[:MSA_QUERIES], codes[MSA_QUERIES:]
    counts = np.asarray(jax.jit(lambda a, b: pair_counts(
        one_hot_channels(a), one_hot_channels(b)))(cq, cb))
    # NumPy reference: 0/1 products summed in f64 BLAS are exact
    # integers far below 2^53, so the int64 cast is exact
    A = build_channels(cq).reshape(-1, SEQ_LEN).astype(np.float64)
    B = build_channels(cb).reshape(-1, SEQ_LEN).astype(np.float64)
    ref = (A @ B.T).astype(np.int64).reshape(
        MSA_QUERIES, 5, MSA_BANK, 5).transpose(0, 2, 1, 3)
    if not np.array_equal(counts.astype(np.int64), ref):
        raise AssertionError("MSA pair counts differ from NumPy")
    ngq, ngb = (cq < 4).sum(1), (cb < 4).sum(1)
    match = sum(ref[:, :, a, a] for a in range(4)).astype(np.float64)
    useful = ngq[:, None] + ngb[None, :] - ref[:, :, 4, 4]
    uncor = 1.0 - match / useful
    worst = {}
    for dt, want64 in ((1, uncor), (2, -0.75 * np.log(1.0 - uncor / 0.75))):
        d32 = np.asarray(jax.jit(lambda a, na, b, nb, dt=dt: msa_tiled_block(
            a, na, b, nb, distance_type=dt, dtype_name="float32"))(
                cq, jnp.asarray(ngq, jnp.float32), cb,
                jnp.asarray(ngb, jnp.float32)))
        assert d32.shape == (MSA_QUERIES, MSA_BANK)
        assert np.isfinite(d32).all()
        worst[dt] = float(np.max(np.abs(d32 - want64) / np.abs(want64)))
        if worst[dt] > 1e-6:
            raise AssertionError(
                f"MSA distance type {dt}: relative error {worst[dt]:.3g}")
    log(f"[1] msa {MSA_QUERIES} x {MSA_BANK} x L={SEQ_LEN}: int8 pair "
        f"counts equal NumPy int64; f32 distances within "
        f"{max(worst.values()):.3g} relative of NumPy f64 (types 1, 2)")


def phase2_headline(ds: Datasets, refs: CpuRefs, work: str):
    raw30k = ds.get("raw30k")
    outs = []
    for run in (1, 2):
        out = os.path.join(work, f"r30k_{run}.nwk")
        dt, text = run_cli(["-i", "r", "-m", "1", "-I", raw30k + ".fa",
                            "-O", out])
        outs.append(out)
        rf, n = nrf(out, raw30k + ".true.nwk")
        log(f"[2] -i r -m 1, {DATASETS['raw30k'][0]} taxa, run {run}: "
            f"time-to-tree {dt:.2f} s, nRF vs true {n:.4f}\n"
            + phase_lines(text))
    log(f"[2] peak_bytes_in_use so far: {peak_bytes()}")
    compare_trees("30k run 1 vs run 2", *outs)
    if read(outs[0]) != read(outs[1]):
        raise AssertionError("k-closest trees differ between two runs")
    gpu_out = os.path.join(work, "r2k_gpu.nwk")
    dt, _ = run_cli(["-i", "r", "-m", "1", "-I", ds.get("raw2k") + ".fa",
                     "-O", gpu_out])
    log(f"[2] -i r -m 1, {DATASETS['raw2k'][0]} taxa: GPU {dt:.2f} s")
    compare_trees("2k GPU vs CPU child", gpu_out, refs.get("r2k"))


def phase3_modes(ds: Datasets, refs: CpuRefs, work: str):
    mat = ds.get("mat8k")
    out = os.path.join(work, "nj8k.nwk")
    dt, text = run_cli(["-i", "d", "-I", mat + ".phy", "-O", out])
    rf, n = nrf(out, mat + ".true.nwk")
    log(f"[3] -i d NJ, {DATASETS['mat8k'][0]} taxa: {dt:.2f} s, RF vs "
        f"generating tree {rf}\n" + phase_lines(text))
    if rf != 0:
        raise AssertionError(f"NJ on an additive matrix: RF {rf} != 0")

    aln2k = ds.get("aln2k")
    gpu_out = os.path.join(work, "m2k_gpu.nwk")
    dt, _ = run_cli(["-i", "m", "-d", "2", "-I", aln2k + ".fa",
                     "-O", gpu_out])
    rf, n = nrf(gpu_out, aln2k + ".true.nwk")
    log(f"[3] -i m -d 2 NJ, {DATASETS['aln2k'][0]} taxa: {dt:.2f} s, "
        f"nRF vs true {n:.4f}")
    compare_trees("aligned 2k GPU vs CPU child", gpu_out, refs.get("m2k"))

    raw20k = ds.get("raw20k")
    outs = []
    for run in (1, 2):
        out = os.path.join(work, f"dc20k_{run}.nwk")
        dt, text = run_cli(["-i", "r", "-m", "3", "-I", raw20k + ".fa",
                            "-O", out])
        outs.append(out)
        rf, n = nrf(out, raw20k + ".true.nwk")
        log(f"[3] -i r -m 3 D&C, {DATASETS['raw20k'][0]} taxa, run {run}:"
            f" {dt:.2f} s, nRF vs true {n:.4f}\n" + phase_lines(text))
    compare_trees("D&C run 1 vs run 2", *outs)
    if read(outs[0]) != read(outs[1]):
        raise AssertionError("D&C trees differ between two runs")

    raw10k = ds.get("raw10k")
    n_all = DATASETS["raw10k"][0]
    lines = read(raw10k + ".fa").splitlines(keepends=True)
    bb_fa = os.path.join(work, "backbone.fa")
    with open(bb_fa, "wb") as f:
        f.writelines(lines[:n_all])  # first half of the 2-line records
    bb = os.path.join(work, "backbone.nwk")
    run_cli(["-i", "r", "-m", "1", "-I", bb_fa, "-O", bb])
    out = os.path.join(work, "add.nwk")
    dt, text = run_cli(["-i", "r", "--add", "-t", bb, "-I", raw10k + ".fa",
                        "-O", out])
    leaves = read(out).count(b",") + 1
    rf, n = nrf(out, raw10k + ".true.nwk")
    log(f"[3] --add {n_all - n_all // 2} queries onto a {n_all // 2}-taxon"
        f" backbone: {dt:.2f} s, {leaves} leaves, nRF vs true {n:.4f}")
    if leaves != n_all:
        raise AssertionError(f"--add tree has {leaves} leaves != {n_all}")

    from dipper_tpu.io.fasta import read_fasta
    from dipper_tpu.placement import build_placement_tree_from_seqs
    from dipper_tpu.utils.params import Param

    aln5k = ds.get("aln5k")
    names, seqs = read_fasta(aln5k + ".fa")
    t0 = time.perf_counter()
    nwk = build_placement_tree_from_seqs(
        seqs, names, Param(in_format="m", distance_type=2), exact=True,
        log=lambda m: None)
    dt = time.perf_counter() - t0
    out = os.path.join(work, "exact5k.nwk")
    with open(out, "w") as f:
        f.write(nwk + "\n")
    rf, n = nrf(out, aln5k + ".true.nwk")
    log(f"[3] exact placement, {len(names)} aligned taxa: {dt:.2f} s, "
        f"nRF vs true {n:.4f}")
    if nwk.count(",") + 1 != len(names):
        raise AssertionError("exact placement tree misses taxa")


def phase4_four(ds: Datasets, work: str):
    import jax

    nd = len(jax.devices())
    if nd < 4:
        raise RuntimeError(f"--four needs 4 GPUs, JAX finds {nd}")
    failures = []
    for label, argv, data in (
            ("-i d NJ", ["-i", "d"], ds.get("mat8k") + ".phy"),
            ("-i r -m 3 D&C", ["-i", "r", "-m", "3"],
             ds.get("raw20k") + ".fa")):
        outs = {}
        for ndev in (4, 1):
            out = os.path.join(work, f"four_{argv[1]}_{ndev}.nwk")
            dt, text = run_cli(argv + ["-I", data, "-O", out,
                                       "--devices", str(ndev)])
            outs[ndev] = out
            log(f"[4] {label} on {ndev} GPU(s): {dt:.2f} s\n"
                + phase_lines(text))
        if compare_trees(f"{label} 4 vs 1 GPUs", outs[4], outs[1]):
            failures.append(label)
        log(f"[4] peak_bytes_in_use per device: {peak_bytes()}")
    if four_placement(ds, work):
        failures.append("sharded placement")
    if failures:  # topology; branch lengths may differ in the last bits
        raise AssertionError(f"4-GPU topology differs from 1-GPU: {failures}")


def four_placement(ds: Datasets, work: str) -> int:
    """Sharded k-closest placement on four GPUs against run_placement on
    one; returns the RF distance of the two trees (0 if identical)."""
    import jax

    from dipper_tpu.distance.mash import pad_ranks, rank_compress_host
    from dipper_tpu.io.fasta import read_fasta
    from dipper_tpu.parallel.sharded import make_mesh, sharded_placement_build
    from dipper_tpu.placement import kclosest
    from dipper_tpu.sketch.native import sketch_sequences_native

    raw30k = ds.get("raw30k")
    names, seqs = read_fasta(raw30k + ".fa")
    sk = sketch_sequences_native(seqs, KMER, SKETCH)
    del seqs
    n = len(names)
    mesh = make_mesh(4)
    t0 = time.perf_counter()
    e4, b4, l4 = sharded_placement_build(sk, KMER, SKETCH, mesh)
    dt4 = time.perf_counter() - t0
    log(f"[4] sharded k-closest placement, {n} taxa on 4 GPUs: "
        f"{dt4:.2f} s; peak_bytes_in_use per device {peak_bytes()}")
    ranks = jax.device_put(pad_ranks(rank_compress_host(sk)))
    t0 = time.perf_counter()
    e1, b1, l1 = jax.device_get(kclosest.run_placement(
        (ranks,), num_sequences=n, frontend="mash",
        frontend_static=(KMER, SKETCH), dtype_name="float32"))
    log(f"[4] run_placement, {n} taxa on 1 GPU: "
        f"{time.perf_counter() - t0:.2f} s")
    out4 = os.path.join(work, "four_place_4.nwk")
    out1 = os.path.join(work, "four_place_1.nwk")
    for path, (e, b, ln) in ((out4, (e4, b4, l4)), (out1, (e1, b1, l1))):
        with open(path, "w") as f:
            f.write(kclosest.edges_to_newick(e, b, ln, names, n) + "\n")
    return compare_trees("sharded placement 4 GPUs vs run_placement",
                         out4, out1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded paths")
    ap.add_argument("--workdir", default=os.path.join(REPO, ".smoke"),
                    help="datasets and trees (default <repo>/.smoke)")
    args = ap.parse_args()
    if not os.path.isfile(os.path.join(REPO, "dipper_tpu", "cli.py")):
        print("chip_smoke.py must run from a dipper-tpu checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from dipper_tpu.utils.gpu_info import nvidia_smi_name_power, require_gpu

    dev = require_gpu()
    card = nvidia_smi_name_power()
    import jax

    from dipper_tpu.utils.compile_cache import enable_compile_cache

    log(f"[0] compile cache: {enable_compile_cache()}")
    os.makedirs(args.workdir, exist_ok=True)
    names = FOUR_DATASETS if args.four else tuple(DATASETS)
    ds = Datasets(args.workdir, names)
    refs = CpuRefs(args.workdir)
    work = args.workdir
    t_all = time.perf_counter()
    try:
        phase0_preflight(card)
        log(f"[phase preflight] done in {time.perf_counter() - t_all:.1f} s")
        if args.four:
            phases = [("four", lambda: phase4_four(ds, work))]
        else:
            # the CPU references take longest: start them first
            refs.start("r2k", ["-i", "r", "-m", "1",
                               "-I", ds.get("raw2k") + ".fa"])
            refs.start("m2k", ["-i", "m", "-d", "2",
                               "-I", ds.get("aln2k") + ".fa"])
            phases = [("kernels", lambda: phase1_kernels(ds)),
                      ("headline", lambda: phase2_headline(ds, refs, work)),
                      ("modes", lambda: phase3_modes(ds, refs, work))]
        for name, fn in phases:
            t0 = time.perf_counter()
            fn()
            log(f"[phase {name}] done in {time.perf_counter() - t0:.1f} s")
    finally:
        refs.stop()
        ds.stop()
    log(f"[all] {time.perf_counter() - t_all:.1f} s")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

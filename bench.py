"""Benchmark harness for one GPU. Prints ONE JSON line with the device
(platform, kind, count) and the card's name and power limit, and exits
without a result when JAX finds no GPU.

Two measurements:
  - pairwise mash distances / s — the inner loop that dominates every
    raw-read workload (SURVEY.md §3.5);
  - time-to-tree: sketch -> k-closest placement -> Newick on a
    simulated dataset (the reference's own methodology is wall-clock to
    Newick, scripts/experiment.sh:98).

Env knobs: DIPPER_BENCH_N (taxa, default 2048), DIPPER_BENCH_L
(sequence length, default 10000), DIPPER_BENCH_MODE=all|dist|tree
(default all), DIPPER_BENCH_TREE_N (taxa for the tree build, default
DIPPER_BENCH_N).
"""

import json
import os
import sys
import time

import numpy as np


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def gen_tree_data(n, L, seed=1):
    """Tree-evolved sequences (AliSim-class shape) so placement sees
    realistic distance structure instead of saturated random pairs."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "scripts"))
    from make_dataset import random_tree, evolve

    rng = np.random.default_rng(seed)
    children, blen, root = random_tree(n, rng, 0.2)
    leaves = evolve(children, blen, root, n, L, rng)
    ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
    out = []
    for i in range(n):
        arr = ACGT[leaves[i]]
        keep = rng.random(L) >= 0.02
        out.append(arr[keep].tobytes())
        del leaves[i]
    return out


def bench_dist(n, L, k, ss):
    import functools

    import jax
    import jax.numpy as jnp

    from dipper_tpu.sketch.minhash import sketch_sequences
    from dipper_tpu.distance.mash import (
        rank_compress, pad_ranks, mash_pairwise,
    )

    rng = np.random.default_rng(0)
    t0 = time.time()
    seqs = [bytes(rng.choice(list(b"ACGT"), L).astype(np.uint8))
            for i in range(n)]
    _log(f"[bench] generated {n} x {L} in {time.time()-t0:.1f}s")

    # production ingest path FIRST: the native host sketcher (what the
    # CLI mash frontend actually uses — sketch/bank.py). The device
    # sketch pipeline is measured below on a small capped subset as a
    # diagnostic.
    native_rate = None
    from dipper_tpu.sketch.native import sketch_sequences_native

    t0 = time.time()
    sk = sketch_sequences_native(seqs, k, ss)
    if sk is not None:
        dtn = time.time() - t0
        native_rate = n * (L - k + 1) / dtn / 1e6
        _log(f"[bench] native-sketched in {dtn:.1f}s "
             f"({native_rate:.1f} M kmers/s) [production ingest path]")

    nd = min(n, 128)
    t0 = time.time()
    skd = sketch_sequences(seqs[:nd], k, ss, as_device=True)
    _ = np.asarray(skd[0, :1])  # force execution
    dt = time.time() - t0
    kmer_rate = nd * (L - k + 1) / dt / 1e6
    _log(f"[bench] device-sketched {nd} seqs in {dt:.1f}s "
         f"({kmer_rate:.1f} M kmers/s) [diagnostic; CLI uses native]")
    if sk is None:
        _log("[bench] native sketcher unavailable; device-sketching all")
        sk = sketch_sequences(seqs, k, ss, as_device=True)

    ranks = pad_ranks(rank_compress(jnp.asarray(sk)))
    ranks.block_until_ready()

    # full pairwise block computation, chunked (the NJ-frontend shape)
    chunk = min(512, n)
    pw = jax.jit(functools.partial(
        mash_pairwise, k=k, sketch_size=ss, dtype_name="float32"))
    pw(ranks, ranks[:chunk]).block_until_ready()  # warmup (compile)
    t0 = time.time()
    for s in range(0, n, chunk):
        blk = pw(ranks, ranks[s:s + chunk])
    np.asarray(blk[:1, :1])  # force the tail of the pipeline
    dt = time.time() - t0
    pairs = n * n
    rate = pairs / dt
    _log(f"[bench] {pairs//2} pairwise distances in {dt:.2f}s")
    return rate, kmer_rate, native_rate


def bench_tree(n, L, k, ss):
    """Wall-clock mash -> k-closest placement -> Newick (data
    generation excluded; compile time included, like a cold CLI run
    with a warm persistent cache)."""
    import jax

    from dipper_tpu.placement import api
    from dipper_tpu.utils.params import Param

    t0 = time.time()
    seqs = gen_tree_data(n, L)
    names = [f"S{i}" for i in range(n)]
    _log(f"[bench] tree-data {n} x ~{L} in {time.time()-t0:.1f}s")

    params = Param(kmer_size=k, sketch_size=ss, dtype="float32",
                   state_chunk=8192)
    t0 = time.time()
    nwk = api.build_placement_tree_from_seqs(seqs, names, params,
                                             exact=False, log=_log)
    dt = time.time() - t0
    assert nwk.count(",") == n - 1, "malformed tree"
    _log(f"[bench] time-to-tree n={n}: {dt:.2f}s")
    return dt


def main():
    n = int(os.environ.get("DIPPER_BENCH_N", 2048))
    L = int(os.environ.get("DIPPER_BENCH_L", 10000))
    mode = os.environ.get("DIPPER_BENCH_MODE", "all")
    tree_n = int(os.environ.get("DIPPER_BENCH_TREE_N", n))
    k = 15
    ss = 1000

    import jax

    from dipper_tpu.utils.compile_cache import enable_compile_cache
    from dipper_tpu.utils.gpu_info import nvidia_smi_name_power, require_gpu

    dev = require_gpu()
    enable_compile_cache()
    card = nvidia_smi_name_power()
    _log(f"[bench] devices: {jax.devices()} ({card})")

    rate = kmer_rate = tree_s = native_rate = None
    if mode in ("all", "dist"):
        rate, kmer_rate, native_rate = bench_dist(n, L, k, ss)
    if mode in ("all", "tree"):
        tree_s = bench_tree(tree_n, L, k, ss)

    out = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())},
           "card": card}
    if rate is not None:
        out.update({
            "pairwise_mash_distances_per_s": rate,
            # production ingest (native host sketcher — the CLI path);
            # device_sketch_* is the device pipeline on a capped subset
            "sketch_mkmers_per_s": (native_rate if native_rate is not None
                                    else kmer_rate),
            "device_sketch_mkmers_per_s": kmer_rate,
        })
    if tree_s is not None:
        out["time_to_tree_s"] = tree_s
        out["time_to_tree_n"] = tree_n
    print(json.dumps(out))


if __name__ == "__main__":
    main()

"""Microbenchmark of the k-closest insertion loop's components.

Run on the real chip:
    python scripts/placement_micro.py [N] [ITERS]

Times a fori_loop of ITERS insertion steps over a prebuilt mid-size
tree state with the distance row precomputed, in four variants:
  row-only    — distance row slice only (block prefetch already timed
                by kernel_micro; this isolates loop baseline)
  score       — + score_edges over 4N slots
  score+splice— + splice scatter updates
  full        — + update_closest_bfs (the frontier while_loop)

Each variant performs the real state mutation so XLA cannot dead-code
it; outputs are materialized. The deltas between rows attribute the
per-insertion cost.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from dipper_tpu.placement import kclosest as KC


def build_state(n, warm, dtype="float32"):
    """Place `warm` taxa of an n-slot tree from a synthetic matrix."""
    rng = np.random.default_rng(0)
    pts = rng.random((n, 8)).astype(np.float32)

    # build the [n, n] matrix ON DEVICE from the tiny [n, 8] upload:
    # the broadcasted [n, n, 8] host difference would be tens of TB
    @jax.jit
    def _dist(p):
        sq = (p * p).sum(-1)
        D = sq[:, None] + sq[None, :] - 2.0 * (p @ p.T)
        D = jnp.sqrt(jnp.maximum(D, 0.0))
        D = D * (1.0 - jnp.eye(p.shape[0], dtype=p.dtype))
        return (D / D.max()).astype(jnp.dtype(dtype))

    D = jax.block_until_ready(_dist(jnp.asarray(pts)))
    st = KC.init_placement_state(
        (D,), num_sequences=n, frontend="matrix", dtype_name=dtype)
    # bounded dispatches: one 15K-insertion dispatch runs minutes and
    # trips the device watchdog (UNAVAILABLE fault)
    for lo in range(2, warm, 4096):
        st = KC.run_insert_range(
            st, jnp.int32(lo), jnp.int32(min(warm, lo + 4096)), (D,),
            num_sequences=n, frontend="matrix", dtype_name=dtype)
        st = jax.block_until_ready(st)
    return st, D


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    warm = n // 2
    st0, D = build_state(n, warm)
    reps = 3

    def loop(lo, hi, st, D, mode):
        def body(i, st):
            row = jax.lax.dynamic_index_in_dim(D, i, 0, keepdims=False)
            if mode == "row":
                # touch state with the row so nothing is elided
                return st._replace(
                    length=st.length.at[0].add(row[0] * 0))
            eid, frac, add = KC.score_edges(st, row)
            if mode == "score":
                return st._replace(length=st.length.at[eid].add(add * 0))
            st = KC.splice(st, eid, frac, add, i, n)
            if mode == "splice":
                return st
            return KC.update_closest_bfs(st, i, 2 * n)
        return jax.lax.fori_loop(lo, hi, body, st)

    for mode in ("row", "score", "splice", "full"):
        fn = jax.jit(loop, static_argnames=("mode",))
        out = fn(jnp.int32(warm), jnp.int32(warm + iters), st0, D, mode)
        np.asarray(out.length)  # wait for completion
        best = 1e9
        for r in range(reps):
            lo = warm + 1 + r
            t0 = time.time()
            out = fn(jnp.int32(lo), jnp.int32(lo + iters), st0, D, mode)
            np.asarray(out.length)
            best = min(best, time.time() - t0)
        print(f"{mode:8s} {best/iters*1e3:8.3f} ms/insertion "
              f"({iters} iters, best of {reps})")
        sys.stdout.flush()

    # ---- end-to-end insert-range: direct scorer vs epoch scorer ----
    # (run_insert_range includes the block prefetch + splice + BFS, so
    # this is the honest whole-loop per-insertion cost on the matrix
    # frontend — the mash block cost adds on top in production)
    cfgs = [("direct", None),
            ("ep-256s", (256, 2048, 8192)),
            ("ep-128s", (128, 1024, 4096)),
            ("ep-512s", (512, 2560, 8192))]
    # epoch-aligned range starts (512 is a multiple of every tested T)
    # so the sentinel full-rescore entry epoch doesn't skew the epoch
    # rows
    base = (warm - reps * 512) // 512 * 512
    for name, cfg in cfgs:
        try:
            out = KC.run_insert_range(
                st0, jnp.int32(base), jnp.int32(base + iters), (D,),
                num_sequences=n, frontend="matrix", dtype_name="float32",
                scorer_cfg=cfg)
            np.asarray(out.length)
            best = 1e9
            for r in range(reps):
                lo = base + 512 * (r + 1)
                t0 = time.time()
                out = KC.run_insert_range(
                    st0, jnp.int32(lo), jnp.int32(lo + iters), (D,),
                    num_sequences=n, frontend="matrix",
                    dtype_name="float32", scorer_cfg=cfg)
                np.asarray(out.length)
                best = min(best, time.time() - t0)
            print(f"{name:8s} {best/iters*1e3:8.3f} ms/insertion "
                  f"(insert-range, {iters} iters, best of {reps})")
        except Exception as e:
            print(f"{name:8s} FAILED: {type(e).__name__}: {e}"[:300])
        sys.stdout.flush()


if __name__ == "__main__":
    main()

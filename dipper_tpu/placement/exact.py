"""Exact incremental placement (placemode 0).

Behavioral spec (src/placement.cu): like k-closest placement, but the
per-edge bounds are exact: for every directed edge (s->t),

    lim[s->t] = max over leaves x on the s-side of the edge of
                ( d(new, x) - dist_tree(s, x) ),   floored at 0

computed per insertion by a bottom-up pass over BFS levels
(updateFromBottomToTop :297-328) and a top-down pass
(updateFromTopToBottom :330-363); scoring then uses dis1 = lim[edge],
dis2 = lim[rev edge] on parent->child edges with the same clamp
sequence and (addi, eid) argmin as k-closest (calculateBranchLength
:156-198); splice as in placement.cu:200-253.

Design: the reference maintains dfs-ranks, BFS order and level
interval tables, incrementally re-sorted on device every insertion.
None of that is needed for level-synchronous sweeps: we carry only
`parent[node]` and `dep[node]`. Each insertion runs
- an UP-SWEEP while_loop over levels deepest->0: nodes of the level
  compute mx = max(0, d_new[leaf], scatter-max of children's
  lim - len) and write it to their parent edge;
- a DOWN-SWEEP over levels 0->deepest: for each downward edge (u->c),
  the max over u's OTHER incident edges of lim[rev] - len, computed
  with per-node top-2 scatter statistics (exclusive max without
  adjacency lists);
- splice + parent/dep maintenance (the child-side subtree's depths
  shift by one, marked by a parent-pointer propagation loop).

All passes are full-width masked vector ops; the only sequential
dimension is tree depth, as in the reference's level loops.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dipper_tpu.placement.kclosest import _make_row_fn

BIG_DEP = jnp.int32(1 << 30)
SENT_DIS = 2.0


class ExactState(NamedTuple):
    e: jnp.ndarray        # [E] int32
    belong: jnp.ndarray   # [E] int32
    length: jnp.ndarray   # [E] f
    rev: jnp.ndarray      # [E] int32
    parent: jnp.ndarray   # [M] int32 (M = pad index for none)
    dep: jnp.ndarray      # [M] int32 (BIG_DEP = not in tree)
    idx: jnp.ndarray      # scalar int32


def _init_state(N: int, dtype) -> ExactState:
    E = 4 * N
    M = 2 * N
    return ExactState(
        e=jnp.full((E,), -1, jnp.int32),
        belong=jnp.full((E,), -1, jnp.int32),
        length=jnp.zeros((E,), dtype),
        rev=jnp.full((E,), -1, jnp.int32),
        parent=jnp.full((M,), M, jnp.int32),
        dep=jnp.full((M,), BIG_DEP, jnp.int32),
        idx=jnp.int32(0),
    )


def _build_initial(st: ExactState, d01, N: int) -> ExactState:
    h = d01 / 2
    e = st.e.at[0].set(N).at[1].set(N).at[2].set(0).at[3].set(1)
    belong = st.belong.at[0].set(0).at[1].set(1).at[2].set(N).at[3].set(N)
    length = st.length.at[0].set(h).at[1].set(h).at[2].set(h).at[3].set(h)
    rev = st.rev.at[0].set(2).at[1].set(3).at[2].set(0).at[3].set(1)
    parent = st.parent.at[0].set(N).at[1].set(N)
    dep = st.dep.at[N].set(0).at[0].set(1).at[1].set(1)
    return ExactState(e, belong, length, rev, parent, dep, jnp.int32(4))


def _compute_lims(st: ExactState, dist_row, N: int):
    """Returns lim[E] for the current tree and distance row."""
    E = st.e.shape[0]
    M = 2 * N
    dtype = st.length.dtype
    in_edge = st.belong >= 0
    src = jnp.where(in_edge, st.belong, 0)
    dst = jnp.where(in_edge, st.e, 0)
    dep_src = st.dep[src]
    dep_dst = st.dep[dst]
    upward = in_edge & (dep_src > dep_dst)     # child -> parent
    downward = in_edge & (dep_src < dep_dst)
    maxdep = jnp.max(jnp.where(st.dep < BIG_DEP, st.dep, 0))

    lim = jnp.zeros((E,), dtype)

    # ---- up-sweep: levels maxdep .. 1 (upward edges out of level-l nodes)
    # reference: mx = 0, overwritten by dist[u] for leaves (:317-318)
    leaf_base = jnp.where(
        (jnp.arange(M) < N) & (st.dep < BIG_DEP),
        dist_row[jnp.minimum(jnp.arange(M), N - 1)],
        0.0,
    ).astype(dtype)

    def up_body(carry):
        lim, level = carry
        # children contributions into their parent nodes: upward edges
        # whose source is at depth `level+1`
        contrib_mask = upward & (dep_src == level + 1)
        vals = jnp.where(contrib_mask, lim - st.length, -jnp.inf)
        tgt = jnp.where(contrib_mask, dst, M)
        node_child = jnp.full((M + 1,), -jnp.inf, dtype).at[tgt].max(vals)[:M]
        mx = jnp.maximum(leaf_base, node_child)
        # assign to upward edges out of level-l nodes
        assign = upward & (dep_src == level)
        lim = jnp.where(assign, mx[src], lim)
        return lim, level - 1

    lim, _ = jax.lax.while_loop(
        lambda c: c[1] >= 1, up_body, (lim, maxdep)
    )

    # ---- down-sweep: levels 0 .. maxdep-1
    def down_body(carry):
        lim, level = carry
        # candidate value of every incident edge j of node u:
        # cand[j] = lim[rev j] - len j (parent edge's rev is downward,
        # already assigned at level-1; child edges' rev are upward)
        cand = jnp.where(in_edge, lim[st.rev] - st.length, -jnp.inf)
        atlvl = in_edge & (dep_src == level)
        v = jnp.where(atlvl, cand, -jnp.inf)
        tgt = jnp.where(atlvl, src, M)
        max1 = jnp.full((M + 1,), -jnp.inf, dtype).at[tgt].max(v)[:M]
        is_max = atlvl & (v == max1[src])
        cnt = jnp.zeros((M + 1,), jnp.int32).at[tgt].add(
            is_max.astype(jnp.int32))[:M]
        v2 = jnp.where(is_max, -jnp.inf, v)
        max2 = jnp.full((M + 1,), -jnp.inf, dtype).at[
            jnp.where(atlvl & ~is_max, src, M)].max(v2)[:M]
        excl = jnp.where(
            is_max,
            jnp.where(cnt[src] > 1, max1[src], max2[src]),
            max1[src],
        )
        mx = jnp.maximum(excl, 0.0)  # reference mx starts at 0
        assign = downward & (dep_src == level)
        lim = jnp.where(assign, mx, lim)
        return lim, level + 1

    lim, _ = jax.lax.while_loop(
        lambda c: c[1] <= maxdep, down_body, (lim, jnp.int32(0))
    )
    return lim


def _score_exact(st: ExactState, lim):
    dtype = st.length.dtype
    in_edge = st.belong >= 0
    src = jnp.where(in_edge, st.belong, 0)
    dst = jnp.where(in_edge, st.e, 0)
    eids = jnp.arange(st.e.shape[0], dtype=jnp.int32)
    valid = in_edge & (eids < st.idx) & (st.dep[src] < st.dep[dst])
    dis1 = lim[eids]
    dis2 = lim[st.rev]
    L = st.length
    addi = jnp.maximum((dis1 + dis2 - L) * 0.5, 0.0)
    dis1 = jnp.maximum(dis1 - addi, 0.0)
    dis2 = jnp.maximum(dis2 - addi, 0.0)
    addi = addi + jnp.maximum(dis1 - L, 0.0) + jnp.maximum(dis2 - L, 0.0)
    dis1 = jnp.minimum(dis1, L)
    dis2 = jnp.minimum(dis2, L)
    rest = L - dis1 - dis2
    dis1 = dis1 + rest * 0.5
    score = jnp.where(valid, addi, jnp.asarray(SENT_DIS, dtype))
    frac = jnp.where(valid, dis1, 0.0)
    eid = jnp.argmin(score).astype(jnp.int32)
    return eid, frac[eid], score[eid]


def _splice_exact(st: ExactState, eid, frac, add, place_id, N: int) -> ExactState:
    M = 2 * N
    place_id = jnp.asarray(place_id, jnp.int32)
    middle = place_id + N - 1
    outside = place_id
    x = st.belong[eid]
    y = st.e[eid]
    orig = st.length[eid]
    xe = eid
    ye = st.rev[eid]
    i0, i1, i2, i3 = st.idx, st.idx + 1, st.idx + 2, st.idx + 3

    e = st.e.at[xe].set(middle).at[ye].set(middle)
    length = st.length.at[xe].set(frac).at[ye].set(orig - frac)
    rev = st.rev.at[xe].set(i0).at[ye].set(i1)
    e = e.at[i0].set(x).at[i1].set(y).at[i2].set(middle).at[i3].set(outside)
    belong = st.belong.at[i0].set(middle).at[i1].set(middle) \
        .at[i2].set(outside).at[i3].set(middle)
    length = length.at[i0].set(frac).at[i1].set(orig - frac) \
        .at[i2].set(add).at[i3].set(add)
    rev = rev.at[i0].set(xe).at[i1].set(ye).at[i2].set(i3).at[i3].set(i2)

    # parent/dep maintenance: pa = shallower endpoint, ch = deeper
    dx = st.dep[x]
    dy = st.dep[y]
    pa = jnp.where(dx < dy, x, y)
    ch = jnp.where(dx < dy, y, x)
    # subtree(ch) marking by parent-pointer propagation (old pointers)
    mark = jnp.zeros((M,), jnp.bool_).at[ch].set(True)

    def prop_cond(c):
        return c[1]

    def prop_body(c):
        mark, _ = c
        p = st.parent
        pm = jnp.where(p < M, mark[jnp.minimum(p, M - 1)], False)
        nm = mark | pm
        return nm, jnp.any(nm != mark)

    mark, _ = jax.lax.while_loop(prop_cond, prop_body, (mark, jnp.bool_(True)))
    dep = jnp.where(mark, st.dep + 1, st.dep)
    dep = dep.at[middle].set(st.dep[pa] + 1).at[outside].set(st.dep[pa] + 2)
    parent = st.parent.at[ch].set(middle).at[middle].set(pa) \
        .at[outside].set(middle)
    return ExactState(e, belong, length, rev, parent, dep, st.idx + 4)


def _exact_insert_loop(st: ExactState, lo, hi, frontend_args, frontend: str,
                       frontend_static, dtype_name: str, N: int):
    """fori_loop over insertions lo..hi-1 (lo/hi may be traced — the
    chunked driver reuses one compile for every range) with blocked
    distance-row prefetch (see kclosest._make_block_fn: rows are
    tree-independent, so mash/msa frontends batch them)."""
    from dipper_tpu.placement.kclosest import ROW_BLOCK, _make_block_fn

    def step(st, row, i):
        lim = _compute_lims(st, row, N)
        eid, frac, add = _score_exact(st, lim)
        return _splice_exact(st, eid, frac, add, i, N)

    B = ROW_BLOCK
    block_fn = _make_block_fn(
        frontend_args, frontend, frontend_static, dtype_name, N, B)

    if block_fn is None:
        row_fn = _make_row_fn(frontend_args, frontend, frontend_static,
                              dtype_name)

        def body(i, st):
            return step(st, row_fn(i), i)

        return jax.lax.fori_loop(lo, hi, body, st)

    blk0 = block_fn((jnp.asarray(lo, jnp.int32) // B) * B)

    def body(i, carry):
        st, blk = carry
        i32 = jnp.asarray(i, jnp.int32)
        start = (i32 // B) * B
        blk = jax.lax.cond(i32 == start, block_fn, lambda _: blk, start)
        row = jax.lax.dynamic_index_in_dim(blk, i32 - start, axis=0,
                                           keepdims=False)
        return step(st, row, i), blk

    st, _ = jax.lax.fori_loop(lo, hi, body, (st, blk0))
    return st


@functools.partial(
    jax.jit,
    static_argnames=("num_sequences", "frontend", "frontend_static",
                     "dtype_name"),
)
def init_exact_state(frontend_args, *, num_sequences: int, frontend: str,
                     frontend_static=(), dtype_name: str) -> ExactState:
    N = num_sequences
    dtype = jnp.dtype(dtype_name)
    row_fn = _make_row_fn(frontend_args, frontend, frontend_static, dtype_name)
    st = _init_state(N, dtype)
    return _build_initial(st, row_fn(jnp.int32(1))[0].astype(dtype), N)


@functools.partial(
    jax.jit,
    static_argnames=("num_sequences", "frontend", "frontend_static",
                     "dtype_name"),
)
def run_exact_range(st: ExactState, lo, hi, frontend_args, *,
                    num_sequences: int, frontend: str, frontend_static=(),
                    dtype_name: str) -> ExactState:
    return _exact_insert_loop(
        st, lo, hi, frontend_args, frontend, frontend_static, dtype_name,
        num_sequences)


# Insertions per exact-range dispatch: exact's per-insertion lim
# sweeps are O(E)-per-level while_loops; the cap bounds one dispatch's
# size (ROADMAP D2). lo/hi are traced, so the cap costs extra
# dispatches, not extra compiles.
_EXACT_DISPATCH_CAP = 1024


def run_exact_chunked(frontend_args, *, num_sequences: int, frontend: str,
                      frontend_static=(), dtype_name: str,
                      chunk: int = 8192, save_state: str | None = None,
                      load_state: str | None = None,
                      fingerprint: dict | None = None,
                      log=None) -> ExactState:
    """Whole exact build via bounded dispatches with checkpoint/resume —
    scale parity with kclosest.run_placement_chunked (the reference's
    exact path, src/placement.cu:508-789, has neither). Identical
    output to a single whole-build dispatch: same loop body, one
    compile serves every insertion range."""
    import os
    import time

    from dipper_tpu.placement.kclosest import (
        load_tree_state, save_tree_state,
    )

    N = num_sequences
    kw = dict(num_sequences=N, frontend=frontend,
              frontend_static=frontend_static, dtype_name=dtype_name)
    fp = dict(fingerprint or {})
    fp.update(frontend=frontend, dtype=dtype_name, placement="exact")
    if load_state and os.path.exists(load_state):
        st, i0 = load_tree_state(load_state, N, jnp.dtype(dtype_name), fp,
                                 cls=ExactState)
        if log:
            log(f"Resumed exact placement at insertion {i0}/{N}")
    else:
        st = init_exact_state(frontend_args, **kw)
        i0 = 2

    # mash/msa distance rows are computed OUTSIDE the insert program
    # (small cached block dispatches) exactly as in
    # kclosest.run_placement_chunked — the in-loop distance kernels
    # would dominate the insert program's compile.
    from dipper_tpu.placement.kclosest import (
        ROW_BLOCK, _ROWS_BYTES, _row_block,
    )

    rows_outside = frontend != "matrix"
    B = ROW_BLOCK
    dtype = jnp.dtype(dtype_name)
    ce = max(B, min(chunk, _EXACT_DISPATCH_CAP,
                    (_ROWS_BYTES // (dtype.itemsize * N)) // B * B))
    R_next = None
    lo = i0
    while lo < N:
        hi_ck = min(N, lo + chunk)
        t0 = time.time()
        if rows_outside:
            hi = min(hi_ck, lo + ce)
            lo0 = (lo // B) * B
            # one dispatch for the whole range's rows; the next range's
            # rows are enqueued behind the insert dispatch (see
            # kclosest.run_placement_chunked)
            if R_next is None:
                R_next = _row_block(frontend_args, jnp.int32(lo0),
                                    frontend=frontend,
                                    frontend_static=frontend_static,
                                    dtype_name=dtype_name, B=ce + B)
            R = R_next
            st = run_exact_range(
                st, jnp.int32(lo), jnp.int32(hi), (R, jnp.int32(lo0)),
                num_sequences=N, frontend="rows", frontend_static=(),
                dtype_name=dtype_name)
            R_next = None
            if hi < N:
                R_next = _row_block(frontend_args,
                                    jnp.int32((hi // B) * B),
                                    frontend=frontend,
                                    frontend_static=frontend_static,
                                    dtype_name=dtype_name, B=ce + B)
        else:
            hi = min(hi_ck, lo + _EXACT_DISPATCH_CAP)
            st = run_exact_range(st, jnp.int32(lo), jnp.int32(hi),
                                 frontend_args, **kw)
        # 4-byte D2H drain; see kclosest.run_placement_chunked
        int(jax.device_get(st.idx))
        if log:
            log(f"Inserted {hi}/{N} "
                f"({(time.time() - t0) / max(hi - lo, 1) * 1e3:.2f} "
                f"ms/insertion)")
        if save_state and (hi == N or hi // chunk > lo // chunk):
            save_tree_state(save_state, st, hi, N, fp)
            if log:
                log(f"Checkpointed exact placement at insertion {hi}/{N}")
        lo = hi
    return st


def run_exact_placement(frontend_args, *, num_sequences: int, frontend: str,
                        frontend_static=(), dtype_name: str, **chunk_kw):
    """Driver entry: returns final (e, belong, length) edge arrays."""
    st = run_exact_chunked(
        frontend_args, num_sequences=num_sequences, frontend=frontend,
        frontend_static=frontend_static, dtype_name=dtype_name,
        **{"chunk": max(num_sequences, 2), **chunk_kw})
    return st.e, st.belong, st.length

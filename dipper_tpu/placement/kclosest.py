"""K-closest incremental placement, fully on-device.

Behavioral spec (src/placement_close_k.cu):
- tree stored as directed edge arrays (4 new directed edges per
  insertion; node ids: leaf i -> i, middle node of insertion i ->
  N+i-1; allocation contract 2N nodes / 4N-4 edges),
- every directed edge (a->b) keeps the K=5 closest leaves on the
  a-side with their tree distance from a, ascending, sentinel
  (id=-1, dis=2.0) (:56-84),
- per new taxon: distance row to placed taxa; score one direction per
  undirected edge (belong > e, :326); dis1/dis2 = max over witness
  entries of d(new,leaf) - closest_dis (:334-344); the clamp sequence
  (:346-355) yields (fracLen, additional_dis); minimize
  (additional_dis, eid) — thrust::min_element first-minimum == lowest
  eid (:807);
- splice (:446-528): x-side edge keeps id (becomes x->middle), y-side
  becomes y->middle; 4 new edges middle->x / middle->y /
  outside->middle / middle->outside with closest lists copied+shifted
  from the severed halves, and middle->outside = stable insert-merge
  of (middle->y then middle->x) lists;
- closest lists then updated by a BFS from the new leaf that
  insert-sorts (leaf, d) into each visited edge's list and prunes when
  the leaf doesn't beat an edge's 5th entry (:86-124).

Design: the reference runs the BFS and splice as serial <<<1,1>>>
kernels and scores edges with one thread each. Here one jit contains
the whole build: a `fori_loop` over insertions carrying fixed-shape
edge arrays; scoring is a masked vector pass over all 4N edge slots
(dis2 found via a maintained `rev` permutation instead of walking
adjacency lists); the splice is a handful of dynamic-index updates; the
BFS becomes a frontier `while_loop` — each level relaxes *all* edges
whose source is in the frontier at once (edge-parallel, no adjacency
structure needed), with the insert position computed arithmetically
(count of entries <= d). Tree-equivalence with the serial BFS holds
because each node is reached along its unique tree path, so insertions
into distinct edges commute.

The distance row is computed inside the loop by a pluggable frontend
(precomputed matrix row / mash intersection-count row / MSA matmul row).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

K = 5
SENT_DIS = 2.0


class TreeState(NamedTuple):
    e: jnp.ndarray        # [E] int32 dst node (-1 unused)
    belong: jnp.ndarray   # [E] int32 src node (-1 unused)
    length: jnp.ndarray   # [E] f    branch length
    rev: jnp.ndarray      # [E] int32 reverse edge id
    cdis: jnp.ndarray     # [E, K] f closest distances (ascending)
    cid: jnp.ndarray      # [E, K] int32 closest leaf ids (-1 empty)
    idx: jnp.ndarray      # scalar int32: next free edge slot
    # [M, 3] int32 out-edge ids per node (-1 empty): nodes of an
    # unrooted binary tree have degree <= 3, and a splice only ever
    # (re)writes the rows of the two NEW nodes, so maintenance is two
    # row-sets per insertion. Lets the witness BFS touch only
    # frontier-adjacent edges instead of all E slots (see
    # _update_closest_bfs_compact). None on states that never run the
    # compact BFS (the vmapped D&C local cluster builds).
    adj: jnp.ndarray = None
    # scalar int32: count of compact-BFS frontier overflows that fell
    # back to the dense all-E BFS — the fallback is a silent perf cliff
    # at scale, so runs log it per chunk. None when adj is None.
    nfb: jnp.ndarray = None


def init_state(num_sequences: int, dtype) -> TreeState:
    E = 4 * num_sequences
    return TreeState(
        e=jnp.full((E,), -1, jnp.int32),
        belong=jnp.full((E,), -1, jnp.int32),
        length=jnp.zeros((E,), dtype),
        rev=jnp.full((E,), -1, jnp.int32),
        cdis=jnp.full((E, K), SENT_DIS, dtype),
        cid=jnp.full((E, K), -1, jnp.int32),
        idx=jnp.int32(0),
        adj=jnp.full((2 * num_sequences, 3), -1, jnp.int32),
        nfb=jnp.int32(0),
    )


def _add_edge(st: TreeState, slot, src, dst, ln, rv) -> TreeState:
    return st._replace(
        e=st.e.at[slot].set(dst),
        belong=st.belong.at[slot].set(src),
        length=st.length.at[slot].set(ln),
        rev=st.rev.at[slot].set(rv),
    )


def build_initial_tree(st: TreeState, d01, num_sequences: int) -> TreeState:
    """Edges 0..3 joining taxa 0,1 through node N (buildInitialTree,
    src/placement_close_k.cu:530-554 + rev wiring as in placement.cu)."""
    N = num_sequences
    h = d01 / 2
    st = _add_edge(st, 0, 0, N, h, 2)
    st = _add_edge(st, 1, 1, N, h, 3)
    st = _add_edge(st, 2, N, 0, h, 0)
    st = _add_edge(st, 3, N, 1, h, 1)
    if st.adj is not None:
        adj = st.adj.at[0].set(jnp.array([0, -1, -1], jnp.int32)) \
            .at[1].set(jnp.array([1, -1, -1], jnp.int32)) \
            .at[N].set(jnp.array([2, 3, -1], jnp.int32))
        st = st._replace(adj=adj)
    return st._replace(idx=jnp.int32(4))


def update_closest_bfs(st: TreeState, leaf, num_nodes: int, label=None,
                       blocked_nodes=()) -> TreeState:
    """Frontier equivalent of updateClosestNodes
    (src/placement_close_k.cu:86-124). `leaf` is the BFS source node;
    `label` is the id recorded in witness lists (defaults to the node —
    the D&C cluster engine uses local nodes but witness-space labels).
    `blocked_nodes` are dequeued-but-not-expanded nodes (the cluster
    edge endpoints in updateClosestNodesInClusterDC :334).

    Dispatch: states carrying an adjacency table run the
    frontier-compact version (work per level ~ frontier size);
    adj-less states (the vmapped D&C
    cluster builds, where a lax.cond would execute both branches per
    lane) run the dense edge-parallel version. Both produce bitwise
    identical states: each visited edge receives the same (d, label)
    insert at the same position, and insertions into distinct edges
    commute."""
    if st.adj is not None:
        return _update_closest_bfs_compact(st, leaf, num_nodes, label,
                                           blocked_nodes)
    return _update_closest_bfs_dense(st, leaf, num_nodes, label,
                                     blocked_nodes)


def _update_closest_bfs_dense(st: TreeState, leaf, num_nodes: int, label=None,
                              blocked_nodes=()) -> TreeState:
    """Edge-parallel BFS: every level relaxes all E edge slots at once.
    O(E * depth) work — fine for small vmapped cluster trees, ruinous
    at bank scale; kept as the vmap-safe path and the overflow fallback
    of the compact version."""
    M = num_nodes  # = 2N
    dtype = st.length.dtype
    leaf = jnp.asarray(leaf, jnp.int32)
    if label is None:
        label = leaf
    label = jnp.asarray(label, jnp.int32)
    frontier = jnp.zeros((M,), jnp.bool_).at[leaf].set(True)
    from_node = jnp.full((M,), -1, jnp.int32)
    distx = jnp.zeros((M,), dtype)

    def cond(c):
        st, frontier, from_node, distx = c
        return jnp.any(frontier)

    def body(c):
        st, frontier, from_node, distx = c
        src = st.belong
        used = src >= 0
        srcc = jnp.where(used, src, 0)
        expand = frontier
        for b in blocked_nodes:
            expand = expand.at[b].set(False)
        act = used & expand[srcc] & (st.e != from_node[srcc])
        d = distx[srcc]
        pos = jnp.sum((st.cdis <= d[:, None]).astype(jnp.int32), axis=1)
        ok = act & (pos < K)
        # arithmetic insert of (d, leaf) at position pos
        slot = jax.lax.broadcasted_iota(jnp.int32, (st.cdis.shape[0], K), 1)
        before = slot < pos[:, None]
        at = slot == pos[:, None]
        shifted_cd = jnp.concatenate(
            [jnp.full((st.cdis.shape[0], 1), SENT_DIS, dtype), st.cdis[:, :-1]],
            axis=1,
        )
        shifted_id = jnp.concatenate(
            [jnp.full((st.cid.shape[0], 1), -1, jnp.int32), st.cid[:, :-1]], axis=1
        )
        new_cd = jnp.where(before, st.cdis, jnp.where(at, d[:, None], shifted_cd))
        new_id = jnp.where(before, st.cid, jnp.where(at, label, shifted_id))
        cdis = jnp.where(ok[:, None], new_cd, st.cdis)
        cid = jnp.where(ok[:, None], new_id, st.cid)
        # propagate to dst of successful edges. In a tree each node is
        # reached along its unique path, so the in-bounds dst indices
        # are distinct: unique_indices lets XLA emit a parallel scatter
        # instead of the generic may-collide one; failures land on
        # distinct out-of-bounds indices M+slot which mode='drop'
        # discards — distinct so unique_indices holds even for the
        # dropped set (XLA documents non-unique indices as UB).
        E_ = st.e.shape[0]
        dst = jnp.where(ok, st.e, M + jnp.arange(E_, dtype=jnp.int32))
        nfront = jnp.zeros((M,), jnp.bool_).at[dst].set(
            True, mode="drop", unique_indices=True)
        from_node = from_node.at[dst].set(
            src, mode="drop", unique_indices=True)
        distx = distx.at[dst].set(
            d + st.length, mode="drop", unique_indices=True)
        return st._replace(cdis=cdis, cid=cid), nfront, from_node, distx

    st, _, _, _ = jax.lax.while_loop(
        cond, body, (st, frontier, from_node, distx)
    )
    return st


# Frontier slots of the compact BFS. Wider fronts (possible only in
# pathologically bushy regions that also defeat the K=5 pruning) set an
# overflow flag and the whole BFS re-runs dense from the pre-BFS state,
# so the cap is a performance knob, never a correctness one.
_FRONTIER_CAP = 256


def _update_closest_bfs_compact(st: TreeState, leaf, num_nodes: int,
                                label=None, blocked_nodes=()) -> TreeState:
    """Frontier-compact BFS: carries the frontier as a fixed [F] list of
    (node, from, dist) and gathers/scatters only the <=3F edges leaving
    it via the maintained adjacency rows — per-level work is O(F), not
    O(E). With the witness-list pruning, measured fronts are tens wide
    and depths ~6 even at 30K taxa, so this turns the BFS from the
    dominant insertion cost (all-E rewrites per level) into noise."""
    M = num_nodes
    E = st.e.shape[0]
    dtype = st.length.dtype
    F = _FRONTIER_CAP
    leaf = jnp.asarray(leaf, jnp.int32)
    if label is None:
        label = leaf
    label = jnp.asarray(label, jnp.int32)
    ids0 = jnp.full((F,), -1, jnp.int32).at[0].set(leaf)
    frm0 = jnp.full((F,), -1, jnp.int32)
    dst0 = jnp.zeros((F,), dtype)

    def cond(c):
        _, _, _, _, cnt, bad = c
        return (cnt > 0) & ~bad

    def body(c):
        st, ids, frm, dist, cnt, bad = c
        valid = jnp.arange(F, dtype=jnp.int32) < cnt
        idsc = jnp.where(valid, ids, 0)
        expand = valid
        for b in blocked_nodes:
            expand = expand & (idsc != jnp.asarray(b, jnp.int32))
        eids = st.adj[idsc]                          # [F, 3]
        emask = expand[:, None] & (eids >= 0)
        eidsc = jnp.where(emask, eids, 0)
        dstn = st.e[eidsc]                           # [F, 3]
        emask = emask & (dstn != frm[:, None])       # no backtracking
        d = dist[:, None]
        cd = st.cdis[eidsc]                          # [F, 3, K]
        cidr = st.cid[eidsc]
        pos = jnp.sum((cd <= d[..., None]).astype(jnp.int32), axis=-1)
        ok = emask & (pos < K)
        slot = jax.lax.broadcasted_iota(jnp.int32, (F, 3, K), 2)
        before = slot < pos[..., None]
        at = slot == pos[..., None]
        shifted_cd = jnp.concatenate(
            [jnp.full((F, 3, 1), SENT_DIS, dtype), cd[..., :-1]], axis=-1)
        shifted_id = jnp.concatenate(
            [jnp.full((F, 3, 1), -1, jnp.int32), cidr[..., :-1]], axis=-1)
        new_cd = jnp.where(before, cd, jnp.where(at, d[..., None], shifted_cd))
        new_id = jnp.where(before, cidr, jnp.where(at, label, shifted_id))
        # distinct frontier nodes => distinct out-edges: unique rows;
        # dropped slots get distinct OOB indices E+slot (see dense BFS)
        oob_e = E + jnp.arange(F * 3, dtype=jnp.int32).reshape(F, 3)
        rows = jnp.where(ok, eidsc, oob_e).reshape(-1)
        cdis = st.cdis.at[rows].set(new_cd.reshape(-1, K),
                                    mode="drop", unique_indices=True)
        cid = st.cid.at[rows].set(new_id.reshape(-1, K),
                                  mode="drop", unique_indices=True)
        # next frontier: compact successful dsts by exclusive cumsum.
        # In-bounds ranks reach at most 3F-1 (an overflow round still
        # computes them before the bad-flag triggers the dense rerun),
        # so dropped slots start at 4F to stay distinct from every
        # possible rank — unique_indices must hold unconditionally.
        nd = d + st.length[eidsc]
        okf = ok.reshape(-1)
        tgt = jnp.where(okf, jnp.cumsum(okf.astype(jnp.int32)) - 1,
                        4 * F + jnp.arange(F * 3, dtype=jnp.int32))
        nids = jnp.full((F,), -1, jnp.int32).at[tgt].set(
            dstn.reshape(-1), mode="drop", unique_indices=True)
        nfrm = jnp.full((F,), -1, jnp.int32).at[tgt].set(
            jnp.broadcast_to(idsc[:, None], (F, 3)).reshape(-1),
            mode="drop", unique_indices=True)
        ndist = jnp.zeros((F,), dtype).at[tgt].set(
            nd.reshape(-1), mode="drop", unique_indices=True)
        ncnt = jnp.sum(okf.astype(jnp.int32)).astype(jnp.int32)
        bad = bad | (ncnt > F)
        return (st._replace(cdis=cdis, cid=cid), nids, nfrm, ndist,
                jnp.minimum(ncnt, jnp.int32(F)), bad)

    st_pre = st
    stc, _, _, _, _, bad = jax.lax.while_loop(
        cond, body, (st, ids0, frm0, dst0, jnp.int32(1), jnp.bool_(False)))
    st = jax.lax.cond(
        bad,
        lambda: _update_closest_bfs_dense(st_pre, leaf, M, label,
                                          blocked_nodes),
        lambda: stc)
    if st.nfb is not None:
        st = st._replace(nfb=st.nfb + bad.astype(jnp.int32))
    return st


def adjacency_from_edges(belong, num_nodes: int):
    """[M, 3] out-edge table recovered from the belong array — one-time
    seeding for loaded backbones (--add) and pre-adj checkpoints. Sort
    edge ids by source node, index each run; degree <= 3 in an unrooted
    binary tree so slot overflow cannot occur on well-formed trees."""
    E = belong.shape[0]
    belong = jnp.asarray(belong, jnp.int32)
    order = jnp.argsort(belong, stable=True).astype(jnp.int32)
    b_s = belong[order]
    idxs = jnp.arange(E, dtype=jnp.int32)
    first = jnp.concatenate([jnp.ones((1,), jnp.bool_), b_s[1:] != b_s[:-1]])
    run_first = jax.lax.associative_scan(
        jnp.maximum, jnp.where(first, idxs, 0))
    slotpos = idxs - run_first
    okm = (b_s >= 0) & (slotpos < 3)
    # dropped entries get distinct OOB rows so unique_indices holds
    rows = jnp.where(okm, b_s, num_nodes + idxs)
    cols = jnp.where(okm, slotpos, 0)
    return jnp.full((num_nodes, 3), -1, jnp.int32).at[rows, cols].set(
        order, mode="drop", unique_indices=True)


def _side_vector(cid, cdis, dist_row):
    """side[e] = max(max_j d(new, witness_j) - witness_dis_j, 0) — the
    dis1/dis2 maximization of calculateBranchLength
    (src/placement_close_k.cu:334-344)."""
    dv = jnp.where(cid != -1, dist_row[jnp.maximum(cid, 0)] - cdis,
                   -jnp.inf)
    return jnp.maximum(jnp.max(dv, axis=-1), 0.0)


def _finish_score(st: TreeState, side, dis2, edge_mask=None):
    """Clamp sequence + first-minimum argmin of calculateBranchLength
    (src/placement_close_k.cu:346-355, :807). `side`/`dis2` are the
    per-directed-edge witness maxima (dis1 of the edge, dis1 of its
    reverse)."""
    dtype = st.length.dtype
    valid = st.belong > st.e
    if edge_mask is not None:
        valid = valid & edge_mask
    dis1 = side
    L = st.length
    addi = (dis1 + dis2 - L) * 0.5
    addi = jnp.maximum(addi, 0.0)
    dis1 = jnp.maximum(dis1 - addi, 0.0)
    dis2 = jnp.maximum(dis2 - addi, 0.0)
    addi = addi + jnp.maximum(dis1 - L, 0.0) + jnp.maximum(dis2 - L, 0.0)
    dis1 = jnp.minimum(dis1, L)
    dis2 = jnp.minimum(dis2, L)
    rest = L - dis1 - dis2
    dis1 = dis1 + rest * 0.5
    # invalid slots carry the sentinel tuple (eid=slot, frac=0, addi=2):
    # if no real candidate beats 2.0, argmin lands on slot 0 and the
    # splice targets edge 0 with frac=0 add=2, like thrust::min_element
    # over the sentinel-filled minPos buffer.
    score = jnp.where(valid, addi, jnp.asarray(SENT_DIS, dtype))
    frac = jnp.where(valid, dis1, 0.0)
    eid = jnp.argmin(score).astype(jnp.int32)  # first-minimum == lowest eid
    return eid, frac[eid], score[eid]


def score_edges(st: TreeState, dist_row, edge_mask=None):
    """Vectorized calculateBranchLength (src/placement_close_k.cu:309-358).
    Returns (eid, fracLen, addLen); ties -> lowest eid. `edge_mask`
    optionally restricts scoring (D&C cluster phase)."""
    side = _side_vector(st.cid, st.cdis, dist_row)     # [E]
    return _finish_score(st, side, side[st.rev], edge_mask)


# ---------------------------------------------------------------------------
# Epoch witness scorer
#
# The [E, K] scalar gather dist_row[cid] inside score_edges is paid on
# every insertion (ROADMAP D5 asks whether the epoch scorer below still
# earns its place on the GPU). Witness lists barely change between consecutive
# insertions, and distance rows depend only on the sequences — so the
# loop amortizes the gather over an *epoch* of T insertions:
#
#   * at epoch start, precompute SIDE0[e, t] = side-value of edge e for
#     insertion t across the whole epoch in one batched pass. Batching
#     turns the scalar gather into a row gather from the transposed
#     row block [bank, T] — every witness id fetches a T-wide f32 lane
#     row instead of one scalar, amortizing the per-index cost ~T-fold;
#   * inside the loop, an edge is *dirty* iff its (cid, cdis) row
#     changed since epoch start (exact elementwise compare — cheap
#     sequential vector traffic). Only dirty edges are exact-rescored
#     through a compact fixed-size buffer; everything else reads
#     SIDE0[:, t].
#
# Bitwise parity with score_edges holds because non-dirty edges see the
# identical f32 ops on identical values (same row, same cid/cdis), and
# dirty edges run the identical per-edge formula — so the score vector,
# and therefore the argmin tie order, is unchanged. One test asserts
# full-build state equality against the direct path.
# ---------------------------------------------------------------------------

# (T, tier1, tier2): epoch length in insertions and the two compact
# rescore sizes; ndirty > tier2 falls back to a full rescore of the
# epoch (correct, rarely hit). scripts/dirty_probe.py counts dirty
# edges per insertion; scripts/placement_micro.py times the scorer
# configurations against the direct path.
SCORER_CFG = (128, 1024, 4096)


class _Epoch(NamedTuple):
    side0: jnp.ndarray   # [T, E] side value per (epoch insertion, edge)
    rside0: jnp.ndarray  # [T, E] side0 permuted by epoch-start rev
    cid0: jnp.ndarray    # [E, K] witness ids at epoch start
    cdis0: jnp.ndarray   # [E, K] witness distances at epoch start
    rev0: jnp.ndarray    # [E]    reverse-edge ids at epoch start
    t0: jnp.ndarray      # scalar int32 insertion id of epoch start


def _make_epoch(st: TreeState, rows_T, t0) -> _Epoch:
    """Precompute SIDE0 for insertions t0..t0+T-1 from the current
    witness lists. rows_T is [T, bank] distance rows (from the block
    prefetch). Tiled over edges to bound the [rows, K, T] transient."""
    E, Kk = st.cid.shape
    T = rows_T.shape[0]
    RT = rows_T.T                                     # [bank, T]
    tile = max(1, (512 * 2 ** 20) // (Kk * T * RT.dtype.itemsize))
    parts = []
    for a in range(0, E, tile):
        b = min(E, a + tile)
        cid_c = st.cid[a:b]
        G = RT[jnp.maximum(cid_c, 0).reshape(-1)].reshape(b - a, Kk, T)
        dv = jnp.where((cid_c != -1)[:, :, None],
                       G - st.cdis[a:b, :, None], -jnp.inf)
        parts.append(jnp.maximum(jnp.max(dv, axis=1), 0.0))
    side0 = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
    rside0 = side0[jnp.maximum(st.rev, 0)]
    # [T, E] layout: the per-insertion read is then one contiguous row
    # (an [E, T] column slice costs a cache line per element)
    return _Epoch(side0.T, rside0.T, st.cid, st.cdis, st.rev,
                  jnp.asarray(t0, jnp.int32))


def _sentinel_epoch(st: TreeState, T: int, t0) -> _Epoch:
    """Epoch that marks every edge dirty (cid0 = -2 matches nothing), so
    scoring always takes the full-rescore branch — used when the loop
    enters at an insertion id not aligned to the epoch grid (checkpoint
    resume, --add backbones): at most T-1 insertions run at legacy cost
    before the first real epoch."""
    E, Kk = st.cid.shape
    dtype = st.length.dtype
    return _Epoch(jnp.zeros((T, E), dtype), jnp.zeros((T, E), dtype),
                  jnp.full((E, Kk), -2, jnp.int32), st.cdis, st.rev,
                  jnp.asarray(t0, jnp.int32))


def _score_edges_epoch(st: TreeState, row, ep: _Epoch, t, tiers):
    """score_edges via the epoch cache: bitwise-identical
    (eid, frac, add). `t` is the insertion offset within the epoch."""
    E, Kk = st.cid.shape
    iota_e = jnp.arange(E, dtype=jnp.int32)
    dirty = jnp.any((st.cid != ep.cid0) | (st.cdis != ep.cdis0), axis=1)
    rank = jnp.cumsum(dirty.astype(jnp.int32)) - 1
    ndirty = jnp.sum(dirty.astype(jnp.int32))
    rev_changed = (st.rev != ep.rev0) & (st.belong >= 0)

    def tier_branch(cap: int):
        # 6 rev slots are rewritten per splice, so the fix set (edges
        # whose dis2 cannot come from rside0) is bounded by
        # ndirty + 6 * (insertions this epoch) <= cap + 6 * T.
        capf = cap + 6 * ep.side0.shape[0]

        def br():
            tgt = jnp.where(dirty & (rank < cap), rank, cap + iota_e)
            ids_c = jnp.full((cap,), E, jnp.int32).at[tgt].set(
                iota_e, mode="drop", unique_indices=True)
            valid_c = jnp.arange(cap, dtype=jnp.int32) < ndirty
            idc = jnp.minimum(ids_c, E - 1)  # clamp pad slots for gathers
            se = _side_vector(st.cid[idc], st.cdis[idc], row)   # [cap]
            wr = jnp.where(valid_c, ids_c,
                           E + jnp.arange(cap, dtype=jnp.int32))
            side = jax.lax.dynamic_index_in_dim(ep.side0, t, axis=0,
                                                keepdims=False)
            side = side.at[wr].set(se, mode="drop", unique_indices=True)
            # dis2[e] = side[rev[e]] — valid from rside0 unless rev[e]
            # changed since epoch start or rev[e] is dirty. The latter
            # set is exactly rev0[dirty] (rev0 is an involution on the
            # slots used at epoch start; dirty NEW slots have rev0=-1,
            # but their reverse partners are rev-changed, so dropping
            # them keeps the union complete).
            r0 = ep.rev0[idc]
            fix_ids = jnp.where(valid_c & (r0 >= 0), r0,
                                E + jnp.arange(cap, dtype=jnp.int32))
            need = rev_changed.at[fix_ids].set(True, mode="drop",
                                               unique_indices=True)
            frank = jnp.cumsum(need.astype(jnp.int32)) - 1
            ftgt = jnp.where(need & (frank < capf), frank, capf + iota_e)
            fids = jnp.full((capf,), E, jnp.int32).at[ftgt].set(
                iota_e, mode="drop", unique_indices=True)
            nfix = jnp.sum(need.astype(jnp.int32))
            fvalid = jnp.arange(capf, dtype=jnp.int32) < nfix
            fidc = jnp.minimum(fids, E - 1)
            d2v = side[jnp.maximum(st.rev[fidc], 0)]
            fwr = jnp.where(fvalid, fids,
                            E + jnp.arange(capf, dtype=jnp.int32))
            dis2 = jax.lax.dynamic_index_in_dim(ep.rside0, t, axis=0,
                                                keepdims=False)
            dis2 = dis2.at[fwr].set(d2v, mode="drop", unique_indices=True)
            return side, dis2

        return br

    def full_branch():
        side = _side_vector(st.cid, st.cdis, row)
        return side, side[st.rev]

    t1, t2 = tiers
    tier = ((ndirty > t1).astype(jnp.int32)
            + (ndirty > t2).astype(jnp.int32))
    side, dis2 = jax.lax.switch(
        tier, [tier_branch(t1), tier_branch(t2), full_branch])
    return _finish_score(st, side, dis2)


def _insert_merge_lists(cd1, id1, cd2, id2, dtype):
    """Stable merge of two ascending K-lists (first list wins ties),
    reproducing the sequential insert-sort of updateTreeStructure
    (src/placement_close_k.cu:500-526). Sentinel entries sort last."""
    vals = jnp.concatenate([cd1, cd2])
    ids = jnp.concatenate([id1, id2])
    order = jnp.argsort(vals, stable=True)
    return vals[order][:K], ids[order][:K]


def splice(st: TreeState, eid, frac, add, place_id, num_sequences: int,
           middle=None, outside=None) -> TreeState:
    """updateTreeStructure (src/placement_close_k.cu:446-528).
    `middle`/`outside` override the default node numbering (used by the
    D&C cluster engine and the total-offset backbone phase)."""
    dtype = st.length.dtype
    N = num_sequences
    place_id = jnp.asarray(place_id, jnp.int32)  # fori index is int64 under x64
    if middle is None:
        middle = place_id + N - 1
    if outside is None:
        outside = place_id
    middle = jnp.asarray(middle, jnp.int32)
    outside = jnp.asarray(outside, jnp.int32)
    x = st.belong[eid]
    y = st.e[eid]
    orig = st.length[eid]
    xe = eid
    ye = st.rev[eid]
    i0 = st.idx
    i1 = i0 + 1
    i2 = i0 + 2
    i3 = i0 + 3

    cd_xe = st.cdis[xe]
    id_xe = st.cid[xe]
    cd_ye = st.cdis[ye]
    id_ye = st.cid[ye]

    e = st.e.at[xe].set(middle).at[ye].set(middle)
    length = st.length.at[xe].set(frac).at[ye].set(orig - frac)
    rev = st.rev.at[xe].set(i0).at[ye].set(i1)

    e = e.at[i0].set(x).at[i1].set(y).at[i2].set(middle).at[i3].set(outside)
    belong = st.belong.at[i0].set(middle).at[i1].set(middle) \
        .at[i2].set(outside).at[i3].set(middle)
    length = length.at[i0].set(frac).at[i1].set(orig - frac) \
        .at[i2].set(add).at[i3].set(add)
    rev = rev.at[i0].set(xe).at[i1].set(ye).at[i2].set(i3).at[i3].set(i2)

    # closest lists of the four new edges
    sent = jnp.asarray(SENT_DIS, dtype)
    # NB: (cd + orig) - frac, matching the reference's left-to-right
    # float association (:398) — bit parity matters at score ties
    cd_i0 = jnp.where(id_ye != -1, cd_ye + orig - frac, sent)
    id_i0 = id_ye
    cd_i1 = jnp.where(id_xe != -1, cd_xe + frac, sent)
    id_i1 = id_xe
    cd_i3, id_i3 = _insert_merge_lists(cd_i1, id_i1, cd_i0, id_i0, dtype)

    cdis = st.cdis.at[i0].set(cd_i0).at[i1].set(cd_i1) \
        .at[i2].set(jnp.full((K,), SENT_DIS, dtype)).at[i3].set(cd_i3)
    cid = st.cid.at[i0].set(id_i0).at[i1].set(id_i1) \
        .at[i2].set(jnp.full((K,), -1, jnp.int32)).at[i3].set(id_i3)

    adj = st.adj
    if adj is not None:
        # x and y keep their edge ids (xe/ye now point at middle), so
        # only the two NEW nodes' rows change
        adj = adj.at[middle].set(jnp.stack([i0, i1, i3])) \
            .at[outside].set(jnp.stack([i2, jnp.int32(-1), jnp.int32(-1)]))

    return TreeState(e, belong, length, rev, cdis, cid, st.idx + 4, adj,
                     st.nfb)


# ---------------------------------------------------------------------------
# Distance-row frontends
# ---------------------------------------------------------------------------


ROW_BLOCK = 256  # insertions per prefetched distance-row block


def make_matrix_row_fn(D):
    def row(i):
        return jax.lax.dynamic_index_in_dim(D, i, axis=0, keepdims=False)
    return row


def make_mash_row_fn(ranks_pad, k: int, sketch_size: int, dtype_name: str):
    from dipper_tpu.distance.mash import mash_row_from_ranks

    def row(i):
        return mash_row_from_ranks(
            ranks_pad, i, k=k, sketch_size=sketch_size, dtype_name=dtype_name
        )
    return row


def make_msa_row_fn(codes, nongap, distance_type: int, dtype_name: str):
    """codes uint8 [N,L] (packed bank), nongap [N]. Row i vs all j via
    tiled one-hot + int8 matmul (msa_tiled_block)."""
    from dipper_tpu.distance.msa import msa_tiled_block

    def row(i):
        c_i = jax.lax.dynamic_slice_in_dim(codes, i, 1, axis=0)
        ng_i = jax.lax.dynamic_slice_in_dim(nongap, i, 1, axis=0)
        blk = msa_tiled_block(
            c_i, ng_i, codes, nongap,
            distance_type=distance_type, dtype_name=dtype_name,
        )
        return blk[0]
    return row


# --- blocked row prefetch -------------------------------------------------
#
# Distance rows depend only on the sequences, never on the tree, so the
# insertion loop can prefetch them ROW_BLOCK at a time: mash blocks are
# one batched intersection-count call, MSA blocks one large int8
# matmul instead of a [1, N] sliver. The
# per-pair math is identical (integer intersection counts / identical
# pair-count matmuls), so trees are bit-identical to the row-at-a-time
# path.


def _pad_rows_to(x, n_pad: int):
    if x.shape[0] == n_pad:
        return x
    reps = jnp.tile(x[-1:], (n_pad - x.shape[0],) + (1,) * (x.ndim - 1))
    return jnp.concatenate([x, reps], axis=0)


def _make_block_fn(frontend_args, frontend: str, frontend_static,
                   dtype_name: str, N: int, B: int):
    """Returns block(start) -> [B, bank_rows] distance rows for
    insertion ids start..start+B-1 (start a multiple of B), or None if
    the frontend has no batched form worth using (matrix rows are
    already resident). Pads the query source by the frontend bank's
    actual row count (which the capped chunk driver may have sliced
    below N)."""
    bank_rows = frontend_args[0].shape[0]
    # one extra block of padding: block starts are B-aligned but may
    # sit anywhere below bank_rows (the single-dispatch range rows use
    # B >> ROW_BLOCK with starts aligned to ROW_BLOCK), and
    # dynamic_slice clamps — an under-padded source would silently
    # serve shifted rows
    n_pad = -(-bank_rows // B) * B + B
    if frontend == "mash":
        from dipper_tpu.distance.mash import mash_pairwise

        (ranks_pad,) = frontend_args
        k, sketch_size = frontend_static
        qsrc = _pad_rows_to(ranks_pad, n_pad)

        def block(start):
            q = jax.lax.dynamic_slice_in_dim(qsrc, start, B, axis=0)
            return mash_pairwise(ranks_pad, q, k=k, sketch_size=sketch_size,
                                 dtype_name=dtype_name)

        return block
    if frontend == "msa":
        from dipper_tpu.distance.msa import msa_tiled_block

        codes, nongap = frontend_args
        (distance_type,) = frontend_static
        cs = _pad_rows_to(codes, n_pad)
        ngs = _pad_rows_to(nongap, n_pad)

        def block(start):
            c_b = jax.lax.dynamic_slice_in_dim(cs, start, B, axis=0)
            ng_b = jax.lax.dynamic_slice_in_dim(ngs, start, B, axis=0)
            return msa_tiled_block(
                c_b, ng_b, codes, nongap, distance_type=distance_type,
                dtype_name=dtype_name,
            )

        return block
    if frontend == "matrix":
        # rows are already resident; a "block" is just a row slice —
        # gives the matrix frontend the same epoch-scorer loop shape
        (D,) = frontend_args
        Ds = _pad_rows_to(D, n_pad)

        def block(start):
            return jax.lax.dynamic_slice_in_dim(Ds, start, B, axis=0)

        return block
    if frontend == "rows":
        # distance rows precomputed OUTSIDE the loop (run_placement_
        # chunked): R[j] is the row of insertion row0 + j. Keeps the
        # insert-range program free of distance kernels — one compile
        # serves every frontend per cap bucket, and the program is far
        # smaller (the in-loop mash/msa kernels dominated its compile).
        R, row0 = frontend_args

        def block(start):
            return jax.lax.dynamic_slice_in_dim(R, start - row0, B, axis=0)

        return block
    return None


@functools.partial(
    jax.jit,
    static_argnames=("frontend", "frontend_static", "dtype_name", "B"),
)
def _row_block(frontend_args, start, *, frontend: str, frontend_static,
               dtype_name: str, B: int):
    """One [B, bank] block of distance rows for insertions
    start..start+B-1 — the same computation the in-loop prefetch ran,
    dispatched standalone (its [256, cap] programs are small and
    persistently cached)."""
    fn = _make_block_fn(frontend_args, frontend, frontend_static,
                        dtype_name, 0, B)
    return fn(jnp.asarray(start, jnp.int32))


# ---------------------------------------------------------------------------
# Full builds
# ---------------------------------------------------------------------------


def insertion_step(st: TreeState, i, row_fn, num_sequences: int):
    row = row_fn(i)
    eid, frac, add = score_edges(st, row)
    st = splice(st, eid, frac, add, i, num_sequences)
    st = update_closest_bfs(st, i, 2 * num_sequences)
    return st


def run_placement(frontend_args, *, num_sequences: int, frontend: str,
                  frontend_static=(), dtype_name: str):
    """Builds the whole placement tree on device. Returns final edge
    arrays (e, belong, length)."""
    st = run_placement_full(
        frontend_args, num_sequences=num_sequences, frontend=frontend,
        frontend_static=frontend_static, dtype_name=dtype_name,
    )
    return st.e, st.belong, st.length


@functools.partial(
    jax.jit,
    static_argnames=("num_sequences", "frontend", "frontend_static",
                     "dtype_name", "scorer_cfg"),
)
def run_placement_full(frontend_args, *, num_sequences: int, frontend: str,
                       frontend_static=(), dtype_name: str,
                       scorer_cfg=SCORER_CFG) -> TreeState:
    """Like run_placement but returns the full TreeState (the D&C
    pipeline needs rev + witness lists for phases 2-3)."""
    N = num_sequences
    dtype = jnp.dtype(dtype_name)
    st = init_state(N, dtype)
    row_fn = _make_row_fn(frontend_args, frontend, frontend_static, dtype_name)
    row1 = row_fn(jnp.int32(1))
    st = build_initial_tree(st, row1[0].astype(dtype), N)
    st = update_closest_bfs(st, jnp.int32(0), 2 * N)
    st = update_closest_bfs(st, jnp.int32(1), 2 * N)
    return _blocked_insert_loop(
        st, 2, N, frontend_args, frontend, frontend_static, dtype_name, N,
        scorer_cfg)


def _blocked_insert_loop(st, lo, hi, frontend_args, frontend: str,
                         frontend_static, dtype_name: str, N: int,
                         scorer_cfg=SCORER_CFG):
    """fori_loop over insertions lo..hi-1 with ROW_BLOCK-row distance
    prefetch (see _make_block_fn) and the epoch witness scorer
    (see _score_edges_epoch). lo/hi may be traced (the chunked driver
    reuses one compile for every insertion range). scorer_cfg=None runs
    the direct per-insertion score_edges (the legacy path, kept for
    parity tests and as the fallback reference)."""
    B = ROW_BLOCK
    block_fn = _make_block_fn(
        frontend_args, frontend, frontend_static, dtype_name, N, B)
    if block_fn is None:
        row_fn = _make_row_fn(
            frontend_args, frontend, frontend_static, dtype_name)

        def body(i, st):
            return insertion_step(st, i, row_fn, N)

        return jax.lax.fori_loop(lo, hi, body, st)

    lo32 = jnp.asarray(lo, jnp.int32)
    blk0 = block_fn((lo32 // B) * B)

    if scorer_cfg is None:
        def body(i, carry):
            st, blk = carry
            i32 = jnp.asarray(i, jnp.int32)
            start = (i32 // B) * B
            blk = jax.lax.cond((i32 == start) & (i32 > lo32),
                               block_fn, lambda _: blk, start)
            row = jax.lax.dynamic_index_in_dim(blk, i32 - start, axis=0,
                                               keepdims=False)
            eid, frac, add = score_edges(st, row)
            st = splice(st, eid, frac, add, i, N)
            st = update_closest_bfs(st, i, 2 * N)
            return st, blk

        st, _ = jax.lax.fori_loop(lo, hi, body, (st, blk0))
        return st

    T, t1, t2 = scorer_cfg
    E = st.e.shape[0]
    T = min(T, B)
    if B % T:
        raise ValueError(f"epoch length {T} must divide ROW_BLOCK {B}")
    t1, t2 = min(t1, E), min(t2, E)

    def entry_epoch():
        off = lo32 % B
        # aligned entries slice their rows from blk0 (off is then a
        # multiple of T <= B - T, so the slice never clamps)
        rows_T = jax.lax.dynamic_slice_in_dim(blk0, off, T, axis=0)
        return _make_epoch(st, rows_T, lo32)

    ep0 = jax.lax.cond(lo32 % T == 0, entry_epoch,
                       lambda: _sentinel_epoch(st, T, lo32))

    def body(i, carry):
        st, blk, ep = carry
        i32 = jnp.asarray(i, jnp.int32)
        bstart = (i32 // B) * B
        blk = jax.lax.cond((i32 == bstart) & (i32 > lo32),
                           block_fn, lambda _: blk, bstart)
        estart = (i32 // T) * T

        def fresh(args):
            st_, blk_ = args
            rows_T = jax.lax.dynamic_slice_in_dim(
                blk_, estart - bstart, T, axis=0)
            return _make_epoch(st_, rows_T, estart)

        # the entry iteration reuses ep0 (built outside) unless it was
        # the unaligned-entry sentinel, which a fresh aligned epoch
        # must replace
        ep = jax.lax.cond((i32 == estart) & (i32 > ep.t0),
                          fresh, lambda _: ep, (st, blk))
        row = jax.lax.dynamic_index_in_dim(blk, i32 - bstart, axis=0,
                                           keepdims=False)
        eid, frac, add = _score_edges_epoch(st, row, ep, i32 - ep.t0,
                                            (t1, t2))
        st = splice(st, eid, frac, add, i, N)
        st = update_closest_bfs(st, i, 2 * N)
        return st, blk, ep

    st, _, _ = jax.lax.fori_loop(lo, hi, body, (st, blk0, ep0))
    return st


# ---------------------------------------------------------------------------
# Chunked dispatch + checkpoint/resume
#
# A whole-build fori_loop is one device dispatch; at 10^5-10^6
# insertions that is one very long execution. The chunked driver
# runs the same loop in bounded ranges (one compile, lo/hi dynamic) and
# can persist the full TreeState between ranges — giving placement the
# checkpoint/resume the reference never had (SURVEY §5: its only
# persisted artifact is the final Newick).
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("num_sequences", "frontend", "frontend_static",
                     "dtype_name"),
)
def init_placement_state(frontend_args, *, num_sequences: int, frontend: str,
                         frontend_static=(), dtype_name: str) -> TreeState:
    N = num_sequences
    dtype = jnp.dtype(dtype_name)
    row_fn = _make_row_fn(frontend_args, frontend, frontend_static, dtype_name)
    st = init_state(N, dtype)
    st = build_initial_tree(st, row_fn(jnp.int32(1))[0].astype(dtype), N)
    st = update_closest_bfs(st, jnp.int32(0), 2 * N)
    return update_closest_bfs(st, jnp.int32(1), 2 * N)


@functools.partial(
    jax.jit,
    static_argnames=("num_sequences", "frontend", "frontend_static",
                     "dtype_name", "scorer_cfg"),
)
def run_insert_range(st: TreeState, lo, hi, frontend_args, *,
                     num_sequences: int, frontend: str, frontend_static=(),
                     dtype_name: str, scorer_cfg=SCORER_CFG) -> TreeState:
    return _blocked_insert_loop(
        st, lo, hi, frontend_args, frontend, frontend_static, dtype_name,
        num_sequences, scorer_cfg)


def save_tree_state(path: str, st, next_i: int, num_sequences: int,
                    fingerprint: dict | None = None):
    """Persist a build state (any NamedTuple of arrays — TreeState here,
    exact.ExactState likewise) atomically (temp file + os.replace so a
    crash mid-write cannot destroy the previous good checkpoint) with a
    run fingerprint so a resume on mismatched inputs is refused."""
    import json
    import os
    import tempfile

    host = jax.device_get(st)
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(path)) or ".",
        suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(
                f, next_i=next_i, num_sequences=num_sequences,
                state_kind=type(st).__name__,
                fingerprint=json.dumps(fingerprint or {}, sort_keys=True),
                **{f2: np.asarray(getattr(host, f2))
                   for f2 in type(host)._fields
                   if getattr(host, f2) is not None})
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_tree_state(path: str, num_sequences: int, dtype,
                    fingerprint: dict | None = None, cls=TreeState):
    import json

    d = np.load(path)
    if int(d["num_sequences"]) != num_sequences:
        raise SystemExit(
            f"tree-state mismatch: checkpoint has N={int(d['num_sequences'])},"
            f" run wants N={num_sequences}")
    if "state_kind" in d and str(d["state_kind"]) != cls.__name__:
        raise SystemExit(
            f"tree-state mismatch: checkpoint holds {d['state_kind']}, "
            f"run wants {cls.__name__} (exact vs k-closest placement "
            "states are not interchangeable)")
    if fingerprint is not None:
        saved = json.loads(str(d["fingerprint"])) if "fingerprint" in d else {}
        want = json.loads(json.dumps(fingerprint, sort_keys=True))
        if saved != want:
            raise SystemExit(
                "tree-state mismatch: checkpoint fingerprint "
                f"{saved!r} != run fingerprint {want!r}; refusing to "
                "resume on mismatched inputs")
    optional = {"adj", "nfb"}
    missing = [f for f in cls._fields if f not in d and f not in optional]
    if missing:
        raise SystemExit(f"tree-state file is missing arrays: {missing}")
    st = cls(*(jnp.asarray(d[f]) if f in d else None for f in cls._fields))
    if cls is TreeState and st.nfb is None:
        st = st._replace(nfb=jnp.int32(0))
    if cls is TreeState and st.adj is None:
        # pre-adjacency checkpoint: rebuild the out-edge table — only
        # if out-degree <= 3 everywhere (a multifurcating backbone
        # would overflow the 3-slot rows; dense BFS handles it instead)
        bel = np.asarray(d["belong"])
        deg_ok = (np.bincount(bel[bel >= 0]).max(initial=0) <= 3
                  if (bel >= 0).any() else True)
        if deg_ok:
            st = st._replace(
                adj=adjacency_from_edges(st.belong, 2 * num_sequences))
    casts = {f: getattr(st, f).astype(dtype)
             for f in ("length", "cdis") if f in cls._fields}
    st = st._replace(**casts)
    return st, int(d["next_i"])


# --- prefix caps -----------------------------------------------------------
#
# Insertions lo..hi-1 can only ever touch edge slots < 4*hi and
# distance-bank rows < hi (node *ids* still span [0, 2N): middles are
# numbered N+i-1, so the BFS's per-node arrays keep full M=2N width —
# they are a small fraction of per-level traffic). The chunked driver
# therefore runs each range on pow2-bucketed array prefixes: the [E]
# and [E,K] tree scans and the [B, bank] distance blocks shrink from
# O(N) to O(cap), roughly halving the average per-insertion cost of a
# full build (sum of caps ~ 2N vs always-4N). Trailing slots are
# sentinel-initialized exactly like unused slots of the full arrays,
# so every chunk's math — score argmin (first-minimum), BFS masks,
# splice writes — is bitwise identical to the uncapped loop; one test
# asserts full == capped state equality.

_CAP_MIN = 2048  # below this, full-width dispatch is already trivial

# resident distance-rows buffer budget per insert range (run_placement_
# chunked rows-outside path); ranges shrink below the checkpoint chunk
# when cap * chunk rows would exceed it
_ROWS_BYTES = 3 * 2 ** 29


def _cap_for(hi: int, N: int) -> int:
    c = _CAP_MIN
    while c < hi:
        c *= 2
    return min(N, c)


def _resize_state(st: TreeState, E: int, dtype) -> TreeState:
    cur = st.e.shape[0]
    if cur == E:
        return st
    if cur > E:
        return TreeState(st.e[:E], st.belong[:E], st.length[:E],
                         st.rev[:E], st.cdis[:E], st.cid[:E], st.idx,
                         st.adj,  # adj is [2N, 3] node-indexed: uncapped
                         st.nfb)
    p = E - cur
    return TreeState(
        jnp.concatenate([st.e, jnp.full((p,), -1, jnp.int32)]),
        jnp.concatenate([st.belong, jnp.full((p,), -1, jnp.int32)]),
        jnp.concatenate([st.length, jnp.zeros((p,), dtype)]),
        jnp.concatenate([st.rev, jnp.full((p,), -1, jnp.int32)]),
        jnp.concatenate([st.cdis, jnp.full((p, K), SENT_DIS, dtype)]),
        jnp.concatenate([st.cid, jnp.full((p, K), -1, jnp.int32)]),
        st.idx,
        st.adj,
        st.nfb,
    )


def _slice_frontend(frontend_args, frontend: str, cap: int):
    if frontend == "mash":
        (ranks_pad,) = frontend_args
        return (ranks_pad[:cap],)
    if frontend == "matrix":
        (D,) = frontend_args
        return (D[:cap, :cap],)
    if frontend == "msa":
        codes, nongap = frontend_args
        return (codes[:cap], nongap[:cap])
    return frontend_args


def run_placement_chunked(frontend_args, *, num_sequences: int, frontend: str,
                          frontend_static=(), dtype_name: str,
                          chunk: int = 8192, save_state: str | None = None,
                          load_state: str | None = None,
                          fingerprint: dict | None = None,
                          use_caps: bool = True, scorer_cfg=SCORER_CFG,
                          log=None) -> TreeState:
    """Whole build via bounded dispatches; identical output to
    run_placement_full (same loop body; one compile per pow2 prefix-cap
    bucket, each reused for every range inside that bucket)."""
    import os

    N = num_sequences
    dtype = jnp.dtype(dtype_name)
    kw = dict(num_sequences=N, frontend=frontend,
              frontend_static=frontend_static, dtype_name=dtype_name)
    kw_range = dict(kw, scorer_cfg=scorer_cfg)
    fp = dict(fingerprint or {})
    fp.update(frontend=frontend, dtype=dtype_name)
    if load_state and os.path.exists(load_state):
        st, i0 = load_tree_state(load_state, N, jnp.dtype(dtype_name), fp)
        if log:
            log(f"Resumed placement at insertion {i0}/{N}")
    else:
        st = init_placement_state(frontend_args, **kw)
        i0 = 2
    import time

    # mash/msa rows are computed OUTSIDE the insert-range program and
    # fed in as a resident buffer: the insert program then contains no
    # distance kernel, so one compile serves every frontend per cap
    # bucket and the program stays small at big N. One dispatch
    # computes a whole range's rows, and the NEXT range's rows are
    # enqueued behind the current insert dispatch — the device stream
    # runs them back-to-back, so the row cost hides behind the insert
    # drain instead of adding one host round-trip per ROW_BLOCK. Matrix
    # rows are already resident — its in-loop "block" is a plain slice.
    rows_outside = frontend != "matrix"
    B = ROW_BLOCK

    def _range_of(lo):
        """(hi, lo0, cap, ce) of the insert range starting at lo; ce is
        the bucket's fixed range length (rows-buffer budget), so every
        range in a bucket reuses one [ce+B, cap] rows compile."""
        hi_ck = min(N, lo + chunk)
        cap = _cap_for(hi_ck, N) if use_caps else N
        ce = max(B, min(chunk, (_ROWS_BYTES // (dtype.itemsize * cap))
                        // B * B))
        hi = min(hi_ck, lo + ce) if rows_outside else hi_ck
        return hi, (lo // B) * B, cap, ce

    def _rows_for(lo, fa_cap, ce):
        """One dispatch for the whole range's rows [ce+B, cap] starting
        at the B-aligned row below lo."""
        return _row_block(fa_cap, jnp.int32((lo // B) * B),
                          frontend=frontend,
                          frontend_static=frontend_static,
                          dtype_name=dtype_name, B=ce + B)

    cap = None
    fa_cap = frontend_args
    R_next = None
    lo = i0
    while lo < N:
        hi, lo0, want, ce = _range_of(lo)
        hi_ck = min(N, lo + chunk)
        t0 = time.time()
        if want != cap:
            cap = want
            fa_cap = (_slice_frontend(frontend_args, frontend, cap)
                      if use_caps else frontend_args)
            st = _resize_state(st, 4 * cap, dtype)
            R_next = None  # rows computed under the old cap width
        if rows_outside:
            R = R_next if R_next is not None else _rows_for(lo, fa_cap, ce)
            t_rows = time.time() - t0
            st = run_insert_range(
                st, jnp.int32(lo), jnp.int32(hi), (R, jnp.int32(lo0)),
                num_sequences=N, frontend="rows", frontend_static=(),
                dtype_name=dtype_name, scorer_cfg=scorer_cfg)
            # prefetch the next range's rows behind the insert dispatch
            R_next = None
            if hi < N and _range_of(hi)[2] == cap:
                R_next = _rows_for(hi, fa_cap, ce)
        else:
            t_rows = 0.0
            st = run_insert_range(st, jnp.int32(lo), jnp.int32(hi),
                                  fa_cap, **kw_range)
        # wait for the range: per-range timings are real and the
        # dispatch queue stays bounded
        jax.block_until_ready(st.idx)
        if log:
            nfb = (f", {int(jax.device_get(st.nfb))} dense-BFS fallbacks"
                   if st.nfb is not None else "")
            per = (time.time() - t0) / max(hi - lo, 1) * 1e3
            rows_ms = t_rows / max(hi - lo, 1) * 1e3
            log(f"Inserted {hi}/{N} "
                f"({per:.2f} ms/insertion, rows {rows_ms:.2f}{nfb})")
        # checkpoint when a range crosses the chunk grid (ranges can be
        # shorter than `chunk` under the rows-buffer budget)
        if save_state and (hi == N or hi // chunk > lo // chunk):
            # checkpoints always hold the full [4N] layout so a resume
            # (or a different chunk size) never sees a capped shape
            save_tree_state(save_state, _resize_state(st, 4 * N, dtype),
                            hi, N, fp)
            if log:
                log(f"Checkpointed placement at insertion {hi}/{N}")
        lo = hi
    return _resize_state(st, 4 * N, dtype)


def _make_row_fn(frontend_args, frontend: str, frontend_static, dtype_name: str):
    if frontend == "matrix":
        (D,) = frontend_args
        return make_matrix_row_fn(D)
    if frontend == "mash":
        (ranks_pad,) = frontend_args
        k, sketch_size = frontend_static
        return make_mash_row_fn(ranks_pad, k, sketch_size, dtype_name)
    if frontend == "msa":
        codes, nongap = frontend_args
        (distance_type,) = frontend_static
        return make_msa_row_fn(codes, nongap, distance_type, dtype_name)
    raise ValueError(frontend)


@functools.partial(
    jax.jit,
    static_argnames=("num_sequences", "backbone_size", "frontend",
                     "frontend_static", "dtype_name", "use_adj",
                     "scorer_cfg"),
)
def run_add_queries(frontend_args, e0, belong0, length0, rev0, *,
                    num_sequences: int, backbone_size: int, frontend: str,
                    frontend_static=(), dtype_name: str, use_adj: bool = True,
                    scorer_cfg=SCORER_CFG):
    """--add: seed closest lists from the loaded backbone (BFS per
    backbone leaf, initializeDeviceArrays :241-260), then insert
    queries i = B..N-1 with the edge cursor at 4B-4 (addQuery :887).

    `use_adj=False` skips the [M,3] adjacency table and runs the dense
    BFS throughout — required for multifurcating backbones (parse_newick
    accepts them, as does the reference's linked-list adjacency,
    src/mash_placement.cuh head/nxt), whose out-degree >3 would silently
    overflow the 3-slot table. The caller checks degrees host-side."""
    N = num_sequences
    B = backbone_size
    dtype = jnp.dtype(dtype_name)
    E = 4 * N
    st = TreeState(
        e=e0, belong=belong0, length=length0.astype(dtype), rev=rev0,
        cdis=jnp.full((E, K), SENT_DIS, dtype),
        cid=jnp.full((E, K), -1, jnp.int32),
        idx=jnp.int32(4 * B - 4),
        adj=adjacency_from_edges(belong0, 2 * N) if use_adj else None,
        nfb=jnp.int32(0) if use_adj else None,
    )

    def seed(i, st):
        return update_closest_bfs(st, i, 2 * N)

    st = jax.lax.fori_loop(0, B, seed, st)
    st = _blocked_insert_loop(
        st, B, N, frontend_args, frontend, frontend_static, dtype_name, N,
        scorer_cfg)
    return st.e, st.belong, st.length


# ---------------------------------------------------------------------------
# Host-side finalization
# ---------------------------------------------------------------------------


def edges_to_newick(e, belong, length, names, num_sequences: int,
                    root: int | None = None) -> str:
    """Serialize the edge arrays (printTree recursion,
    src/placement_close_k.cu:568-643; root = node N). Adjacency
    grouping is one vectorized argsort — no per-edge Python loop (4M
    interpreter iterations at N=1M otherwise)."""
    from dipper_tpu.io.newick import edge_arrays_newick

    N = num_sequences
    if root is None:
        root = N
    return edge_arrays_newick(N, names, belong, e, length, root)

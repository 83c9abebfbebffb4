"""Divide-and-conquer pipeline (N >= 1M auto mode; -m 3).

Behavioral spec (src/divide_and_conquer/placement_close_k.cu):
- Phase 1 findBackboneTreeDC (:731-935): k-closest placement of the
  first B = N/20 taxa; middle nodes numbered placeId + N_total - 1,
  initial internal node = N_total.
- Phase 2 findClustersDC (:937-1113): for each remaining taxon, the
  best backbone attachment edge (same scoring, tree untouched) ->
  clusterID.
- Phase 3 findClusterTreeDC (:1251-1535): clusters processed in
  ascending-edge order; each starts from an edge mask {eid, otheid}
  and a leaf mask of the 10 closest witnesses of the two directions
  (initializeClusterDC :604-635); queries insert restricted to masked
  edges with distances only to masked leaves; new middle nodes numbered
  by a GLOBAL insertLeafCount (N_total + B - 1 + running index) and new
  edges by a global 4-per-insertion cursor from 4B-4; the witness BFS
  does not expand through the cluster edge's endpoints (:334).

Design: the reference runs phase 2 one query at a time and phase 3
cluster-serial with <<<1,1>>> kernels. Here:
- phase 2 is embarrassingly parallel: chunked vmap of the edge scorer
  over queries (identical backbone state for all queries);
- phase 3 exploits that clusters are independent given their id bases
  (the reference's own TBB variant proves this with prefix sums,
  dc/placement_close_k.cpp:707-760): every cluster builds in a LOCAL
  index space (nodes 0,1 = cluster edge endpoints; leaves/middles
  local; witness labels 0..9 for the initial lists, 10+k for cluster
  queries), vmapped over clusters with padding to the max cluster
  size; global ids are recovered afterwards by pure arithmetic with
  cluster-size prefix sums, reproducing the reference numbering
  exactly.
"""

from __future__ import annotations

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np

from dipper_tpu.placement import kclosest
from dipper_tpu.placement.kclosest import TreeState, K, SENT_DIS
from dipper_tpu.utils.params import Param


def _log(m):
    print(m, file=sys.stderr)


# ---------------------------------------------------------------------------
# Phase 2: cluster assignment
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("k", "sketch_size", "dtype_name",
                                             "backbone_size"))
def _phase2_chunk_mash(state: TreeState, ranks_pad, q_ids, *, k, sketch_size,
                       dtype_name, backbone_size):
    bank = ranks_pad[:backbone_size]

    from dipper_tpu.distance.mash import mash_pairwise

    rows = mash_pairwise(bank, ranks_pad[q_ids], k=k,
                         sketch_size=sketch_size, dtype_name=dtype_name)

    def one(row):
        eid, _, _ = kclosest.score_edges(state, row)
        return eid

    return jax.vmap(one)(rows)


@functools.partial(jax.jit, static_argnames=(
    "k", "sketch_size", "dtype_name", "backbone_size", "frontend",
    "chunk"))
def _phase2_all(state: TreeState, payload, q_ids, *, k, sketch_size,
                dtype_name, backbone_size, frontend, chunk):
    """ALL phase-2 cluster assignments in one dispatch: lax.map over
    `chunk`-query sub-batches of the same per-chunk computation
    (bitwise-identical rows + argmin; q_ids padded to a chunk multiple
    by the caller). One dispatch instead of ~(N-B)/chunk."""
    from dipper_tpu.distance.mash import mash_pairwise

    B = backbone_size
    nch = q_ids.shape[0] // chunk

    def one(q):
        if frontend == "mash":
            rows = mash_pairwise(payload[:B], payload[q], k=k,
                                 sketch_size=sketch_size,
                                 dtype_name=dtype_name)
        else:  # matrix
            rows = payload[q, :B]
        return jax.vmap(
            lambda r: kclosest.score_edges(state, r)[0])(rows)

    return jax.lax.map(one, q_ids.reshape(nch, chunk)).reshape(-1)


@functools.partial(jax.jit, static_argnames=("backbone_size",))
def _phase2_chunk_matrix(state: TreeState, Dm, q_ids, *, backbone_size):
    def one(q):
        row = Dm[q, :backbone_size]
        eid, _, _ = kclosest.score_edges(state, row)
        return eid

    return jax.vmap(one)(q_ids)


@functools.partial(jax.jit, static_argnames=("distance_type", "dtype_name"))
def _phase2_chunk_msa(state: TreeState, codes_backbone, nongap_backbone,
                      codes_q, nongap_q, *, distance_type, dtype_name):
    from dipper_tpu.distance.msa import msa_tiled_block

    blk = msa_tiled_block(
        codes_q, nongap_q, codes_backbone, nongap_backbone,
        distance_type=distance_type, dtype_name=dtype_name,
    )  # [chunk, B]

    def one(row):
        eid, _, _ = kclosest.score_edges(state, row)
        return eid

    return jax.vmap(one)(blk)


# ---------------------------------------------------------------------------
# Phase 3: local cluster builds
# ---------------------------------------------------------------------------


def _mask_order_perm(cmax: int) -> np.ndarray:
    """Mask-scan order -> local edge id. Positions: 0 -> edge 0 (eid),
    1 -> edge 1 (otheid), then per insertion g: idx-1, idx-2, idx-3,
    idx-4 == local edges 5+4g, 4+4g, 3+4g, 2+4g
    (updateClusterInfoDC :567-569)."""
    perm = np.zeros(2 + 4 * cmax, dtype=np.int32)
    perm[0] = 0
    perm[1] = 1
    for g in range(cmax):
        base = 2 + 4 * g
        perm[2 + 4 * g : 6 + 4 * g] = [base + 3, base + 2, base + 1, base]
    return perm


def _new_group_scoreable() -> np.ndarray:
    """belong>e in GLOBAL numbering for the 4 edges of an insertion:
    middles exceed every prior id, so i0 (middle->x), i1 (middle->y),
    i3 (middle->outside) are scoreable and i2 (outside->middle) is not."""
    return np.array([True, True, False, True])


def _cluster_init_state(cd_init, cid_init, lens_init, cmax: int, dtype,
                        with_adj: bool) -> TreeState:
    """Initial local cluster tree: nodes 0,1 = cluster-edge endpoints,
    edges 0/1 the two directions. `with_adj` states run the
    frontier-compact witness BFS (the per-cluster streaming path);
    adj-less states run the dense BFS (required under vmap)."""
    E = 2 + 4 * cmax
    Mn = 2 + 2 * cmax
    adj = None
    if with_adj:
        adj = jnp.full((Mn, 3), -1, jnp.int32) \
            .at[0, 0].set(0).at[1, 0].set(1)
    return TreeState(
        e=jnp.full((E,), -1, jnp.int32).at[0].set(1).at[1].set(0),
        belong=jnp.full((E,), -1, jnp.int32).at[0].set(0).at[1].set(1),
        length=jnp.zeros((E,), dtype).at[0].set(lens_init[0]).at[1].set(lens_init[1]),
        cdis=jnp.full((E, K), SENT_DIS, dtype).at[0].set(cd_init[0]).at[1].set(cd_init[1]),
        cid=jnp.full((E, K), -1, jnp.int32).at[0].set(cid_init[0]).at[1].set(cid_init[1]),
        rev=jnp.full((E,), -1, jnp.int32).at[0].set(1).at[1].set(0),
        idx=jnp.int32(2),
        adj=adj,
    )


def _cluster_step(kq, row, st, scoreable, perm, pos_group, grp, cmax: int,
                  dtype):
    """One query insertion of the local cluster build: masked-edge
    scoring (calculateBranchLengthSpecialIDDC :180-234), splice, witness
    BFS with endpoint blocking (updateClosestNodesInClusterDC :312-356)."""
    Mn = 2 + 2 * cmax
    # per-edge score in natural local order
    ids = jnp.maximum(st.cid, 0)
    dv = jnp.where(st.cid != -1, row[ids] - st.cdis, -jnp.inf)
    side = jnp.maximum(jnp.max(dv, axis=1), 0.0)
    dis1 = side
    dis2 = side[jnp.maximum(st.rev, 0)]
    L = st.length
    addi = jnp.maximum((dis1 + dis2 - L) * 0.5, 0.0)
    dis1 = jnp.maximum(dis1 - addi, 0.0)
    dis2 = jnp.maximum(dis2 - addi, 0.0)
    addi = addi + jnp.maximum(dis1 - L, 0.0) + jnp.maximum(dis2 - L, 0.0)
    dis1 = jnp.minimum(dis1, L)
    rest = L - dis1 - jnp.minimum(dis2, L)
    dis1 = dis1 + rest * 0.5
    # permute to mask order; a group's edges become scoreable only
    # after its insertion (g < kq); positions 0/1 always exist
    valid_pos = scoreable[perm] & ((pos_group < kq) | (pos_group < 0))
    score_m = jnp.where(valid_pos, addi[perm], jnp.asarray(SENT_DIS, dtype))
    frac_m = jnp.where(valid_pos, dis1[perm], 0.0)
    pos = jnp.argmin(score_m).astype(jnp.int32)
    eid = perm[pos]
    frac = frac_m[pos]
    add = score_m[pos]
    middle = 2 + cmax + kq
    outside = 2 + kq
    ye = st.rev[eid]
    st = kclosest.splice(st, eid, frac, add, outside, 0,
                         middle=middle, outside=outside)
    base = 2 + 4 * kq
    scoreable = scoreable.at[eid].set(False).at[ye].set(False)
    scoreable = jax.lax.dynamic_update_slice(scoreable, grp, (base,))
    # endpoint block: the reference reads e[cluster_eid] /
    # belong[cluster_eid] at BFS-launch time (:329) — after the
    # first splice onto the cluster edge that's (x, first middle),
    # not the original endpoints. Slot 0 is the cluster edge.
    st = kclosest.update_closest_bfs(
        st, outside, Mn, label=10 + kq,
        blocked_nodes=(st.belong[0], st.e[0]),
    )
    return st, scoreable


@functools.partial(jax.jit, static_argnames=("cmax", "dtype_name"))
def _cluster_build(Dq, cd_init, cid_init, lens_init, sz, *, cmax: int,
                   dtype_name: str):
    """One cluster's local build. Dq [cmax, 10+cmax] distances (query k
    vs witness w); cd_init/cid_init [2, K] remapped witness lists of the
    two cluster-edge directions; lens_init [2]; sz = real member count.
    Returns local (e, belong, length) with E = 2+4cmax slots."""
    dtype = jnp.dtype(dtype_name)
    st = _cluster_init_state(cd_init, cid_init, lens_init, cmax, dtype,
                             with_adj=False)
    perm = jnp.asarray(_mask_order_perm(cmax))
    pos_group = jnp.concatenate(
        [jnp.array([-1, -1], jnp.int32),
         jnp.repeat(jnp.arange(cmax, dtype=jnp.int32), 4)]
    )
    # dynamic belong>e flags in GLOBAL id terms: the cluster-edge
    # direction starts scoreable; a splice makes both halves of the
    # split edge point at the new middle (largest id) -> unscoreable
    scoreable0 = jnp.zeros((2 + 4 * cmax,), jnp.bool_).at[0].set(True)
    grp = jnp.asarray(_new_group_scoreable())

    def body(kq, carry):
        st, scoreable = carry
        return _cluster_step(kq, Dq[kq], st, scoreable, perm, pos_group,
                             grp, cmax, dtype)

    def masked_body(kq, carry):
        return jax.lax.cond(kq < sz, lambda c: body(kq, c), lambda c: c, carry)

    st, _ = jax.lax.fori_loop(0, cmax, masked_body, (st, scoreable0))
    return st.e, st.belong, st.length


# Row block of the streaming big-cluster build (distance rows computed
# on demand instead of a [cmax, W] precompute).
_STREAM_ROW_BLOCK = 256


def _stream_range_run(block_fn, st, scoreable, sz, lo, hi,
                      cmax: int, dtype, Bb: int):
    """Insertions [lo, hi) of a huge-cluster build with STREAMED
    distance rows.

    The vmapped/per-cluster paths precompute Dq [cmax, W~cmax] — a
    quadratic tensor (~10 GB in f32 for one 50K-query cluster). The
    reference never holds this: it computes each query's row against
    the masked leaf list on the fly (distSpecialIDConstructionOnGpuDC
    :559-601, msa.cu:269-435 for aligned input). This loop is the equivalent here — `block_fn(start)`
    yields [Bb, W] rows for queries start..start+Bb-1 inside the
    insertion fori_loop — and the state carries an adjacency table so
    the witness BFS is frontier-compact (O(frontier) per level).

    Range-chunked (lo/hi are traced scalars; one compile serves every
    range): the identical body split into bounded ranges with the
    (state, scoreable) carry shuttled between dispatches is
    bitwise-identical, and _STREAM_STEP bounds one dispatch's size.
    Callers align lo to Bb multiples."""
    perm = jnp.asarray(_mask_order_perm(cmax))
    pos_group = jnp.concatenate(
        [jnp.array([-1, -1], jnp.int32),
         jnp.repeat(jnp.arange(cmax, dtype=jnp.int32), 4)]
    )
    grp = jnp.asarray(_new_group_scoreable())

    def body(kq, carry):
        st, scoreable, blk = carry
        kq32 = jnp.asarray(kq, jnp.int32)
        start = (kq32 // Bb) * Bb
        # block starts recompute blk; kq == lo reuses the entry block
        # computed below instead of re-dispatching the identical slice
        blk = jax.lax.cond((kq32 == start) & (kq32 > lo),
                           block_fn, lambda _: blk, start)
        row = jax.lax.dynamic_index_in_dim(blk, kq32 - start, axis=0,
                                           keepdims=False)
        st, scoreable = _cluster_step(kq, row, st, scoreable, perm,
                                      pos_group, grp, cmax, dtype)
        return st, scoreable, blk

    def masked_body(kq, carry):
        return jax.lax.cond(kq < sz, lambda c: body(kq, c), lambda c: c,
                            carry)

    lo = jnp.asarray(lo, jnp.int32)
    blk0 = block_fn((lo // Bb) * Bb)
    st, scoreable, _ = jax.lax.fori_loop(lo, hi, masked_body,
                                         (st, scoreable, blk0))
    return st, scoreable


def _pad_block_multiple(x, Bb: int):
    """Pad axis 0 to a multiple of Bb by repeating the last row:
    dynamic_slice CLAMPS out-of-range starts, so an unpadded tail block
    would silently serve shifted rows (observed at cmax=34, Bb=4:
    block start 32 clamped to 30 fed queries 30/31 in place of 32/33)."""
    pad = (-x.shape[0]) % Bb
    if pad:
        x = jnp.concatenate(
            [x, jnp.broadcast_to(x[-1:], (pad,) + x.shape[1:])], axis=0)
    return x


@functools.partial(jax.jit, static_argnames=("cmax", "dtype_name", "kmer",
                                             "sketch_size", "row_block"))
def _cluster_range_stream_mash(ranks, wit_ids, mem_ids, st, scoreable,
                               sz, lo, hi, *, cmax: int, dtype_name: str,
                               kmer: int, sketch_size: int,
                               row_block: int = _STREAM_ROW_BLOCK):
    """Streamed mash cluster build (one insertion range): rows from the
    rank bank through the same integer-intersection kernel +
    _inter_to_dist LUT as the batch paths, so distances are bitwise
    identical to the precomputed Dq."""
    from dipper_tpu.distance.mash import _inter_to_dist, mash_pairwise_inter

    dtype = jnp.dtype(dtype_name)
    bank = ranks[wit_ids]        # [W, M] witness sketches
    qsrc = _pad_block_multiple(ranks[mem_ids], min(row_block, cmax))
    Bb = min(row_block, cmax)

    def block_fn(start):
        q = jax.lax.dynamic_slice_in_dim(qsrc, start, Bb, axis=0)
        inter = mash_pairwise_inter(bank, q, sketch_size=sketch_size)
        return _inter_to_dist(inter, kmer, sketch_size, dtype)  # [Bb, W]

    return _stream_range_run(block_fn, st, scoreable, sz, lo, hi,
                             cmax, dtype, Bb)


@functools.partial(jax.jit, static_argnames=("cmax", "dtype_name",
                                             "distance_type", "row_block"))
def _cluster_range_stream_msa(codes_w, ng_w, codes_m, ng_m, st, scoreable,
                              sz, lo, hi, *, cmax: int,
                              dtype_name: str, distance_type: int,
                              row_block: int = _STREAM_ROW_BLOCK):
    """Streamed MSA cluster build (one insertion range): witness codes
    stay packed [W, L] bytes on device; each query block one-hot
    expands on the fly inside msa_tiled_block (reference streams
    SpecialID distances likewise, dc/msa.cu:269-435). Peak transient is
    [tile, 5, L] int8 instead of the quadratic [cmax, W, 5, L] staging
    of the batch path."""
    from dipper_tpu.distance.msa import msa_tiled_block

    dtype = jnp.dtype(dtype_name)
    Bb = min(row_block, cmax)
    codes_m = _pad_block_multiple(codes_m, Bb)
    ng_m = _pad_block_multiple(ng_m, Bb)

    def block_fn(start):
        cq = jax.lax.dynamic_slice_in_dim(codes_m, start, Bb, axis=0)
        nq = jax.lax.dynamic_slice_in_dim(ng_m, start, Bb, axis=0)
        return msa_tiled_block(cq, nq, codes_w, ng_w,
                               distance_type=distance_type,
                               dtype_name=dtype_name)  # [Bb, W]

    return _stream_range_run(block_fn, st, scoreable, sz, lo, hi,
                             cmax, dtype, Bb)


@functools.partial(jax.jit, static_argnames=("cmax", "dtype_name",
                                             "row_block"))
def _cluster_range_stream_matrix(Dm, wit_ids, mem_ids, st, scoreable,
                                 sz, lo, hi, *, cmax: int,
                                 dtype_name: str,
                                 row_block: int = _STREAM_ROW_BLOCK):
    """Streamed matrix cluster build (one insertion range): rows
    gathered from the resident matrix — bitwise identical to the batch
    path's Dm[mem][:, wit]."""
    dtype = jnp.dtype(dtype_name)
    Bb = min(row_block, cmax)
    mem_pad = _pad_block_multiple(mem_ids, Bb)

    def block_fn(start):
        mids = jax.lax.dynamic_slice_in_dim(mem_pad, start, Bb, axis=0)
        return Dm[mids][:, wit_ids].astype(dtype)  # [Bb, W]

    return _stream_range_run(block_fn, st, scoreable, sz, lo, hi,
                             cmax, dtype, Bb)


# Insertions per streamed-build dispatch: bounds one dispatch's size.
# Must be a multiple of every possible row block.
_STREAM_STEP = 2048


def _cluster_build_stream(frontend, params: Param, dtype_name, payloads,
                          cd_init, cid_init, lens_init, sz_i, *,
                          cmax: int, step: int = 0):
    """Host driver for one huge-cluster streamed build: bounded
    insertion-range dispatches with the (state, scoreable) carry left
    on device between them. One compile per (frontend, cmax) serves
    every range. Returns (e, belong, length) device arrays."""
    dtype = jnp.dtype(dtype_name)
    st = _cluster_init_state(cd_init, cid_init, lens_init, cmax, dtype,
                             with_adj=True)
    scoreable = jnp.zeros((2 + 4 * cmax,), jnp.bool_).at[0].set(True)
    step = step or _STREAM_STEP
    sz = jnp.asarray(sz_i, jnp.int32)
    n = max(int(sz_i), 1)  # iterations beyond sz are masked no-ops
    kw = dict(cmax=cmax, dtype_name=dtype_name,
              row_block=_STREAM_ROW_BLOCK)
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        if frontend == "mash":
            st, scoreable = _cluster_range_stream_mash(
                *payloads, st, scoreable, sz, jnp.int32(lo),
                jnp.int32(hi), kmer=params.kmer_size,
                sketch_size=params.sketch_size, **kw)
        elif frontend == "msa":
            st, scoreable = _cluster_range_stream_msa(
                *payloads, st, scoreable, sz, jnp.int32(lo),
                jnp.int32(hi), distance_type=params.distance_type, **kw)
        else:
            st, scoreable = _cluster_range_stream_matrix(
                *payloads, st, scoreable, sz, jnp.int32(lo),
                jnp.int32(hi), **kw)
    return st.e, st.belong, st.length


@functools.lru_cache(maxsize=None)
def _cluster_build_vmapped(cmax: int, dtype_name: str):
    fn = lambda Dq, cd, cid, ln, sz: _cluster_build(
        Dq, cd, cid, ln, sz, cmax=cmax, dtype_name=dtype_name)
    return jax.jit(jax.vmap(fn, in_axes=(0, 0, 0, 0, 0)))


@functools.partial(jax.jit, static_argnames=(
    "cmax", "dtype_name", "frontend", "kmer", "sketch_size", "c_in"))
def _bucket_build_batch(payload, wit, mem, cd, cid, lens, sz, *,
                        cmax: int, dtype_name: str, frontend: str,
                        kmer: int, sketch_size: int, c_in: int):
    """A WHOLE size-bucket of cluster builds in one dispatch: a lax.map
    over sub-batches of c_in clusters, each sub-batch running the same
    distances + vmapped build the per-chunk path dispatched separately.
    Peak memory equals one sub-batch (c_in plays _phase3_cchunk's
    role), but phase 3 becomes ~one dispatch per bucket. Distances are
    bitwise identical to the chunked path (integer intersection counts
    + the shared LUT conversion; matrix rows are exact gathers).

    payload: mash -> the [*, M] rank bank; matrix -> the [N, N] matrix.
    (msa stays on the per-chunk host-staging path — its bank lives on
    the host.) Cluster count must be padded to a multiple of c_in
    (pad clusters carry sz=0 and are skipped by the build's mask)."""
    from dipper_tpu.distance.mash import (_inter_to_dist,
                                          mash_pairwise_inter)

    dtype = jnp.dtype(dtype_name)
    C = wit.shape[0]
    nch = C // c_in

    def one(args):
        w, m, cdc, cidc, lc, sc = args
        if frontend == "mash":
            inter = jax.vmap(
                lambda wi, mi: mash_pairwise_inter(
                    payload[wi], payload[mi], sketch_size=sketch_size))(w, m)
            Dq = _inter_to_dist(inter, kmer, sketch_size, dtype)
        else:  # matrix
            Dq = jax.vmap(lambda wi, mi: payload[mi][:, wi])(w, m)
        return jax.vmap(
            lambda a, b, c, d, e: _cluster_build(
                a, b, c, d, e, cmax=cmax, dtype_name=dtype_name)
        )(Dq, cdc, cidc, lc, sc)

    parts = tuple(x.reshape((nch, c_in) + x.shape[1:])
                  for x in (wit, mem, cd, cid, lens, sz))
    le, lb, ll = jax.lax.map(one, parts)
    return (le.reshape((C,) + le.shape[2:]),
            lb.reshape((C,) + lb.shape[2:]),
            ll.reshape((C,) + ll.shape[2:]))


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

# Queries per phase-2 dispatch and distance-element budget per phase-3
# cluster-build dispatch (tests shrink these to force the multi-chunk
# paths at small N).
PHASE2_CHUNK = 4096
PHASE3_BUDGET = 4096
# Per-dispatch pair budget for phase 2 (queries * backbone): bounds one
# dispatch's size. Macro-batches are submitted back-to-back without
# host syncs (results gathered at the end); one compile serves every
# macro-batch.
PHASE2_MACRO_PAIRS = 1 << 30
# Largest backbone for which phase 2 runs as the whole-phase lax.map
# program; above it, per-chunk async dispatches. Bounds one dispatch's
# size (ROADMAP D2 asks whether it is still needed).
PHASE2_MAP_MAX_B = 5000
# Largest N for which phase 3 runs each size bucket as one lax.map
# program (_bucket_build_batch); above it, per-chunk dispatches. Bounds
# one dispatch's size (ROADMAP D2).
PHASE3_BATCH_MAX_N = 150_000


def build_dc_tree_from_matrix(D, names, params: Param, mesh=None) -> str:
    """D&C from a precomputed distance matrix (an extension over the
    reference, which rejects matrix input in DC mode; also the bitwise
    test harness: oracle and engine consume identical doubles)."""
    return build_dc_tree(None, names, params, matrix=D, mesh=mesh)


def _shard_batch(mesh, fn, *batched):
    """Run fn (whose args are all batched on axis 0) with the batch
    axis sharded across the mesh — the data-parallel analog for DC
    phases 2/3 (each query/cluster is independent; the reference's TBB
    prefix-sum determinism proves order-independence). Pads the batch
    to a multiple of the mesh size; callers slice the pad off."""
    import functools as _ft

    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    nd = mesh.devices.size
    n = batched[0].shape[0]
    pad = (-n) % nd
    if pad:
        batched = tuple(
            jnp.concatenate([b, jnp.repeat(b[-1:], pad, axis=0)], axis=0)
            for b in batched)

    specs = tuple(P("d") for _ in batched)

    @_ft.partial(shard_map, mesh=mesh, in_specs=specs,
                 out_specs=P("d"), check_vma=False)
    def run(*local):
        return fn(*local)

    out = run(*batched)
    if isinstance(out, tuple):
        return tuple(o[:n] for o in out)
    return out[:n]


def build_dc_tree(seqs, names, params: Param, matrix=None, mesh=None) -> str:
    N = len(names)
    B = params.backbone_size
    if B < 4:
        raise SystemExit("backbone too small for divide-and-conquer")
    dtype_name = str(jnp.dtype(params.dtype))
    dtype = jnp.dtype(dtype_name)

    # ---- frontend prep
    if matrix is not None:
        Dm = jnp.asarray(matrix, dtype)
        backbone_args = (((Dm[:B, :B]),), ())
        frontend = "matrix"
    elif params.in_format == "r":
        from dipper_tpu.sketch.bank import get_sketch_bank
        from dipper_tpu.distance.mash import rank_compress_host, pad_ranks

        sk = get_sketch_bank(seqs, params)
        # host rank compression (order/equality-identical to the device
        # sort; avoids its compile blowup at bank scale) then one H2D
        # push of the HBM-resident int32 rank bank
        ranks = jax.device_put(pad_ranks(rank_compress_host(np.asarray(sk))))
        backbone_args = ((ranks[:B],), (params.kmer_size, params.sketch_size))
        frontend = "mash"
    elif params.in_format == "m":
        # host-bank streaming (reference pattern: dc/msa.cu keeps the
        # full 4-bit matrix host-side and stages batches): only the
        # backbone codes live on device permanently ([B, L] bytes;
        # one-hot channels expand per tile inside the jits); query
        # chunks and per-cluster gathers upload on demand.
        from dipper_tpu.io.encode import batch_codes, encode_4bit_codes

        codes_host, _ = batch_codes(seqs, encode_4bit_codes, pad_value=4)
        nongap_host = (codes_host < 4).sum(axis=1)
        codes_bb = jnp.asarray(codes_host[:B])
        nongap_bb = jnp.asarray(nongap_host[:B], dtype)
        backbone_args = ((codes_bb, nongap_bb), (params.distance_type,))
        frontend = "msa"
    else:
        raise SystemExit(
            "Error: Input type must be unaligned or aligned for "
            "clustering based approach")

    import time as _time

    # ---- Phase 1: backbone (local id space, remapped at assembly)
    _log("DC phase 1: backbone placement")
    _t = _time.time()
    if B >= 8192:
        # large backbones (N/20 at the reference's >=1M DC band) run
        # the chunked driver: bounded dispatches, small frontend-free
        # insert programs, prefix caps, and checkpoint/resume via
        # params.save/load_state
        state = kclosest.run_placement_chunked(
            backbone_args[0], num_sequences=B, frontend=frontend,
            frontend_static=backbone_args[1], dtype_name=dtype_name,
            chunk=params.state_chunk or 8192,
            save_state=params.save_state, load_state=params.load_state,
            fingerprint={"dc_backbone": B}, log=_log,
        )
    else:
        state = kclosest.run_placement_full(
            backbone_args[0], num_sequences=B, frontend=frontend,
            frontend_static=backbone_args[1], dtype_name=dtype_name,
        )
    jax.block_until_ready(state.e)
    _log(f"DC phase 1 in: {int((_time.time() - _t) * 1000)} ms")
    _t = _time.time()

    # ---- Phase 2: cluster assignment
    # Chunked but ASYNC: dispatches queue on the device (device_put /
    # jit calls don't block) and results land in one gather at the end,
    # so the phase costs ~(N-B)/PHASE2_CHUNK dispatches with no
    # per-chunk host round-trip (VERDICT r2 #8: the old 256-query
    # synchronous chunks meant ~3700 blocking syncs at N=1M).
    _log("DC phase 2: cluster assignment")
    cluster_id = np.empty(N, dtype=np.int64)
    chunk = min(PHASE2_CHUNK, N - B)
    if (frontend in ("mash", "matrix") and mesh is None
            and B <= PHASE2_MAP_MAX_B):
        # whole-phase lax.map dispatches over chunk-sized sub-batches,
        # macro-batched to a bounded per-dispatch pair budget and
        # submitted async (one gather at the end) — bitwise-identical
        # assignments regardless of the macro split
        nq = N - B
        padq = (-nq) % chunk
        q_ids = np.arange(B, N, dtype=np.int64)
        if padq:
            q_ids = np.concatenate(
                [q_ids, np.full(padq, N - 1, np.int64)])
        npad = len(q_ids)
        macro = max(chunk, min(npad,
                               PHASE2_MACRO_PAIRS // max(B, 1)
                               // chunk * chunk))
        payload = ranks if frontend == "mash" else Dm
        pend2: list = []
        s = 0
        while s < npad:
            s0 = min(s, npad - macro)  # full-size macro; tail overlaps
            eids = _phase2_all(
                state, payload, jnp.asarray(q_ids[s0:s0 + macro]),
                k=params.kmer_size, sketch_size=params.sketch_size,
                dtype_name=dtype_name, backbone_size=B,
                frontend=frontend, chunk=chunk)
            pend2.append((s0, eids))
            s = s0 + macro
        full = np.empty(npad, dtype=np.int64)
        for s0, eids in pend2:
            full[s0:s0 + macro] = np.asarray(jax.device_get(eids))
        cluster_id[B:N] = full[:nq]
    else:
        pend: list = []
        for s in range(B, N, chunk):
            # full-size chunks only (recompute overlap at the tail):
            # one compile for the whole phase
            s0 = min(s, N - chunk)
            qe = s0 + chunk
            q_ids = jnp.arange(s0, qe)
            if frontend == "matrix":
                fn = lambda q: _phase2_chunk_matrix(state, Dm, q,
                                                    backbone_size=B)
                batched = (q_ids,)
            elif frontend == "mash":
                fn = lambda q: _phase2_chunk_mash(
                    state, ranks, q, k=params.kmer_size,
                    sketch_size=params.sketch_size, dtype_name=dtype_name,
                    backbone_size=B,
                )
                batched = (q_ids,)
            else:
                fn = lambda cq, nq: _phase2_chunk_msa(
                    state, codes_bb, nongap_bb, cq, nq,
                    distance_type=params.distance_type,
                    dtype_name=dtype_name,
                )
                batched = (jnp.asarray(codes_host[s0:qe]),  # host staging
                           jnp.asarray(nongap_host[s0:qe], dtype))
            if mesh is not None:
                eids = _shard_batch(mesh, fn, *batched)
            else:
                eids = fn(*batched)
            pend.append((s0, qe, eids))
        for s0, qe, eids in pend:
            cluster_id[s0:qe] = np.asarray(jax.device_get(eids))
    import hashlib as _hl
    _log(f"DC phase 2 in: {int((_time.time() - _t) * 1000)} ms "
         f"[assign {_hl.md5(cluster_id[B:N].tobytes()).hexdigest()[:10]}]")
    _t = _time.time()

    # ---- Phase 3: per-cluster local builds
    # All prep/assembly is vectorized NumPy (VERDICT r2 #8: the old
    # per-edge/per-cluster Python loops were O(N) interpreter work; the
    # reference assembles device-side, dc/placement_close_k.cu:1251+).
    _log("DC phase 3: cluster trees")
    qcid = cluster_id[B:N]
    order = np.argsort(qcid, kind="stable")
    sorted_q = np.arange(B, N, dtype=np.int64)[order]
    sorted_c = qcid[order]
    cluster_eids, starts, sizes = np.unique(
        sorted_c, return_index=True, return_counts=True)
    prefix = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    cmax = int(sizes.max()) if len(sizes) else 0

    e_h = np.asarray(jax.device_get(state.e))
    belong_h = np.asarray(jax.device_get(state.belong))
    len_h = np.asarray(jax.device_get(state.length), dtype=np.float64)
    rev_h = np.asarray(jax.device_get(state.rev))
    cid_h = np.asarray(jax.device_get(state.cid))
    cd_h = np.asarray(jax.device_get(state.cdis), dtype=np.float64)

    # remap backbone-local node ids to FINAL global ids up front:
    # leaf v < B stays; internal v in [B, 2B-2] -> N + (v - B)
    # (reference: initial node N_total, middles placeId + N_total - 1)
    def bb_final_vec(v):
        v = np.asarray(v, np.int64)
        return np.where(v < 0, -1, np.where(v < B, v, N + (v - B)))

    # global output arrays (edge-id space of the full tree)
    E_glob = 4 * N
    g_e = np.full(E_glob, -1, np.int64)
    g_belong = np.full(E_glob, -1, np.int64)
    g_len = np.zeros(E_glob, np.float64)
    nb_used = 4 * B - 4
    g_e[:nb_used] = bb_final_vec(e_h[:nb_used])
    g_belong[:nb_used] = bb_final_vec(belong_h[:nb_used])
    g_len[:nb_used] = len_h[:nb_used]

    if cmax > 0:
        nclusters = len(cluster_eids)
        oths = rev_h[cluster_eids]
        pair = np.stack([cluster_eids, oths], axis=1)         # [C, 2]
        gid = cid_h[pair].astype(np.int64)                    # [C, 2, K]
        slot = (np.arange(2)[None, :, None] * K
                + np.arange(K)[None, None, :])
        cid_init = np.where(gid != -1, slot, -1)
        cd_init = cd_h[pair]
        lens_init = len_h[pair]
        wit_head = np.maximum(gid, 0).reshape(nclusters, 2 * K)

        # Cluster sizes at scale are heavy-tailed (a few backbone edges
        # attract thousands of queries while the median is ~N/B-ish);
        # padding every cluster to the global max would size the
        # vmapped distance intermediate by the largest one. Clusters
        # are therefore processed in pow2 SIZE BUCKETS, each at its own
        # cmax_b; members/witness matrices are built per bucket (a
        # global [C, cmax] staging is itself GBs of host memory when
        # one cluster dominates), clusters wider than
        # _STREAM_CLUSTER_MIN run the streaming build (no [cmax, W]
        # distance precompute at all), and every bucket assembles its
        # global ids immediately.
        if frontend == "matrix":
            payload = Dm
        elif frontend == "mash":
            payload = ranks
        else:
            payload = (codes_host, nongap_host)

        x_f = bb_final_vec(belong_h[cluster_eids])
        y_f = bb_final_vec(e_h[cluster_eids])

        def assemble(rr, le, lb, ll, cmax_b, members_b):
            """Map bucket-local (e, belong, length) [c, 2+4*cmax_b] of
            clusters `rr` to FINAL global ids and write them into the
            global arrays. middle k of cluster ci -> N + B - 1 + p_c + k
            (reference: insertLeafCount + N_total - 1 with
            insertLeafCount = B + t)."""
            le = np.asarray(le)
            lb = np.asarray(lb)
            ll = np.asarray(ll, dtype=np.float64)

            def node_map(V):
                V = V.astype(np.int64)
                leaf = members_b[np.arange(len(rr))[:, None],
                                 np.clip(V - 2, 0, cmax_b - 1)]
                mid = N + B - 1 + prefix[rr][:, None] + (V - 2 - cmax_b)
                return np.where(V >= 2 + cmax_b, mid,
                                np.where(V >= 2, leaf,
                                         np.where(V == 1, y_f[rr][:, None],
                                                  x_f[rr][:, None])))

            map_e = node_map(le)
            map_b = node_map(lb)
            # overwrite the cluster edge's two slots
            g_e[pair[rr]] = map_e[:, :2]
            g_belong[pair[rr]] = map_b[:, :2]
            g_len[pair[rr]] = ll[:, :2]
            # insertion groups: global slot nb_used + 4*(p_c+g) + m for
            # the local slot 2 + 4g + m, valid while g < size[ci]
            span = np.arange(4 * cmax_b, dtype=np.int64)[None, :]
            gslots = nb_used + 4 * prefix[rr][:, None] + span
            valid = span < 4 * sizes[rr][:, None]
            g_e[gslots[valid]] = map_e[:, 2:][valid]
            g_belong[gslots[valid]] = map_b[:, 2:][valid]
            g_len[gslots[valid]] = ll[:, 2:][valid]

        corder = np.argsort(sizes, kind="stable")
        szs = sizes[corder]
        _log(f"DC phase 3: {nclusters} clusters, size p50="
             f"{int(np.median(sizes))} p99={int(np.quantile(sizes, .99))} "
             f"max={cmax}")
        # DIPPER_DC_PROFILE=1 makes every dispatch synchronous and adds
        # a sync after each distance precompute so the per-bucket
        # dist/build/assemble split is real (costs pipelining; off by
        # default). The default path is fully ASYNC — phase 2's
        # pattern: all dispatch chains enqueue with no device_get in
        # the loop, results land in one fetch pass at the end.
        import os as _os
        _profile = bool(int(_os.environ.get("DIPPER_DC_PROFILE", "0")))
        pend3: list = []
        b0 = 0
        while b0 < nclusters:
            cmax_b = 8
            while cmax_b < szs[b0]:
                cmax_b *= 2
            cmax_b = min(cmax_b, cmax)
            b1 = int(np.searchsorted(szs, cmax_b, side="right")) \
                if cmax_b < cmax else nclusters
            rows = corder[b0:b1]
            b0 = b1
            # member matrix: row = queries in encounter order, padded
            # by repeating (pads masked by `sz` inside the build)
            colj = np.arange(cmax_b, dtype=np.int64)[None, :]
            take = starts[rows][:, None] \
                + np.minimum(colj, sizes[rows][:, None] - 1)
            mem_b = sorted_q[take]                         # [c, cmax_b]
            wit_b = np.concatenate([wit_head[rows], mem_b], axis=1)
            stream = cmax_b >= _STREAM_CLUSTER_MIN
            _tb = _time.time()
            _ndisp = 0
            _t_dist = _t_asm = 0.0

            if stream:
                # huge clusters one at a time, rows streamed in-loop,
                # range-chunked into bounded dispatches
                for j, ci in enumerate(rows):
                    init = (jnp.asarray(cd_init[ci], dtype),
                            jnp.asarray(cid_init[ci], jnp.int32),
                            jnp.asarray(lens_init[ci], dtype))
                    if frontend == "mash":
                        payloads = (ranks, jnp.asarray(wit_b[j]),
                                    jnp.asarray(mem_b[j]))
                    elif frontend == "msa":
                        payloads = (
                            jnp.asarray(codes_host[wit_b[j]]),
                            jnp.asarray(nongap_host[wit_b[j]], dtype),
                            jnp.asarray(codes_host[mem_b[j]]),
                            jnp.asarray(nongap_host[mem_b[j]], dtype))
                    else:
                        payloads = (Dm, jnp.asarray(wit_b[j]),
                                    jnp.asarray(mem_b[j]))
                    le, lb, ll = _cluster_build_stream(
                        frontend, params, dtype_name, payloads, *init,
                        int(sizes[ci]), cmax=cmax_b)
                    _ndisp += -(-int(sizes[ci]) // _STREAM_STEP)
                    if _profile:
                        _ta = _time.time()
                        assemble(np.array([ci]), jax.device_get(le)[None],
                                 jax.device_get(lb)[None],
                                 jax.device_get(ll)[None], cmax_b,
                                 mem_b[j][None])
                        _t_asm += _time.time() - _ta
                    else:
                        pend3.append((np.array([ci]), le, lb, ll,
                                      cmax_b, mem_b[j][None]))
                        if len(pend3) % 48 == 0:  # bounded-queue pacing
                            np.asarray(jax.device_get(le[:1]))
            elif (frontend != "msa" and not _profile and mesh is None
                  and N <= PHASE3_BATCH_MAX_N):
                # mash/matrix: the WHOLE bucket in one dispatch (see
                # _bucket_build_batch) — distances + builds lax.map'd
                # over c_in-sized sub-batches inside the jit
                c_in = min(_phase3_cchunk(cmax_b), len(rows))
                pad = (-len(rows)) % c_in
                def padc(x):
                    if pad == 0:
                        return x
                    return np.concatenate(
                        [x, np.repeat(x[-1:], pad, axis=0)], axis=0)
                le, lb, ll = _bucket_build_batch(
                    payload, jnp.asarray(padc(wit_b)),
                    jnp.asarray(padc(mem_b)),
                    jnp.asarray(padc(cd_init[rows]), dtype),
                    jnp.asarray(padc(cid_init[rows]), jnp.int32),
                    jnp.asarray(padc(lens_init[rows]), dtype),
                    jnp.asarray(np.concatenate(
                        [sizes[rows], np.zeros(pad, sizes.dtype)])
                        if pad else sizes[rows], jnp.int32),
                    cmax=cmax_b, dtype_name=dtype_name,
                    frontend=frontend, kmer=params.kmer_size,
                    sketch_size=params.sketch_size, c_in=c_in)
                _ndisp += 1
                nr = len(rows)
                pend3.append((rows, le[:nr], lb[:nr], ll[:nr], cmax_b,
                              mem_b))
                # drain: keeps the queue bounded and makes the bucket
                # log line reflect real execution time (few dispatches)
                np.asarray(jax.device_get(le[:1, :1]))
            else:
                cchunk = _phase3_cchunk(cmax_b)
                for s in range(0, len(rows), cchunk):
                    rr = rows[s : s + cchunk]
                    sl = slice(s, s + len(rr))
                    _td = _time.time()
                    wit_s, mem_s = wit_b[sl], mem_b[sl]
                    init_s = (jnp.asarray(cd_init[rr], dtype),
                              jnp.asarray(cid_init[rr], jnp.int32),
                              jnp.asarray(lens_init[rr], dtype),
                              jnp.asarray(sizes[rr], jnp.int32))
                    Dq = _dc_pair_distances(
                        frontend, params, dtype_name, wit_s, mem_s,
                        payload,
                    )
                    if _profile:
                        jax.block_until_ready(Dq)
                        _t_dist += _time.time() - _td
                    build_args = (Dq,) + init_s
                    if mesh is not None:  # clusters data-parallel
                        le, lb, ll = _shard_batch(
                            mesh, _cluster_build_vmapped(cmax_b, dtype_name),
                            *build_args)
                    else:
                        le, lb, ll = _cluster_build_vmapped(
                            cmax_b, dtype_name)(*build_args)
                    _ndisp += 1
                    if _profile:
                        le, lb, ll = jax.device_get((le, lb, ll))
                        _ta = _time.time()
                        assemble(rr, le, lb, ll, cmax_b, mem_b[sl])
                        _t_asm += _time.time() - _ta
                    else:
                        pend3.append((rr, le, lb, ll, cmax_b, mem_b[sl]))
                        if len(pend3) % 48 == 0:  # bounded-queue pacing
                            np.asarray(jax.device_get(le[:1, :1]))
            _log(f"DC phase 3: bucket cmax_b={cmax_b} "
                 f"clusters={len(rows)} "
                 f"path={'stream' if stream else 'batch'} "
                 f"dispatches={_ndisp} "
                 f"{'in' if _profile else 'enqueued in'} "
                 f"{_time.time() - _tb:.1f}s"
                 + (f" (dist {_t_dist:.1f}s, assemble {_t_asm:.1f}s)"
                    if _profile else ""))

        if pend3:
            _tf = _time.time()
            for rr, le, lb, ll, cmax_b2, mem_np in pend3:
                le, lb, ll = jax.device_get((le, lb, ll))
                if le.ndim == 1:  # stream results are per-cluster
                    le, lb, ll = le[None], lb[None], ll[None]
                assemble(rr, le, lb, ll, cmax_b2, mem_np)
            _log(f"DC phase 3: fetched+assembled {len(pend3)} pending "
                 f"dispatches in {_time.time() - _tf:.1f}s")

    _log(f"DC phase 3 in: {int((_time.time() - _t) * 1000)} ms "
         f"[edges {_hl.md5(g_e.tobytes() + g_belong.tobytes() + g_len.tobytes()).hexdigest()[:10]}]")

    from dipper_tpu.io.newick import edge_arrays_newick

    global last_debug
    last_debug = {"e": g_e, "belong": g_belong, "len": g_len}
    # root = N_total + bd - 2 = N (printTreeDC :708); adjacency grouped
    # by one vectorized argsort instead of an O(E) Python loop
    return edge_arrays_newick(N, list(names), g_belong, g_e, g_len, N)


last_debug = None


def _phase3_cchunk(cmax_b: int) -> int:
    """Clusters per phase-3 dispatch (or lax.map sub-batch), from the
    distance-element budget at this bucket width."""
    return max(1, PHASE3_BUDGET // max(1, cmax_b))


# Above this cluster width, even a single cluster's [cmax, W~cmax]
# distance precompute is quadratic memory: those clusters run
# _cluster_build_stream_mash, which computes rows in _STREAM_ROW_BLOCK
# batches inside the insertion loop (peak [256, W]). Heavy-tailed size
# distributions put only a handful of clusters above this width, so the
# per-cluster dispatch overhead is small while the memory bound
# tightens from [cmax, W] to [256, W].
_STREAM_CLUSTER_MIN = 1024


def _dc_pair_distances(frontend, params: Param, dtype_name, wit_global,
                       members, payload):
    """[C_chunk, cmax, W] distance tensors: Dq[c, k, w] = d(witness w
    placed, query k new)."""
    if frontend == "matrix":
        Dm = payload
        wit = jnp.asarray(wit_global)
        mem = jnp.asarray(members)

        def per_cluster(w_ids, m_ids):
            return Dm[m_ids][:, w_ids]

        return jax.vmap(per_cluster)(wit, mem)
    if frontend == "mash":
        ranks = payload
        from dipper_tpu.distance.mash import (_inter_to_dist,
                                              mash_pairwise_inter)

        wit = jnp.asarray(wit_global)
        mem = jnp.asarray(members)
        inter = jax.vmap(
            lambda w_ids, m_ids: mash_pairwise_inter(
                ranks[w_ids], ranks[m_ids],
                sketch_size=params.sketch_size))(wit, mem)
        # one conversion on the common [C, cmax, W] shape: integer
        # counts are impl-independent, while the log's SIMD tail is
        # shape-dependent on XLA:CPU — this keeps both branches
        # bitwise identical (and identical to the pre-split vmap
        # lowering, since vmap lowers pointwise ops to the same
        # batched HLO).
        return _inter_to_dist(inter, params.kmer_size,
                              params.sketch_size, jnp.dtype(dtype_name))
    else:
        # host bank: gather the cluster's witness/member codes on the
        # host, stage one upload per cluster chunk (dc/msa.cu's
        # transferMsaClusterInfoDC pattern), one-hot on device
        codes_host, nongap_host = payload
        from dipper_tpu.distance.msa import _block_distance, one_hot_channels

        L = codes_host.shape[1]
        dt = jnp.dtype(dtype_name)
        phi_w = one_hot_channels(jnp.asarray(codes_host[wit_global]))
        phi_m = one_hot_channels(jnp.asarray(codes_host[members]))
        ng_w = jnp.asarray(nongap_host[wit_global], dt)
        ng_m = jnp.asarray(nongap_host[members], dt)

        def per_cluster(pw, pm, nw, nm):
            return _block_distance(
                pm, pw, nm, nw,
                distance_type=params.distance_type, dtype_name=dtype_name,
                seq_len=L,
            )  # [cmax, W]; row side is the query ('ec') — symmetric models

        return jax.vmap(per_cluster)(phi_w, phi_m, ng_w, ng_m)

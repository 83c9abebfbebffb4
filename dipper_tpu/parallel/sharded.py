"""Multi-GPU sharding over a device mesh.

The reference is strictly single-GPU (SURVEY.md §2.4); this layer is the
scale-out it never had, over the GPUs of one host (collectives go
through NCCL over NVLink; every card reaches every other at the same
rate, so the mesh is 1-D). Decomposition:

- the SKETCH/RANK BANK is sharded row-wise across devices
  (P('d', None)) — the memory that grows with taxa count;
- the per-insertion DISTANCE ROW is computed shard-locally against the
  local bank slice and combined with an all_gather;
- the EDGE-SCORING SCAN is sharded by edge blocks; the global
  (addi, eid) argmin merges via a tiny gathered reduction whose
  device order preserves the lowest-eid tie-break;
- tree state (edge arrays, witness lists) is replicated and every
  device applies the same splice/BFS updates, so no broadcast of
  topology decisions is needed — determinism keeps replicas identical;
- for divide-and-conquer, phase-3 clusters shard across devices as a
  batch axis (data-parallel analog).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from dipper_tpu.placement import kclosest
from dipper_tpu.placement.kclosest import TreeState


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("d",))


# ---------------------------------------------------------------------------
# Sharded mash distance matrix (NJ frontend at scale)
# ---------------------------------------------------------------------------


def sharded_mash_matrix(ranks_pad, k: int, sketch_size: int, mesh: Mesh,
                        dtype="float32"):
    """Row-sharded [N, N] mash distance matrix: device i computes the
    row block of its bank shard against the full bank (all_gather)."""
    from dipper_tpu.distance.mash import mash_rows_vs_bank

    dtype_name = str(jnp.dtype(dtype))
    N = ranks_pad.shape[0]
    nd = mesh.devices.size
    pad = (-N) % nd
    if pad:
        ranks_pad = jnp.concatenate(
            [ranks_pad, jnp.tile(ranks_pad[-1:], (pad, 1))], axis=0
        )
    Np = ranks_pad.shape[0]

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P("d", None),), out_specs=P(None, "d"),
    )
    def run(bank_local):
        # full bank via all_gather (tiled) — the A side; local rows are
        # the B (new taxon) side, matching the reference orientation
        bank_full = jax.lax.all_gather(bank_local, "d", tiled=True)

        def row(q_local):
            return mash_rows_vs_bank(
                bank_full, bank_local[q_local], k=k,
                sketch_size=sketch_size, dtype_name=dtype_name)

        rows = jax.lax.map(row, jnp.arange(bank_local.shape[0]))
        return rows.T  # [N_full, rows_local] -> concat over 'd' on axis 1

    D = jax.jit(run)(ranks_pad)
    return D[:N, :N]


# ---------------------------------------------------------------------------
# Sharded k-closest placement
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("num_sequences", "k", "sketch_size",
                              "dtype_name", "mesh_holder", "scorer_cfg"),
)
def _sharded_placement_jit(ranks_sharded, *, num_sequences, k, sketch_size,
                           dtype_name, mesh_holder,
                           scorer_cfg=kclosest.SCORER_CFG):
    """Sharded build of the whole placement tree.

    Decomposition (tree state replicated; every O(N)/O(E) term sharded):
      - distance rows: blocked prefetch — each device runs the
        production mash intersection count on its bank shard for
        ROW_BLOCK queries at once, one all_gather per block;
      - witness scoring: the epoch scorer of kclosest, shard-local over
        a disjoint padded edge split (E_pad = nd*ceil(E/nd); pad slots
        score the 2.0 sentinel and sit at ids >= E, so the first-min
        tie-break is unaffected). SIDE0 builds per shard and
        all_gathers once per epoch; per insertion the collectives are
        one [E_pad] side all_gather (dis2 fix values), one [E_pad]-byte
        OR-reduce (the dirty push bitmap: shards flag rev0[their dirty
        edges], so no device ever random-gathers a remote bitmap), and
        the [nd, 3] argmin trio whose ascending device order preserves
        the lowest-eid tie-break;
      - splice + witness BFS: replicated (identical on every device —
        determinism keeps replicas in lockstep; per-insertion work is
        O(frontier), not O(E), so replication costs no communication).

    Outputs are bitwise identical to the single-device build: every
    per-edge float op sees identical values, and integer mash
    intersection counts are implementation-independent."""
    mesh = mesh_holder.mesh
    N = num_sequences
    dtype = jnp.dtype(dtype_name)
    nd = mesh.devices.size
    E = 4 * N
    el = -(-E // nd)
    E_pad = el * nd
    B = kclosest.ROW_BLOCK
    T, t1, t2 = scorer_cfg
    T = min(T, B)
    if B % T:
        T = B
    t1, t2 = min(t1, el), min(t2, el)

    from dipper_tpu.distance.mash import mash_pairwise

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P("d", None),),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    def run(bank_local):
        sh = bank_local.shape[0]
        didx = jax.lax.axis_index("d")
        lo_e = didx * el
        iota_l = jnp.arange(el, dtype=jnp.int32)

        def row_block(start):
            # replicate the query sketches (psum of the owner's rows),
            # then every device scores them against its bank shard
            q = start + jnp.arange(B, dtype=jnp.int32)
            lq = q - didx * sh
            owned = (lq >= 0) & (lq < sh)
            qr = jnp.where(owned[:, None],
                           bank_local[jnp.clip(lq, 0, sh - 1)], 0)
            qr = jax.lax.psum(qr, "d")
            local = mash_pairwise(bank_local, qr, k=k,
                                  sketch_size=sketch_size,
                                  dtype_name=dtype_name)  # [B, sh]
            return jax.lax.all_gather(local, "d", tiled=True,
                                      axis=1)  # [B, nd*sh]

        def slice_l(x):
            return jax.lax.dynamic_slice_in_dim(
                _pad0(x), lo_e, el, axis=0)

        def _pad0(x):
            p = E_pad - x.shape[0]
            if p == 0:
                return x
            pad_val = jnp.zeros((p,) + x.shape[1:], x.dtype)
            if x.dtype == jnp.int32:
                pad_val = pad_val - 1          # e/belong/rev/cid pads
            return jnp.concatenate([x, pad_val], axis=0)

        def make_epoch(st, rows_T):
            # per-shard SIDE0 (same gather math as kclosest._make_epoch)
            cid_l = slice_l(st.cid)
            cdis_l = slice_l(st.cdis)
            RT = rows_T.T                                  # [Np, T]
            G = RT[jnp.maximum(cid_l, 0).reshape(-1)].reshape(
                el, kclosest.K, T)
            dv = jnp.where((cid_l != -1)[:, :, None],
                           G - cdis_l[:, :, None], -jnp.inf)
            side0_l = jnp.maximum(jnp.max(dv, axis=1), 0.0)  # [el, T]
            side0_full = jax.lax.all_gather(side0_l, "d",
                                            tiled=True)  # [E_pad, T]
            rev0_l = slice_l(st.rev)
            rside0_l = side0_full[jnp.maximum(rev0_l, 0)]    # [el, T]
            return (side0_l.T, rside0_l.T, cid_l, cdis_l, rev0_l)

        def sentinel_epoch(st):
            z = jnp.zeros((T, el), dtype)
            return (z, z, jnp.full((el, kclosest.K), -2, jnp.int32),
                    slice_l(st.cdis), slice_l(st.rev))

        def score_epoch(st, row, ep, t):
            side0_l, rside0_l, cid0_l, cdis0_l, rev0_l = ep
            cid_l = slice_l(st.cid)
            cdis_l = slice_l(st.cdis)
            rev_l = slice_l(st.rev)
            belong_l = slice_l(st.belong)
            e_l = slice_l(st.e)
            len_l = slice_l(st.length)
            dirty = jnp.any((cid_l != cid0_l) | (cdis_l != cdis0_l),
                            axis=1)
            rank = jnp.cumsum(dirty.astype(jnp.int32)) - 1
            ndirty = jnp.sum(dirty.astype(jnp.int32))
            rev_changed = (rev_l != rev0_l) & (belong_l >= 0)

            def tier_branch(cap):
                capf = cap + 6 * T

                def br():
                    tgt = jnp.where(dirty & (rank < cap), rank,
                                    cap + iota_l)
                    ids_c = jnp.full((cap,), el, jnp.int32).at[tgt].set(
                        iota_l, mode="drop", unique_indices=True)
                    valid_c = jnp.arange(cap, dtype=jnp.int32) < ndirty
                    idc = jnp.minimum(ids_c, el - 1)
                    dvc = jnp.where(
                        cid_l[idc] != -1,
                        row[jnp.maximum(cid_l[idc], 0)] - cdis_l[idc],
                        -jnp.inf)
                    se = jnp.maximum(jnp.max(dvc, axis=1), 0.0)
                    wr = jnp.where(valid_c, ids_c,
                                   el + jnp.arange(cap, dtype=jnp.int32))
                    side_l = jax.lax.dynamic_index_in_dim(
                        side0_l, t, axis=0, keepdims=False)
                    side_l = side_l.at[wr].set(se, mode="drop",
                                               unique_indices=True)
                    # dirty-push bitmap: flag rev0[my dirty edges]
                    # (global ids) so the OWNING shard learns its rev
                    # target went dirty — no remote random gathers
                    r0g = jnp.where(valid_c & (rev0_l[idc] >= 0),
                                    rev0_l[idc],
                                    E_pad + jnp.arange(cap,
                                                       dtype=jnp.int32))
                    push = jnp.zeros((E_pad,), jnp.int32).at[r0g].set(
                        1, mode="drop", unique_indices=True)
                    push = jax.lax.psum(push, "d")
                    side_glob = jax.lax.all_gather(side_l, "d",
                                                   tiled=True)  # [E_pad]
                    push_l = jax.lax.dynamic_slice_in_dim(
                        push, lo_e, el)
                    need = rev_changed | (push_l > 0)
                    frank = jnp.cumsum(need.astype(jnp.int32)) - 1
                    ftgt = jnp.where(need & (frank < capf), frank,
                                     capf + iota_l)
                    fids = jnp.full((capf,), el, jnp.int32).at[ftgt].set(
                        iota_l, mode="drop", unique_indices=True)
                    nfix = jnp.sum(need.astype(jnp.int32))
                    fvalid = jnp.arange(capf, dtype=jnp.int32) < nfix
                    fidc = jnp.minimum(fids, el - 1)
                    d2v = side_glob[jnp.maximum(rev_l[fidc], 0)]
                    fwr = jnp.where(fvalid, fids,
                                    el + jnp.arange(capf,
                                                    dtype=jnp.int32))
                    dis2_l = jax.lax.dynamic_index_in_dim(
                        rside0_l, t, axis=0, keepdims=False)
                    dis2_l = dis2_l.at[fwr].set(d2v, mode="drop",
                                                unique_indices=True)
                    return side_l, dis2_l

                return br

            def full_branch():
                dv = jnp.where(cid_l != -1,
                               row[jnp.maximum(cid_l, 0)] - cdis_l,
                               -jnp.inf)
                side_l = jnp.maximum(jnp.max(dv, axis=1), 0.0)
                side_glob = jax.lax.all_gather(side_l, "d", tiled=True)
                return side_l, side_glob[jnp.maximum(rev_l, 0)]

            # the branches hold collectives, so every device must take
            # the same one: pick the tier by the largest shard's count
            nmax = jax.lax.pmax(ndirty, "d")
            tier = ((nmax > t1).astype(jnp.int32)
                    + (nmax > t2).astype(jnp.int32))
            side_l, dis2_l = jax.lax.switch(
                tier, [tier_branch(t1), tier_branch(t2), full_branch])
            # clamp sequence + local argmin + device-ordered merge
            # (calculateBranchLength tail; device order ascends edge
            # blocks, so first-min == global lowest-eid)
            L = len_l
            dis1 = side_l
            addi = jnp.maximum((dis1 + dis2_l - L) * 0.5, 0.0)
            d1 = jnp.maximum(dis1 - addi, 0.0)
            d2 = jnp.maximum(dis2_l - addi, 0.0)
            addi = addi + jnp.maximum(d1 - L, 0.0) \
                + jnp.maximum(d2 - L, 0.0)
            d1 = jnp.minimum(d1, L)
            d2 = jnp.minimum(d2, L)
            rest = L - d1 - d2
            d1 = d1 + rest * 0.5
            valid = belong_l > e_l
            score = jnp.where(valid, addi,
                              jnp.asarray(kclosest.SENT_DIS, dtype))
            frac = jnp.where(valid, d1, 0.0)
            li = jnp.argmin(score)
            trio = jnp.stack([score[li], frac[li],
                              (li + lo_e).astype(dtype)])
            allt = jax.lax.all_gather(trio, "d")          # [nd, 3]
            w = jnp.argmin(allt[:, 0])
            return (allt[w, 2].astype(jnp.int32), allt[w, 1], allt[w, 0])

        st = kclosest.init_state(N, dtype)
        blk0 = row_block(jnp.int32(0))
        st = kclosest.build_initial_tree(st, blk0[1, 0].astype(dtype), N)
        st = kclosest.update_closest_bfs(st, jnp.int32(0), 2 * N)
        st = kclosest.update_closest_bfs(st, jnp.int32(1), 2 * N)
        ep0 = sentinel_epoch(st)

        def body(i, carry):
            st, blk, ep = carry
            i32 = jnp.asarray(i, jnp.int32)
            bstart = (i32 // B) * B
            blk = jax.lax.cond((i32 == bstart) & (i32 > 2),
                               row_block, lambda _: blk, bstart)
            estart = (i32 // T) * T

            def fresh(args):
                st_, blk_ = args
                rows_T = jax.lax.dynamic_slice_in_dim(
                    blk_, estart - bstart, T, axis=0)
                return make_epoch(st_, rows_T)

            ep = jax.lax.cond(i32 == estart, fresh, lambda _: ep,
                              (st, blk))
            row = jax.lax.dynamic_index_in_dim(blk, i32 - bstart, axis=0,
                                               keepdims=False)
            eid, frac, add = score_epoch(st, row, ep, i32 - estart)
            st = kclosest.splice(st, eid, frac, add, i, N)
            st = kclosest.update_closest_bfs(st, i, 2 * N)
            return st, blk, ep

        st, _, _ = jax.lax.fori_loop(2, N, body, (st, blk0, ep0))
        return st.e, st.belong, st.length

    return run(ranks_sharded)


class _MeshHolder:
    """Hashable wrapper so a Mesh can be a static jit argument."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __hash__(self):
        return hash(tuple(d.id for d in self.mesh.devices.flat))

    def __eq__(self, other):
        return isinstance(other, _MeshHolder) and hash(self) == hash(other)


def sharded_placement_build(sketches_u64, k: int, sketch_size: int,
                            mesh: Mesh, dtype="float32",
                            scorer_cfg=kclosest.SCORER_CFG):
    """Full k-closest placement with the distance rows and edge scan
    sharded over the mesh. Returns host (e, belong, length)."""
    from dipper_tpu.distance.mash import rank_compress_host, pad_ranks

    N = int(sketches_u64.shape[0])
    nd = mesh.devices.size
    # host rank compression (order/equality-identical to the device
    # sort path), padded before the sharded device_put below
    ranks = pad_ranks(rank_compress_host(np.asarray(sketches_u64)))
    pad = (-N) % nd  # pad bank rows so the shard split is even; the
    if pad:          # distance gather slices back to [:N]
        ranks = np.concatenate([ranks, np.tile(ranks[-1:], (pad, 1))],
                               axis=0)
    sharding = jax.sharding.NamedSharding(mesh, P("d", None))
    ranks_sharded = jax.device_put(ranks, sharding)
    e, belong, length = _sharded_placement_jit(
        ranks_sharded, num_sequences=N, k=k, sketch_size=sketch_size,
        dtype_name=str(jnp.dtype(dtype)), mesh_holder=_MeshHolder(mesh),
        scorer_cfg=scorer_cfg,
    )
    return jax.device_get((e, belong, length))

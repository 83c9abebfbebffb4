"""Neighbor joining on the device.

Behavioral spec: src/neighborJoining.cu:94-270 —
- selection criterion: minimize d(i,j) - U(i)/(n-2) - U(j)/(n-2) over
  active pairs i != j (findMinDist :117-148),
- branch lengths blX = (d + (Ux-Uy)/(n-2))/2, blY = d - blX, negative
  branches clamped with the remainder shifted (:227-232),
- matrix compaction: the new node overwrites row/col x, the last active
  row/col moves into y (updateDisMatrix :161-194),
- final 2-node join at root id 2N-2 with d/2 per side (:245-249).

Design (nothing like the CUDA host loop): the whole merge loop runs
on device inside `lax.fori_loop` carried over fixed-shape arrays; the
only host transfer is the final [N-2, 4] join log. The active submatrix
shrinks as a prefix of the padded matrix, so instead of per-iteration
compaction we re-jit at halved shapes (log2(N) compiles): each "bucket"
runs until the active count reaches half the padded size, then the
prefix is sliced and the next bucket starts. Row sums U are recomputed
at bucket boundaries to cancel f32 drift.

Tie-breaking: first minimum in row-major scan order of the active
submatrix (deterministic; documented divergence from thrust's
thread-order tie-break, which only matters on exact float ties).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _one_merge_step(S: int, N_total: int, dtype):
    """Single NJ merge on an [S,S] prefix-active matrix."""

    def one_iter(carry):
        D, U, real, n, step, log = carry
        nf = n.astype(dtype)
        iot = jax.lax.broadcasted_iota(jnp.int32, (S, S), 0)
        jot = jax.lax.broadcasted_iota(jnp.int32, (S, S), 1)
        col = jax.lax.broadcasted_iota(jnp.int32, (S,), 0)
        active = (iot < n) & (jot < n) & (iot != jot)
        Un = (U / (nf - 2)).astype(dtype)
        Q = D - Un[:, None] - Un[None, :]
        big = jnp.asarray(jnp.finfo(dtype).max, dtype)
        Q = jnp.where(active, Q, big)
        flat = jnp.argmin(Q.reshape(-1))
        x0, y0 = flat // S, flat % S
        x = jnp.minimum(x0, y0)
        y = jnp.maximum(x0, y0)
        d = D[x, y]
        ux = U[x] / (nf - 2)
        uy = U[y] / (nf - 2)
        blx = (d + ux - uy) * 0.5
        bly = d - blx
        # negative-branch clamping, remainder shifted (reference order)
        bly = jnp.where(blx < 0, bly + blx, bly)
        blx = jnp.maximum(blx, 0.0)
        blx = jnp.where(bly < 0, blx + bly, blx)
        bly = jnp.maximum(bly, 0.0)
        log = log.at[step].set(
            jnp.stack([real[x].astype(dtype), real[y].astype(dtype), blx, bly])
        )
        rowx = D[x, :]
        rowy = D[y, :]
        last = n - 1
        newrow = (rowx + rowy - d) * 0.5
        act_col = col < n
        untouched = act_col & (col != x) & (col != y)
        U = U + jnp.where(untouched, newrow - rowx - rowy, 0.0)
        Ux = jnp.sum(jnp.where(untouched, newrow, 0.0))
        newrow = jnp.where(col == x, 0.0, newrow)  # D[x,x] = 0
        # rl = row `last` AFTER the x-write, with position y zeroed
        rowlast = D[last, :]
        rowlast = jnp.where(col == x, newrow[last], rowlast)
        rl = jnp.where(col == y, 0.0, rowlast)
        d_x_last = newrow[last]
        # masked-select rebuild of D (no scatters; fuses into one [S,S]
        # elementwise pass; ROADMAP S4):
        #   1) write newrow into row/col x
        #   2) write rl into row/col y
        #   3) fix the (x,y) pair to d(new, moved-last)
        is_rx = iot == x
        is_cx = jot == x
        is_ry = iot == y
        is_cy = jot == y
        nr_i = newrow[:, None]  # column-x write: D[i, x] = newrow[i]
        nr_j = newrow[None, :]  # row-x write:    D[x, j] = newrow[j]
        rl_i = rl[:, None]
        rl_j = rl[None, :]
        Dn = jnp.where(is_rx, nr_j, jnp.where(is_cx, nr_i, D))
        Dn = jnp.where(is_ry, rl_j, jnp.where(is_cy, rl_i, Dn))
        pairfix = (is_rx & is_cy) | (is_ry & is_cx)
        D = jnp.where(pairfix, d_x_last, Dn)
        U = U.at[y].set(U[last]).at[x].set(Ux)
        new_id = jnp.int32(N_total) + step
        real = real.at[y].set(real[last]).at[x].set(new_id)
        return D, U, real, n - 1, step + 1, log

    return one_iter


@functools.partial(jax.jit, static_argnames=("S", "N_total", "dtype_name"))
def _run_bucket(D, U, real, n, step, log, iters, *, S, N_total, dtype_name):
    dtype = jnp.dtype(dtype_name)
    body = _one_merge_step(S, N_total, dtype)
    # dynamic trip count: one compile per (S, dtype) regardless of N
    return jax.lax.fori_loop(
        0, iters, lambda _, c: body(c), (D, U, real, n, step, log)
    )


@functools.partial(jax.jit, static_argnames=("newS",))
def _shrink(D, real, n, *, newS):
    D2 = D[:newS, :newS]
    col = jnp.arange(newS)
    U2 = jnp.sum(jnp.where((col < n)[None, :], D2, 0.0), axis=1)
    return D2, U2, real[:newS]


def neighbor_joining_device(D_host, dtype=jnp.float32, mesh=None):
    """Runs device NJ. Returns (children, root) like the test oracle:
    children[v] = [(child_id, branch_length), ...].

    `mesh`: optional jax.sharding.Mesh with axis 'd'. The [S, S] matrix
    is laid out row-sharded (P('d', None)) and the SAME bucket loop
    runs under GSPMD: the O(N^2)-per-iteration Q-scan argmin becomes a
    per-shard scan + collective merge, the masked-select rebuild
    stays shard-local, and the x/y row reads become collective gathers
    — all inserted by the partitioner, with argmin's first-minimum
    semantics (and therefore the tie-break and the join sequence)
    unchanged vs single-device. Branch lengths can differ at ULP level
    because sharded row-sum reductions reassociate floating-point
    adds. The reference's Q-scan is a single-GPU thread stripe
    (src/neighborJoining.cu:117-148); this is its multi-chip analog
    (SURVEY §2.4)."""
    N = int(D_host.shape[0])
    if N < 2:
        raise ValueError("need at least 2 taxa")
    children = [[] for _ in range(2 * N)]
    root = 2 * N - 2
    if N == 2:
        d = float(D_host[0, 1])
        children[root] = [(0, d * 0.5), (1, d * 0.5)]
        return children, root

    dtype = jnp.dtype(dtype)
    S = max(128, int(2 ** np.ceil(np.log2(N))))
    Dnp = np.zeros((S, S), np.dtype(dtype))
    Dnp[:N, :N] = np.asarray(D_host, np.dtype(dtype))
    if mesh is not None and S % mesh.devices.size == 0:
        from jax.sharding import NamedSharding, PartitionSpec

        D = jax.device_put(Dnp, NamedSharding(mesh, PartitionSpec("d", None)))
    else:
        D = jnp.asarray(Dnp)
    U = jnp.sum(D, axis=1)
    real = jnp.arange(S, dtype=jnp.int32)
    n = jnp.int32(N)
    step = jnp.int32(0)
    log = jnp.zeros((N - 2, 4), dtype)

    total_iters = N - 2
    done = 0
    n_val = N
    while done < total_iters:
        if S > 128 and n_val <= S // 2:
            S = max(128, S // 2)
            D, U, real = _shrink(D, real, n, newS=S)
        if S == 128:
            iters = total_iters - done  # run to completion in min bucket
        else:
            iters = min(total_iters - done, n_val - S // 2)
        # cap the work per dispatch: bounds one dispatch's size
        # (ROADMAP D2)
        per_call = max(1, min(iters, (1 << 28) // (S * S) * 128))
        left = iters
        while left > 0:
            it = min(left, per_call)
            D, U, real, n, step, log = _run_bucket(
                D, U, real, n, step, log, jnp.int32(it),
                S=S, N_total=N, dtype_name=str(dtype),
            )
            left -= it
        done += iters
        n_val -= iters

    from dipper_tpu.parallel.distributed import to_host

    log_host = np.asarray(to_host(log), dtype=np.float64)
    real_host = np.asarray(to_host(real))
    d01 = float(to_host(D[0, 1]))
    for s in range(N - 2):
        a, b, blx, bly = log_host[s]
        children[N + s].append((int(a), float(blx)))
        children[N + s].append((int(b), float(bly)))
    children[root].append((int(real_host[0]), d01 * 0.5))
    children[root].append((int(real_host[1]), d01 * 0.5))
    return children, root


def nj_tree_newick(children, root, names) -> str:
    """Iterative Newick writer for the NJ join tree (reference
    neighborJoining.cu:252-270 recursion, made stack-explicit)."""
    out = []
    stack = [(root, 0)]
    while stack:
        v, i = stack.pop()
        ch = children[v]
        if not ch:
            out.append(names[v])
            continue
        if i == 0:
            out.append("(")
        else:
            out.append(":")
            out.append(f"{ch[i - 1][1]:.6g}")
            out.append(")" if i == len(ch) else ",")
        if i < len(ch):
            stack.append((v, i + 1))
            stack.append((ch[i][0], 0))
    out.append(";")
    return "".join(out)

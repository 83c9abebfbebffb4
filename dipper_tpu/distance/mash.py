"""Mash sketch distances.

Behavioral spec (src/mash.cu:426-455): for sketches A (an already
placed taxon) and B (the new row's taxon), walk the two sorted
1000-element hash lists, counting `inter` (B elements equal to an A
element — ALL equal B copies match, an asymmetric multiset rule) and
`uni` (A elements + unmatched B elements), stopping when uni reaches
sketchSize; then

    j = max(inter, 1) / sketchSize
    d = min(1, |ln(2j / (1+j))| / k)

u64 hashes are rank-compressed once over the whole sketch bank
(order- and equality-preserving), so every comparison is int32 and a
sketch row takes half the bytes.

Two implementations of the count, chosen by platform
(mash_pairwise_inter):

- GPU: the reference's serial two-pointer walk, one thread per pair,
  in CUDA (native/mash_inter.cu through distance/mash_gpu.py).
- CPU: the walk restated as data-parallel XLA. concat(A_keys,
  reverse(B_keys)) is bitonic, so log2(2M) compare-exchange stages
  give the merged order; keys are rank*2 + tag (tag 1 for A, 0 for B),
  which reproduces the walk's tie order (equal-valued B elements come
  first). A B element is `matched` iff the next A-value at-or-after it
  (a reverse min-scan) equals its value; uni increments for everything
  except matched B elements; `inter` sums matched-B events whose
  exclusive uni-prefix is < sketchSize.

Both are checked against the transliterated serial walk
(tests/oracle.py) over adversarial multisets (duplicates,
sentinel-heavy short sequences): tests/test_mash.py on the CPU, and
chip_smoke.py on the GPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_PAD_KEY = np.int32(2**31 - 1)


# Width of the tile-sort stage of the hierarchical global sort: above
# _TILE_W the global sort is tile sorts + explicit bitonic key-value
# merge rounds instead of one flat lax.sort (ROADMAP D4 asks whether
# the split is still needed).
_TILE_W = 16384


def _bitonic_merge_kv(arrs, keys: int):
    """arrs: tuple of [..., 2M] arrays where [..., :M] ascending and
    [..., M:] descending in the first `keys` arrays (lexicographic).
    Fully sorts the last axis, carrying the remaining arrays as
    payload. NOT stable (rank assignment is order-independent within
    equal runs, and payload keys are distinct where stability would
    matter)."""
    n = arrs[0].shape[-1]
    orig = arrs[0].shape
    assert (n & (n - 1)) == 0
    d = n // 2
    while d >= 1:
        shp = arrs[0].shape[:-1] + (n // (2 * d), 2, d)
        rs = [a.reshape(shp) for a in arrs]
        a0 = [r[..., 0, :] for r in rs]
        a1 = [r[..., 1, :] for r in rs]
        if keys == 1:
            swap = a0[0] > a1[0]
        else:
            swap = (a0[0] > a1[0]) | ((a0[0] == a1[0]) & (a0[1] > a1[1]))
        lo = [jnp.where(swap, y, x) for x, y in zip(a0, a1)]
        hi = [jnp.where(swap, x, y) for x, y in zip(a0, a1)]
        arrs = tuple(
            jnp.stack([l, h], axis=-2).reshape(orig)
            for l, h in zip(lo, hi))
        d //= 2
    return arrs


def _global_sort(arrs, keys: int):
    """Sort flat pow2-length arrays by the first `keys` arrays
    (lexicographic u32/i32): tile sorts + pairwise bitonic merges."""
    P = arrs[0].shape[0]
    if P <= _TILE_W:
        return jax.lax.sort(arrs, num_keys=keys)
    R = P // _TILE_W
    arrs = tuple(a.reshape(R, _TILE_W) for a in arrs)
    arrs = jax.lax.sort(arrs, num_keys=keys, dimension=1)
    while arrs[0].shape[0] > 1:
        r, w = arrs[0].shape
        # concat(row 2i, reversed row 2i+1) is bitonic
        pairs = tuple(
            jnp.concatenate(
                [a.reshape(r // 2, 2, w)[:, 0, :],
                 a.reshape(r // 2, 2, w)[:, 1, ::-1]], axis=1)
            for a in arrs)
        arrs = _bitonic_merge_kv(pairs, keys)
    return tuple(a.reshape(-1) for a in arrs)


@jax.jit
def rank_compress(sketches_u64):
    """u64 [N, S] (rows sorted) -> int32 ranks [N, S] preserving order
    and equality globally. max rank < N*S (must stay < 2^30 so that
    rank*2+1 fits int32).

    The global sort runs on u32 limb pairs (two-key lax.sort). Tie
    order among equal values is irrelevant: the segmented scan assigns
    every element of an equal-run the same rank."""
    N, S = sketches_u64.shape
    flat = sketches_u64.reshape(-1)
    hi = (flat >> jnp.uint64(32)).astype(jnp.uint32)
    lo = (flat & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    # pad the sort width to a power of two (the bitonic merge rounds
    # need it). Pads carry sentinel keys and past-the-end iota, so with
    # a stable sort every real element's rank (first iota of its
    # equal-run) is unchanged; the inverting sort brings the real
    # elements back to the front.
    P = N * S
    Pp = 1 << int(np.ceil(np.log2(max(P, 2))))
    iota = jnp.arange(Pp, dtype=jnp.int32)
    if Pp != P:
        sent = np.uint32(0xFFFFFFFF)
        hi = jnp.concatenate([hi, jnp.full((Pp - P,), sent, jnp.uint32)])
        lo = jnp.concatenate([lo, jnp.full((Pp - P,), sent, jnp.uint32)])
    hi_s, lo_s, order = _global_sort((hi, lo, iota), keys=2)
    newseg = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_),
         (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])]
    )
    rank_sorted = jax.lax.associative_scan(jnp.maximum, jnp.where(newseg, iota, 0))
    # invert the permutation by a second sort (sort-by-destination)
    _, ranks = _global_sort((order, rank_sorted), keys=1)
    return ranks[:P].reshape(N, S)


def rank_compress_host(sketches_u64: np.ndarray) -> np.ndarray:
    """Host twin of rank_compress for ingest-time use. Assigns
    consecutive ranks 0..U-1 via np.unique (the device version assigns
    first-iota-of-equal-run ranks); consumers depend only on order and
    equality between ranks — both paths preserve those exactly, so
    distances and trees are identical. Rank compression is one-shot
    ingest work; use this path whenever the sketch bank is
    host-resident."""
    flat = np.ascontiguousarray(sketches_u64).reshape(-1)
    _, inv = np.unique(flat, return_inverse=True)
    return inv.astype(np.int32).reshape(sketches_u64.shape)


def _bitonic_merge(keys):
    """keys [..., 2M] where [..., :M] ascending and [..., M:] descending
    -> fully sorted along the last axis."""
    n = keys.shape[-1]
    assert (n & (n - 1)) == 0
    d = n // 2
    while d >= 1:
        shp = keys.shape[:-1] + (n // (2 * d), 2, d)
        r = keys.reshape(shp)
        lo = jnp.minimum(r[..., 0, :], r[..., 1, :])
        hi = jnp.maximum(r[..., 0, :], r[..., 1, :])
        keys = jnp.stack([lo, hi], axis=-2).reshape(keys.shape)
        d //= 2
    return keys


def _merged_inter_count(a_keys, b_keys, sketch_size: int):
    """a_keys [..., M] ascending (tag already applied: 2r+1),
    b_keys [..., M] ascending (2r). Returns inter counts [...]."""
    merged = _bitonic_merge(
        jnp.concatenate([a_keys, b_keys[..., ::-1]], axis=-1)
    )
    tag = merged & 1
    val = merged >> 1
    is_a = tag == 1
    BIG = jnp.int32(2**30)
    a_vals = jnp.where(is_a, val, BIG)
    # axis=-1 trips a negative-dim bug in reverse-mode associative_scan
    last = a_vals.ndim - 1
    next_a = jax.lax.associative_scan(jnp.minimum, a_vals, reverse=True, axis=last)
    matched_b = (~is_a) & (next_a == val)
    uni_inc = jnp.where(matched_b, 0, 1).astype(jnp.int32)
    cum = jnp.cumsum(uni_inc, axis=-1, dtype=jnp.int32)
    cum_before = cum - uni_inc
    return jnp.sum(matched_b & (cum_before < sketch_size), axis=-1,
                   dtype=jnp.int32)


@functools.lru_cache(maxsize=None)
def _dist_table(k: int, sketch_size: int, dtype_name: str) -> np.ndarray:
    """Host-computed [S+1] lookup table d(inter) for the only possible
    intersection counts 0..S. NumPy's libm log gives ONE deterministic
    set of values embedded as a jit constant — XLA evaluates
    transcendentals differently between compilation contexts (SIMD
    bodies vs scalar tails vs constant folding), which flipped argmin
    ties between the streamed and precomputed DC distance paths even
    for identical integer counts."""
    dt = np.dtype(dtype_name)
    t = np.arange(sketch_size + 1, dtype=dt)
    j = np.maximum(t, dt.type(1.0)) / dt.type(sketch_size)
    return np.minimum(
        dt.type(1.0),
        np.abs(np.log(dt.type(2.0) * j / (dt.type(1.0) + j)) / dt.type(k)))


def _inter_to_dist(inter, k: int, sketch_size: int, dtype):
    """d = min(1, |ln(2j/(1+j))|/k), j = max(inter,1)/S (mash.cu:453),
    via the host lookup table — the hot path is one tiny gather instead
    of a log per pair, and distances are bitwise identical across every
    dispatch shape, impl, and backend given equal counts."""
    tab = jnp.asarray(_dist_table(k, sketch_size, str(jnp.dtype(dtype))))
    return tab[jnp.clip(inter, 0, sketch_size)]


def _pad_pow2(S: int) -> int:
    return int(2 ** np.ceil(np.log2(max(S, 2))))


def mash_rows_vs_bank(bank_ranks, query_ranks, *, k: int, sketch_size: int,
                      dtype_name: str):
    """bank_ranks int32 [Na, M] (the already-placed side, A),
    query_ranks [M] (the new taxon, B) -> [Na] distances."""
    inter = mash_pairwise_inter(bank_ranks, query_ranks[None, :],
                                sketch_size=sketch_size)[0]
    return _inter_to_dist(inter, k, sketch_size, jnp.dtype(dtype_name))


def _merge_inter_xla(bank_ranks, query_ranks, *, sketch_size: int):
    """The XLA merge network under a sequential lax.map over queries
    (each step holds [Na, 2M] int32)."""
    a_keys = bank_ranks * 2 + 1

    def f(q):
        b_keys = jnp.broadcast_to((q * 2)[None, :], a_keys.shape)
        return _merged_inter_count(a_keys, b_keys, sketch_size)

    return jax.lax.map(f, query_ranks)


def mash_pairwise_inter(bank_ranks, query_ranks, *, sketch_size: int,
                        impl: str = "auto"):
    """[Na, M] bank x [Nb, M] queries -> int32 [Nb, Na] intersection
    counts (the serial merge-walk's `inter`, src/mash.cu:426-449).

    impl 'auto' picks by the platform the computation is lowered for:
    the CUDA kernel (distance/mash_gpu.py) on a GPU, the XLA merge
    network under a sequential lax.map over queries on the CPU. 'map'
    forces the XLA merge on any platform (the plain reference). Under
    jax.vmap the kernel runs every batch element in one launch.

    Integer counts are bitwise identical across impls and batchings, so
    callers that must produce identical distances from differently
    shaped dispatches (the D&C streamed vs precomputed cluster paths)
    compute counts per path and apply _inter_to_dist once on a common
    shape: float transcendentals on XLA:CPU differ by ulps between
    SIMD bodies and scalar tails."""
    if impl not in ("auto", "map"):
        raise ValueError(f"impl must be 'auto' or 'map', not {impl!r}")
    xla = functools.partial(_merge_inter_xla, sketch_size=sketch_size)
    if impl == "map":
        return xla(bank_ranks, query_ranks)
    from dipper_tpu.distance.mash_gpu import mash_inter_gpu

    return jax.lax.platform_dependent(
        bank_ranks, query_ranks, cpu=xla,
        cuda=functools.partial(mash_inter_gpu, sketch_size=sketch_size))


def mash_pairwise(bank_ranks, query_ranks, *, k: int, sketch_size: int,
                  dtype_name: str):
    """[Na, M] bank x [Nb, M] queries -> [Nb, Na] distances
    (d[q, a] = distance with a as the placed side)."""
    inter = mash_pairwise_inter(bank_ranks, query_ranks,
                                sketch_size=sketch_size)
    return _inter_to_dist(inter, k, sketch_size, jnp.dtype(dtype_name))


@functools.partial(jax.jit, static_argnames=("k", "sketch_size", "dtype_name"))
def mash_row_from_ranks(ranks_pad, row_id, *, k: int, sketch_size: int,
                        dtype_name: str):
    """ranks_pad int32 [N, M] (M = pow2 >= sketch_size, rows ascending);
    row_id scalar. Returns [N] distances of taxon row_id vs every taxon
    (junk beyond j != row_id semantics; the caller masks j >= row_id).
    A = old taxon j, B = the new row."""
    b = jax.lax.dynamic_index_in_dim(ranks_pad, row_id, axis=0,
                                     keepdims=False)
    return mash_rows_vs_bank(ranks_pad, b, k=k, sketch_size=sketch_size,
                             dtype_name=dtype_name)


def pad_ranks(ranks):
    """Pad rank rows to the next power of two with PAD_KEY//2 so that
    tagged keys (2r, 2r+1) stay below int32 max and pads sort last.
    Accepts a host np.ndarray (returns np) or a device array (returns
    jnp) so ingest can pad before the H2D transfer."""
    N, S = ranks.shape
    M = _pad_pow2(S)
    if M == S:
        return ranks
    xp = np if isinstance(ranks, np.ndarray) else jnp
    pad = xp.full((N, M - S), (_PAD_KEY - 1) // 2, xp.int32)
    return xp.concatenate([ranks, pad], axis=1)


def mash_distance_matrix_device(sketches_u64: np.ndarray, k: int,
                                sketch_size: int, dtype="float32"):
    """Full symmetric [N, N] mash distance matrix as a DEVICE array.
    The reference fills row i for j < i and mirrors (fillDismatrix,
    neighborJoining.cu:20); the batched path computes both orientations
    and keeps the lower triangle, which is identical."""
    sk = jnp.asarray(sketches_u64)
    ranks = pad_ranks(rank_compress(sk))
    N = ranks.shape[0]
    dtype_name = str(jnp.dtype(dtype))
    chunk = min(512, N)
    pw = jax.jit(functools.partial(
        mash_pairwise, k=k, sketch_size=sketch_size, dtype_name=dtype_name))
    out = jnp.zeros((N, N), jnp.dtype(dtype))
    for s in range(0, N, chunk):
        s0 = min(s, N - chunk)  # full-size block, recompute overlap
        blk = pw(ranks, ranks[s0:s0 + chunk])
        out = jax.lax.dynamic_update_slice(out, blk, (s0, 0))
    D = jnp.tril(out, -1)
    return D + D.T

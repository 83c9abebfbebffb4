"""MSA (aligned-FASTA) distances as integer matmuls.

Behavioral spec: src/MSA.cu:81-268 — six distance models over 4-bit
codes (A=0 C=1 G=2 T=3, gap/other=4):

  1 uncorrected   1 - match/useful, useful = columns where EITHER side
                  is non-gap, match = both non-gap and equal (:89-100)
  2 JC            -0.75 ln(1 - p/0.75) over the same p (:233-236)
  3 Tajima-Nei    reference variant: pr[] counts only the AG/AT/CG/CT
                  unordered pairs and h uses raw pair counts (:239-251)
  4 K2P           -0.5 ln((1-2p-q) sqrt(1-2q)) (:253-257)
  5 Tamura        gc1/gc2 counted on mismatch columns only (:260-264)
  6 Jin-Nei       0.5 (1/(1-2p-q) + 0.5/(1-2q) - 1.5) (:258)

Design: instead of the reference's per-pair column scan (a CUDA block
per pair with a shared-memory reduction), every pairwise count is
expressed through ONE int8 matmul with int32 accumulation, so counts
are exact (no float matmul, so TF32 cannot enter). Each sequence i becomes 5
indicator channels Phi[i] in {0,1}^[5, L] (A, C, G, T, nongap); then

    P = Phi_blk_i  @  Phi_blk_j^T     # [Bi*5, L] x [L, Bj*5] int8->int32

holds every joint count needed by all six models:
    P[a,b] (a,b<4) = pair count; P[a,4] = a vs non-gap; P[4,4] = tot.
`useful` additionally needs per-sequence non-gap totals (vector).
The count block is immediately reduced to distances, so only [Bi,Bj]
floats are materialized per tile.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def build_channels(codes: np.ndarray) -> np.ndarray:
    """uint8 [N, L] codes -> int8 [N, 5, L] indicator channels."""
    N, L = codes.shape
    out = np.zeros((N, 5, L), dtype=np.int8)
    for a in range(4):
        out[:, a, :] = codes == a
    out[:, 4, :] = codes < 4
    return out


def one_hot_channels(codes):
    """jnp uint8 [..., L] codes -> int8 [..., 5, L] indicator channels
    (device twin of build_channels, for on-the-fly expansion inside a
    jit — keeps the resident bank at [N, L] bytes instead of 5x)."""
    a = jnp.arange(4, dtype=codes.dtype)
    eq = codes[..., None, :] == a[(None,) * (codes.ndim - 1) + (slice(None), None)]
    ng = (codes[..., None, :] < 4)
    return jnp.concatenate([eq, ng], axis=-2).astype(jnp.int8)


def msa_tiled_block(codes_q, nongap_q, codes_bank, nongap_bank, *,
                    distance_type: int, dtype_name: str,
                    bank_tile: int = 4096):
    """[B, L] query codes x [Nb, L] bank codes -> [B, Nb] distances.

    The bank is kept as packed codes in device memory (1 byte/base);
    each tile of `bank_tile` rows is one-hot expanded on the fly and
    pushed through the same pair-count matmul as _block_distance — peak
    transient is one [tile, 5, L] int8 block instead of a resident
    [N, 5, L] bank (5 GB at 100K x 10kb).
    Identical math per pair => identical distances/trees."""
    L = codes_q.shape[1]
    Nb = codes_bank.shape[0]
    T = min(bank_tile, Nb)
    pad = (-Nb) % T
    if pad:
        codes_bank = jnp.concatenate(
            [codes_bank, jnp.broadcast_to(codes_bank[-1:],
                                          (pad, L))], axis=0)
        nongap_bank = jnp.concatenate(
            [nongap_bank, jnp.broadcast_to(nongap_bank[-1:], (pad,))])
    ntiles = (Nb + pad) // T
    phi_q = one_hot_channels(codes_q)

    def tile(s):
        cb = jax.lax.dynamic_slice_in_dim(codes_bank, s * T, T, axis=0)
        ngb = jax.lax.dynamic_slice_in_dim(nongap_bank, s * T, T, axis=0)
        return _block_distance(
            phi_q, one_hot_channels(cb), nongap_q, ngb,
            distance_type=distance_type, dtype_name=dtype_name, seq_len=L)

    if ntiles == 1:
        return tile(jnp.int32(0))[:, :Nb]
    tiles = jax.lax.map(tile, jnp.arange(ntiles, dtype=jnp.int32))
    B = codes_q.shape[0]
    return jnp.moveaxis(tiles, 0, 1).reshape(B, ntiles * T)[:, :Nb]


def pair_counts(phi_i, phi_j):
    """phi_i [Bi,5,L] int8, phi_j [Bj,5,L] int8 -> exact int32 joint
    counts [Bi, Bj, 5, 5]: one int8 matmul with int32 accumulation."""
    Bi, _, L = phi_i.shape
    Bj = phi_j.shape[0]
    return jax.lax.dot_general(
        phi_i.reshape(Bi * 5, L), phi_j.reshape(Bj * 5, L),
        (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32,
    ).reshape(Bi, 5, Bj, 5).transpose(0, 2, 1, 3)


@functools.partial(jax.jit, static_argnames=("distance_type", "dtype_name", "seq_len"))
def _block_distance(phi_i, phi_j, nongap_i, nongap_j, *, distance_type,
                    dtype_name, seq_len):
    """phi_i [Bi,5,L] int8, phi_j [Bj,5,L] int8 -> [Bi,Bj] distances."""
    dtype = jnp.dtype(dtype_name)
    Bi = phi_i.shape[0]
    Bj = phi_j.shape[0]
    P = pair_counts(phi_i, phi_j).astype(dtype)

    tot = P[:, :, 4, 4]
    match = P[:, :, 0, 0] + P[:, :, 1, 1] + P[:, :, 2, 2] + P[:, :, 3, 3]

    if distance_type in (1, 2):
        useful = nongap_i[:, None] + nongap_j[None, :] - tot
        uncor = 1.0 - match / useful
        if distance_type == 1:
            return uncor
        return -0.75 * jnp.log(1.0 - uncor / 0.75)

    p = P[:, :, 0, 2] + P[:, :, 2, 0] + P[:, :, 1, 3] + P[:, :, 3, 1]
    if distance_type == 3:
        frA = (P[:, :, 0, 4] + P[:, :, 4, 0]) / tot / 2.0
        frC = (P[:, :, 1, 4] + P[:, :, 4, 1]) / tot / 2.0
        frG = (P[:, :, 2, 4] + P[:, :, 4, 2]) / tot / 2.0
        frT = (P[:, :, 3, 4] + P[:, :, 4, 3]) / tot / 2.0
        prAG = P[:, :, 0, 2] + P[:, :, 2, 0]
        prAT = P[:, :, 0, 3] + P[:, :, 3, 0]
        prCG = P[:, :, 1, 2] + P[:, :, 2, 1]
        prCT = P[:, :, 1, 3] + P[:, :, 3, 1]
        h = 0.5 * (prAG * frA * frG + prAT * frA * frT
                   + prCG * frC * frG + prCT * frC * frT)
        DD = (tot - match) / tot
        b = 0.5 * (1.0 - frA * frA - frG * frG + DD * DD / h)
        return -b * jnp.log(1.0 - DD / b)

    q = tot - match - p
    pp = p / tot
    qq = q / tot
    if distance_type == 4:
        return -0.5 * jnp.log((1 - 2 * pp - qq) * jnp.sqrt(1 - 2 * qq))
    if distance_type == 6:
        return 0.5 * (1.0 / (1 - 2 * pp - qq) + 0.5 / (1 - 2 * qq) - 1.5)
    if distance_type == 5:
        gc1 = (P[:, :, 1, 4] - P[:, :, 1, 1]) + (P[:, :, 2, 4] - P[:, :, 2, 2])
        gc2 = (P[:, :, 4, 1] - P[:, :, 1, 1]) + (P[:, :, 4, 2] - P[:, :, 2, 2])
        c = gc1 / tot + gc2 / tot - 2.0 * gc1 * gc2 / tot / tot
        return -c * jnp.log(1 - pp / c - qq) - 0.5 * (1 - c) * jnp.log(1 - 2 * qq)
    return jnp.zeros((Bi, Bj), dtype)


def _pad_rows(x: np.ndarray, block: int):
    n = x.shape[0]
    pad = (-n) % block
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)
    return x, n


def msa_distance_matrix_device(
    codes: np.ndarray, distance_type: int, dtype="float32",
    row_block: int = 512
):
    """Full [N, N] distance matrix (symmetric, zero diagonal) as a
    DEVICE array — downstream consumers (NJ) run on device.

    Orientation note: the count matrix P uses a = row-side code
    ('ec' = tarRowId in the reference) and b = column-side ('et'); every
    model is symmetric in (gc1, gc2)/(frac)/(pr), so the matrix is
    symmetric and we compute whole row blocks at once.
    """
    N, L = codes.shape
    phi = build_channels(codes)
    nongap = phi[:, 4, :].sum(axis=1).astype(np.int64)

    phi_d = jnp.asarray(phi)
    nongap_d = jnp.asarray(nongap, jnp.dtype(dtype))
    rb = min(row_block, N)
    out = jnp.zeros((N, N), jnp.dtype(dtype))
    for s in range(0, N, rb):
        e = min(N, s + rb)
        s0 = min(s, N - rb)  # full-size block, recompute overlap
        blk = _block_distance(
            phi_d[s0:s0 + rb], phi_d, nongap_d[s0:s0 + rb], nongap_d,
            distance_type=distance_type, dtype_name=str(jnp.dtype(dtype)),
            seq_len=L,
        )
        out = jax.lax.dynamic_update_slice(out, blk, (s0, 0))
    iot = jnp.arange(N)
    out = jnp.where(iot[:, None] == iot[None, :], 0.0, out)
    return out

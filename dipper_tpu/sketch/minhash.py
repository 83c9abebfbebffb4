"""MinHash (Mash) sketching on the device.

Behavioral spec (src/mash.cu:239-369):
- every k-mer window j in [0, len-k] of the 2-bit-encoded sequence,
- canonical form = lexicographically smaller of the forward and
  reverse-complement CHARACTER strings (:311-321),
- hash = low 64 bits of MurmurHash3_x64_128(canonical chars, k,
  seed=42) (:320-323),
- sketch = the 1000 smallest hashes as a MULTISET (the block-sort
  keeps duplicates), ascending, padded with 0xFFFF... sentinels.

Design: the reference maintains a rolling bottom-1000 via repeated
cub::BlockRadixSort merges because it streams k-mers through shared
memory. Here all L hashes of a sequence are held in device memory at
once: every window is hashed vectorized (on explicit u32 limb pairs)
and the bottom-k taken with one sort. The CLI sketches on the host
(sketch/native.py); this path is its device twin (ROADMAP D4). The lexicographic
canonicalization never materializes strings: with MSB-first 2-bit
packing, lex order == numeric order, and the reverse complement in
MSB-first form is just the bitwise complement of the forward k-mer in
LSB-first form (see _canonical_kmers).

Only k <= 15 is supported (the CLI range is 2..15), so the murmur key
is < 16 bytes and only the tail path of the hash runs.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from dipper_tpu.io.encode import encode_2bit_codes

SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)

# 'A','C','G','T' ASCII bytes packed LSB-first into one u32: byte i of
# this constant is the character for 2-bit code i: a shift-based lookup
# of two elementwise ops instead of a gather.
_ASCII_PACKED = np.uint32(0x54474341)

# --- 64-bit arithmetic on explicit u32 limb pairs (hi, lo) ---------------
# Hand-rolled u32 limbs keep the unrolled murmur graph small (ROADMAP D4
# asks whether native u64 should replace them).

_C1 = (0x87C37B91, 0x114253D5)
_C2 = (0x4CF5AD43, 0x2745937F)
_F1 = (0xFF51AFD7, 0xED558CCD)
_F2 = (0xC4CEB9FE, 0x1A85EC53)


def _u32(c):
    return np.uint32(c)


def _xor(a, b):
    return (a[0] ^ b[0], a[1] ^ b[1])


def _add64(a, b):
    lo = a[1] + b[1]
    carry = jnp.where(lo < b[1], _u32(1), _u32(0))
    return (a[0] + b[0] + carry, lo)


def _shr64(a, r: int):
    hi, lo = a
    if r == 0:
        return a
    if r < 32:
        return (hi >> _u32(r), (lo >> _u32(r)) | (hi << _u32(32 - r)))
    if r == 32:
        return (jnp.zeros_like(hi), hi)
    return (jnp.zeros_like(hi), hi >> _u32(r - 32))


def _shl64(a, r: int):
    hi, lo = a
    if r == 0:
        return a
    if r < 32:
        return ((hi << _u32(r)) | (lo >> _u32(32 - r)), lo << _u32(r))
    if r == 32:
        return (lo, jnp.zeros_like(lo))
    return (lo << _u32(r - 32), jnp.zeros_like(lo))


def _rotl64(a, r: int):
    hi1, lo1 = _shl64(a, r)
    hi2, lo2 = _shr64(a, 64 - r)
    return (hi1 | hi2, lo1 | lo2)


def _mul32_full(x, y):
    """u32 * u32 -> (hi, lo) u64 product via 16-bit halves."""
    m16 = _u32(0xFFFF)
    xl = x & m16
    xh = x >> _u32(16)
    yl = y & m16
    yh = y >> _u32(16)
    ll = xl * yl
    lh = xl * yh
    hl = xh * yl
    hh = xh * yh
    mid = lh + (ll >> _u32(16))            # < 2^32, no overflow
    mid2 = hl + (mid & m16)                # < 2^32, no overflow
    hi = hh + (mid >> _u32(16)) + (mid2 >> _u32(16))
    lo = (mid2 << _u32(16)) | (ll & m16)
    return hi, lo


def _mul64(a, c):
    """(hi, lo) * constant (chi, clo) mod 2^64."""
    chi, clo = _u32(c[0]), _u32(c[1])
    hi, lo = _mul32_full(a[1], clo)
    hi = hi + a[1] * chi + a[0] * clo
    return (hi, lo)


def _fmix64(k):
    k = _xor(k, _shr64(k, 33))
    k = _mul64(k, _F1)
    k = _xor(k, _shr64(k, 33))
    k = _mul64(k, _F2)
    k = _xor(k, _shr64(k, 33))
    return k


def _murmur_tail_u32(k1, k2, klen: int):
    """MurmurHash3_x64_128 low 64 bits for keys of length klen in
    [1, 15]; k1/k2 are (hi, lo) u32 pairs of the little-endian key
    words. Returns (hi, lo)."""
    assert 1 <= klen <= 15
    z = jnp.zeros_like(k1[0])
    h1 = (z, z | _u32(42))
    h2 = (z, z | _u32(42))
    if klen > 8:
        kk2 = _mul64(k2, _C2)
        kk2 = _rotl64(kk2, 33)
        kk2 = _mul64(kk2, _C1)
        h2 = _xor(h2, kk2)
    kk1 = _mul64(k1, _C1)
    kk1 = _rotl64(kk1, 31)
    kk1 = _mul64(kk1, _C2)
    h1 = _xor(h1, kk1)
    h1 = (h1[0], h1[1] ^ _u32(klen))
    h2 = (h2[0], h2[1] ^ _u32(klen))
    h1 = _add64(h1, h2)
    h2 = _add64(h2, h1)
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = _add64(h1, h2)
    return h1


def murmur3_low64_tail(k1, k2, klen: int):
    """u64-interface wrapper (used by tests): k1/k2 little-endian u64
    key words -> low-64 hash as u64."""
    split = lambda x: ((x >> np.uint64(32)).astype(jnp.uint32),
                      (x & np.uint64(0xFFFFFFFF)).astype(jnp.uint32))
    hi, lo = _murmur_tail_u32(split(k1), split(k2), klen)
    return (hi.astype(jnp.uint64) << np.uint64(32)) | lo.astype(jnp.uint64)


def _canonical_kmers(codes, k: int):
    """codes: uint8 [B, L] 2-bit codes. Returns canonical k-mers in
    MSB-first (lexicographic) form, uint32 [B, L-k+1] (2k <= 30 bits)."""
    assert k <= 15
    B, L = codes.shape
    P = L - k + 1
    c32 = codes.astype(jnp.uint32)
    fwd_lex = jnp.zeros((B, P), jnp.uint32)
    fwd_lsb = jnp.zeros((B, P), jnp.uint32)
    for i in range(k):
        c = c32[:, i : i + P]
        # lex (MSB-first) form: window position i at bit 2*(k-1-i)
        fwd_lex = fwd_lex | (c << np.uint32(2 * (k - 1 - i)))
        fwd_lsb = fwd_lsb | (c << np.uint32(2 * i))
    mask = np.uint32((1 << (2 * k)) - 1)
    # reverse complement in lex form: rev_lex_i = 3 - b_{k-1-i}, i.e.
    # sum_m (3-b_m) << 2m = bitwise complement of the LSB-first form
    rev_lex = (~fwd_lsb) & mask
    return jnp.minimum(fwd_lex, rev_lex)


def _kmer_key_words(canon, k: int):
    """Canonical k-mer (lex form) -> little-endian murmur key words of
    the ASCII character string, as u32 limb pairs (hi, lo)."""
    z = jnp.zeros_like(canon)
    k1lo = z
    k1hi = z
    k2lo = z
    k2hi = z
    for i in range(k):
        code = (canon >> np.uint32(2 * (k - 1 - i))) & np.uint32(3)
        b = (_ASCII_PACKED >> (code << np.uint32(3))) & np.uint32(0xFF)
        if i < 4:
            k1lo = k1lo | (b << np.uint32(8 * i))
        elif i < 8:
            k1hi = k1hi | (b << np.uint32(8 * (i - 4)))
        elif i < 12:
            k2lo = k2lo | (b << np.uint32(8 * (i - 8)))
        else:
            k2hi = k2hi | (b << np.uint32(8 * (i - 12)))
    return (k1hi, k1lo), (k2hi, k2lo)


_SORT_TILE = 2048


def _pad_cols(hi, lo, width: int):
    B, P = hi.shape
    if P >= width:
        return hi, lo
    sent = np.uint32(0xFFFFFFFF)
    pad = jnp.full((B, width - P), sent, jnp.uint32)
    return (jnp.concatenate([hi, pad], axis=1),
            jnp.concatenate([lo, pad], axis=1))


def _bottom_k_sorted(hi, lo, kk: int):
    """Exact bottom-kk of each row of u64 values given as (hi, lo) u32
    pairs; returns ascending [B, kk] pairs, sentinel-padded. Rows are
    selected tile-wise: sort power-of-two tiles, keep each
    tile's bottom min(TILE, kk) — a superset of its contribution to the
    global bottom-kk — then sort the concatenated candidates once."""
    B, P = hi.shape
    if P <= _SORT_TILE:
        w = max(kk, 1)
        w = 1 << int(np.ceil(np.log2(max(P, w))))
        hi, lo = _pad_cols(hi, lo, w)
        hi_s, lo_s = jax.lax.sort((hi, lo), num_keys=2, dimension=1)
        return hi_s[:, :kk], lo_s[:, :kk]
    T = -(-P // _SORT_TILE)
    hi, lo = _pad_cols(hi, lo, T * _SORT_TILE)
    cap = min(_SORT_TILE, kk)
    hi_t = hi.reshape(B, T, _SORT_TILE)
    lo_t = lo.reshape(B, T, _SORT_TILE)
    hi_t, lo_t = jax.lax.sort((hi_t, lo_t), num_keys=2, dimension=2)
    hi_c = hi_t[:, :, :cap].reshape(B, T * cap)
    lo_c = lo_t[:, :, :cap].reshape(B, T * cap)
    return _bottom_k_sorted(hi_c, lo_c, kk)


@functools.partial(jax.jit, static_argnames=("k", "sketch_size"))
def sketch_batch_device(codes, lengths, *, k: int, sketch_size: int):
    """codes uint8 [B, L] (padded), lengths int32 [B] ->
    sorted uint64 sketches [B, sketch_size] (sentinel-padded).

    Everything up to the final combine runs in native u32 (limb
    murmur, tiled two-key bottom-k); only the [B, sketch_size] output
    is u64."""
    B, L = codes.shape
    P = L - k + 1
    canon = _canonical_kmers(codes, k)
    k1, k2 = _kmer_key_words(canon, k)
    hi, lo = _murmur_tail_u32(k1, k2, k)
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, P), 1)
    valid = pos <= (lengths[:, None] - k)
    sent = np.uint32(0xFFFFFFFF)
    hi = jnp.where(valid, hi, sent)
    lo = jnp.where(valid, lo, sent)
    hi_s, lo_s = _bottom_k_sorted(hi, lo, sketch_size)
    hi_s, lo_s = _pad_cols(hi_s, lo_s, sketch_size)
    return (hi_s.astype(jnp.uint64) << np.uint64(32)) | \
        lo_s.astype(jnp.uint64)


@functools.partial(jax.jit, static_argnames=("k", "sketch_size"))
def sketch_batch_device_packed(words, lengths, *, k: int, sketch_size: int):
    """Like sketch_batch_device but takes 2-bit codes PACKED 16-per-
    int32-word LSB-first (pack_2bit layout) — 4x less host->device
    traffic. Unpacks on device."""
    B, W = words.shape
    w = words.astype(jnp.uint32)  # int32 -> uint32 is mod 2^32 (bit-exact)
    shifts = (jnp.arange(16, dtype=jnp.uint32) * 2)[None, None, :]
    codes = ((w[:, :, None] >> shifts) & np.uint32(3)).astype(jnp.uint8)
    codes = codes.reshape(B, W * 16)
    return sketch_batch_device(codes, lengths, k=k, sketch_size=sketch_size)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# Rows/bases per device dispatch: large batches amortize the per-
# dispatch latency while keeping the ~10 live [B, P] u32 intermediates
# of the hash+sort pipeline under ~2 GB of device memory.
_MAX_BATCH_ROWS = 4096
_MAX_BATCH_BASES = 48_000_000


def sketch_sequences(seqs, k: int, sketch_size: int = 1000,
                     batch_size: int | None = None, as_device: bool = False):
    """Host driver: encode + sketch a list of byte sequences.
    Returns uint64 [N, sketch_size] (each row ascending) — a NumPy
    array by default, or the device-resident array with
    `as_device=True` (skips the device->host copy; callers that
    immediately rank-compress should use it).

    Host work per batch is two LUT/OR passes (fused ASCII->packed-2bit,
    encode_pack_2bit_matrix) over a padded byte matrix; everything else
    (hashing, canonicalization, bottom-k sort) runs in one device
    dispatch per batch, with device_put async so batch i+1's H2D
    overlaps batch i's sketch."""
    from dipper_tpu.io.encode import encode_pack_2bit_matrix

    N = len(seqs)
    lengths = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=N)
    order = np.argsort(lengths, kind="stable")
    chunks = []
    s = 0
    while s < N:
        # size the batch by an upper bound on its longest sequence
        # (order is ascending, so the window's last entry bounds it)
        Lub = max(int(lengths[order[min(s + _MAX_BATCH_ROWS, N) - 1]]), k)
        B = batch_size or int(np.clip(
            _MAX_BATCH_BASES // Lub, 128, _MAX_BATCH_ROWS))
        idx = order[s : s + B]
        s += B
        Lmax = max(int(lengths[idx[-1]]), k)
        # pad L to a small set of shapes to limit recompilation
        Lpad = _round_up(Lmax, 256) if Lmax <= 2048 else _round_up(Lmax, 2048)
        lens = lengths[idx].astype(np.int32)
        # pad the ROW count too (sentinel rows) so every dispatch in a
        # run reuses one compiled shape; sliced off after concatenation
        Bpad = len(idx) if batch_size else min(
            _round_up(len(idx), 512),
            int(np.clip(_MAX_BATCH_BASES // max(Lpad, 1), 128,
                        _MAX_BATCH_ROWS)))
        ascii_mat = np.zeros((max(Bpad, len(idx)), Lpad), dtype=np.uint8)
        if lens.min() == lens.max():
            # uniform lengths (the AliSim/RNASim benchmark shape):
            # one frombuffer over the concatenated batch
            cat = b"".join(seqs[i] for i in idx)
            ascii_mat[: len(idx), : lens[0]] = np.frombuffer(
                cat, dtype=np.uint8).reshape(len(idx), lens[0])
        else:
            for r, i in enumerate(idx):
                ascii_mat[r, : lens[r]] = np.frombuffer(seqs[i],
                                                        dtype=np.uint8)
        words = encode_pack_2bit_matrix(ascii_mat)
        lens_pad = np.zeros(ascii_mat.shape[0], np.int32)
        lens_pad[: len(idx)] = lens
        out = sketch_batch_device_packed(
            jax.device_put(words), jax.device_put(lens_pad), k=k,
            sketch_size=sketch_size)
        chunks.append(out[: len(idx)] if out.shape[0] != len(idx) else out)
    sk = chunks[0] if len(chunks) == 1 else jnp.concatenate(chunks, axis=0)
    if not np.array_equal(order, np.arange(N)):  # uniform lengths: no-op
        inv = np.empty(N, dtype=np.int32)
        inv[order] = np.arange(N, dtype=np.int32)
        sk = jnp.take(sk, jnp.asarray(inv), axis=0)
    if as_device:
        return sk
    return np.asarray(jax.device_get(sk))

"""Mash pipeline: murmur bit-exactness, sketch equality, merge-count
equivalence, full-matrix + CLI end-to-end."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dipper_tpu.sketch.minhash import (
    murmur3_low64_tail, sketch_sequences, sketch_batch_device,
)
from dipper_tpu.distance.mash import (
    rank_compress, pad_ranks, mash_distance_matrix_device,
    _merged_inter_count,
)
from dipper_tpu.io.encode import encode_2bit_codes

import oracle
from datagen import simulate_unaligned, write_fasta


def test_murmur_bit_exact():
    rng = np.random.default_rng(0)
    for klen in range(2, 16):
        keys = [bytes(rng.integers(65, 90, klen).astype(np.uint8)) for _ in range(64)]
        want = np.array([oracle.murmur3_x64_128_low64(kb) for kb in keys],
                        dtype=np.uint64)
        k1 = np.zeros(64, dtype=np.uint64)
        k2 = np.zeros(64, dtype=np.uint64)
        for i, kb in enumerate(keys):
            k1[i] = int.from_bytes(kb[:8].ljust(8, b"\0"), "little")
            k2[i] = int.from_bytes(kb[8:].ljust(8, b"\0"), "little")
        got = np.asarray(murmur3_low64_tail(jnp.asarray(k1), jnp.asarray(k2), klen))
        assert (got == want).all(), klen


@pytest.mark.parametrize("k", [4, 11, 15])
def test_sketch_matches_oracle(k):
    rng = np.random.default_rng(k)
    seqs = []
    for L in [k, k + 1, 37, 200, 1500]:
        seqs.append(bytes(rng.choice(list(b"ACGT"), L).astype(np.uint8)))
    # duplicate-rich sequence (repeats -> duplicate hashes in bottom-k)
    seqs.append(bytes(b"ACGT" * 100))
    sk = sketch_sequences(seqs, k, sketch_size=100)
    for i, s in enumerate(seqs):
        want = oracle.mash_sketch(encode_2bit_codes(s), k, 100)
        assert (sk[i] == want).all(), (i, len(s))


def _adversarial_pair(rng, S, heavy):
    """Two ascending rank rows of width S, padded with pad keys: a
    small value universe forces duplicates and cross-duplicates; `heavy`
    adds long sentinel-like runs of the largest value."""
    univ = max(60, S // 2)
    a = np.sort(rng.integers(0, univ, S))
    b = np.sort(rng.integers(0, univ, S))
    if heavy:
        a[-(3 * S // 10):] = univ - 1
        b[-(45 * S // 100):] = univ - 1
    return (pad_ranks(a[None].astype(np.int32))[0],
            pad_ranks(b[None].astype(np.int32))[0])


@pytest.mark.parametrize("S", [100, 128, 1000])
@pytest.mark.parametrize("seed", range(6))
def test_merge_count_equivalence(S, seed):
    """Vectorized merged-count == serial walk on adversarial multisets,
    at sketch widths with and without pad keys (M = pow2 >= S)."""
    rng = np.random.default_rng(seed)
    M = 1 << int(np.ceil(np.log2(S)))
    a_pad, b_pad = _adversarial_pair(rng, S, heavy=seed % 2 == 1)
    assert a_pad.shape == (M,)
    want = oracle.mash_inter(a_pad[:S], b_pad[:S], S)
    got = int(_merged_inter_count(
        jnp.asarray(a_pad * 2 + 1)[None, :], jnp.asarray(b_pad * 2)[None, :], S
    )[0])
    assert got == want


def test_pad_ranks_keys_sort_last():
    """pad_ranks widens rows to the next power of two with one pad key
    that sorts after every real rank and keeps tagged keys (2r+1) inside
    int32; host and device inputs pad alike."""
    r = np.array([[0, 5, 9], [1, 2, 3]], np.int32)
    host = pad_ranks(r)
    dev = np.asarray(pad_ranks(jnp.asarray(r)))
    assert host.shape == (2, 4) and isinstance(host, np.ndarray)
    np.testing.assert_array_equal(host, dev)
    pad = host[0, 3]
    assert pad > r.max() and 2 * int(pad) + 1 <= np.iinfo(np.int32).max
    assert pad_ranks(host) is host  # already a power of two


@pytest.mark.parametrize("platform,kernel", [("cuda", True), ("cpu", False)])
def test_pairwise_inter_picks_impl_by_platform(platform, kernel):
    """mash_pairwise_inter lowers to the CUDA kernel for a GPU and to
    the XLA merge network for the CPU, nothing else in either case."""
    from dipper_tpu.distance.mash import mash_pairwise_inter

    bank = jax.ShapeDtypeStruct((50, 128), jnp.int32)
    q = jax.ShapeDtypeStruct((7, 128), jnp.int32)
    f = jax.jit(lambda b, x: mash_pairwise_inter(b, x, sketch_size=100))
    txt = f.trace(bank, q).lower(lowering_platforms=(platform,)).as_text()
    assert ("dipper_mash_inter" in txt) == kernel
    assert ("stablehlo.minimum" in txt) == (not kernel)


def test_pairwise_inter_kernel_batches_under_vmap():
    """Under jax.vmap the kernel is one call on [c, N, M] x [c, Q, M]
    with a [c, Q, N] result; forced XLA impls keep the CPU merge."""
    from dipper_tpu.distance.mash import mash_pairwise_inter

    bank = jax.ShapeDtypeStruct((3, 50, 128), jnp.int32)
    q = jax.ShapeDtypeStruct((3, 7, 128), jnp.int32)
    g = jax.jit(jax.vmap(
        lambda b, x: mash_pairwise_inter(b, x, sketch_size=100)))
    assert jax.eval_shape(g, bank, q) == jax.ShapeDtypeStruct(
        (3, 7, 50), jnp.int32)
    txt = g.trace(bank, q).lower(lowering_platforms=("cuda",)).as_text()
    calls = [ln for ln in txt.splitlines() if "dipper_mash_inter" in ln]
    assert len(calls) == 1 and "tensor<3x50x128xi32>" in calls[0]
    forced = jax.jit(jax.vmap(lambda b, x: mash_pairwise_inter(
        b, x, sketch_size=100, impl="map")))
    txt = forced.trace(bank, q).lower(lowering_platforms=("cuda",)).as_text()
    assert "dipper_mash_inter" not in txt


def test_pairwise_inter_impls_agree():
    """'auto' (the CPU merge here) and 'map' give identical int32
    counts, batched or not, equal to the serial walk."""
    from dipper_tpu.distance.mash import mash_pairwise_inter

    rng = np.random.default_rng(4)
    S = 100
    rows = [_adversarial_pair(rng, S, heavy=i % 2 == 1)
            for i in range(6)]
    bank = np.stack([r[0] for r in rows])
    q = np.stack([r[1] for r in rows[:4]])
    want = np.array([[oracle.mash_inter(a[:S], b[:S], S) for a in bank]
                     for b in q])
    for impl in ("auto", "map"):
        got = np.asarray(mash_pairwise_inter(
            jnp.asarray(bank), jnp.asarray(q), sketch_size=S, impl=impl))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    batched = np.asarray(jax.vmap(
        lambda b, x: mash_pairwise_inter(b, x, sketch_size=S))(
            jnp.asarray(np.stack([bank, bank[::-1]])),
            jnp.asarray(np.stack([q, q]))))
    np.testing.assert_array_equal(batched[0], want)
    np.testing.assert_array_equal(batched[1], want[:, ::-1])


@pytest.mark.gpu
@pytest.mark.parametrize("S", [100, 1000])
def test_gpu_kernel_matches_merge(gpu_device, S):
    """The CUDA kernel's counts equal the XLA merge's bitwise, batched
    and not (chip_smoke.py repeats this at bank width 30,000)."""
    from dipper_tpu.distance.mash import mash_pairwise_inter

    rng = np.random.default_rng(S)
    rows = [_adversarial_pair(rng, S, heavy=i % 3 == 0)
            for i in range(70)]
    bank = jnp.asarray(np.stack([r[0] for r in rows]))
    q = jnp.asarray(np.stack([r[1] for r in rows[:19]]))
    got = np.asarray(mash_pairwise_inter(bank, q, sketch_size=S))
    want = np.asarray(mash_pairwise_inter(bank, q, sketch_size=S,
                                          impl="map"))
    np.testing.assert_array_equal(got, want)
    got_b = np.asarray(jax.vmap(
        lambda b, x: mash_pairwise_inter(b, x, sketch_size=S))(
            jnp.stack([bank, bank[::-1]]), jnp.stack([q, q])))
    np.testing.assert_array_equal(got_b[0], want)
    np.testing.assert_array_equal(got_b[1], want[:, ::-1])


def test_mash_matrix_matches_oracle():
    rng = np.random.default_rng(5)
    names, seqs = simulate_unaligned(10, 400, rng)
    k, S = 12, 64
    sk = sketch_sequences(seqs, k, sketch_size=S)
    got = mash_distance_matrix_device(sk, k, S, dtype="float64")
    N = len(seqs)
    want = np.zeros((N, N))
    for i in range(N):
        for j in range(i):
            want[i, j] = want[j, i] = oracle.mash_distance(sk[j], sk[i], k, S)
    assert np.allclose(got, want, rtol=1e-12, atol=1e-12)


def test_cli_mash_nj(tmp_path):
    from dipper_tpu.cli import main
    from dipper_tpu.utils.treecmp import rf_distance
    from oracle import neighbor_joining, nj_newick

    rng = np.random.default_rng(8)
    names, seqs = simulate_unaligned(15, 2000, rng)
    inp = tmp_path / "in.fa"
    outp = tmp_path / "out.nwk"
    write_fasta(str(inp), names, seqs)
    rc = main(["-i", "r", "-I", str(inp), "-O", str(outp), "-k", "12",
               "-s", "200", "--precision", "f64", "--seed", "-1"])
    assert rc == 0

    sk = sketch_sequences(seqs, 12, 200)
    N = len(seqs)
    D = np.zeros((N, N))
    for i in range(N):
        for j in range(i):
            D[i, j] = D[j, i] = oracle.mash_distance(sk[j], sk[i], 12, 200)
    children, root = neighbor_joining(D)
    want = nj_newick(children, root, names)
    rf, _ = rf_distance(outp.read_text(), want)
    assert rf == 0


def test_rank_compress_host_equivalent():
    """Host np.unique ranks vs device hierarchical-sort ranks: values
    differ (consecutive vs first-iota-of-run) but order and equality —
    the only properties mash_rows_vs_bank consumes — must match, and
    the resulting distances must be bitwise identical."""
    from dipper_tpu.distance.mash import rank_compress_host, mash_rows_vs_bank

    rng = np.random.default_rng(7)
    # duplicate- and sentinel-heavy bank
    vals = rng.integers(0, 50, (16, 64)).astype(np.uint64) * np.uint64(2**40)
    vals.sort(axis=1)
    dev = np.asarray(rank_compress(jnp.asarray(vals)))
    host = rank_compress_host(vals)
    fd, fh = dev.reshape(-1), host.reshape(-1)
    order = np.argsort(fd, kind="stable")
    # same equal-runs and same ordering between the two rank assignments
    assert (np.diff(fd[order]) > 0).sum() == (np.diff(fh[order]) > 0).sum()
    assert ((np.diff(fd[order]) == 0) == (np.diff(fh[order]) == 0)).all()
    d_dev = np.asarray(mash_rows_vs_bank(
        pad_ranks(jnp.asarray(dev)), pad_ranks(jnp.asarray(dev))[3],
        k=15, sketch_size=64, dtype_name="float64"))
    d_host = np.asarray(mash_rows_vs_bank(
        pad_ranks(jnp.asarray(host)), pad_ranks(jnp.asarray(host))[3],
        k=15, sketch_size=64, dtype_name="float64"))
    np.testing.assert_array_equal(d_dev, d_host)


def test_dist_table_matches_reference_formula():
    """The [S+1] host lookup table must equal the reference's per-pair
    formula d = min(1, |ln(2j/(1+j))|/k), j = max(inter,1)/S
    (src/mash.cu:453-454) evaluated in plain python floats — the table
    exists so every dispatch shape/backend yields these exact values."""
    import math

    from dipper_tpu.distance.mash import _dist_table

    for k, S in ((15, 1000), (12, 100), (9, 17)):
        tab = _dist_table(k, S, "float64")
        assert tab.shape == (S + 1,)
        for inter in (0, 1, 2, S // 3, S - 1, S):
            j = max(inter, 1) / S
            want = min(1.0, abs(math.log(2.0 * j / (1.0 + j)) / k))
            assert tab[inter] == want, (k, S, inter)
        # monotone non-increasing in inter
        assert (tab[1:] <= tab[:-1] + 1e-18).all()

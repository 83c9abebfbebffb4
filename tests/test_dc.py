"""Divide-and-conquer pipeline vs the transliterated DC oracle."""

import numpy as np
import pytest

from dipper_tpu.utils.params import Param
from dipper_tpu.utils.treecmp import rf_distance

import oracle as orc
from oracle import DCOracle
from datagen import simulate_unaligned, write_fasta


def _mash_matrix(seqs, k, ss):
    from dipper_tpu.sketch.minhash import sketch_sequences

    sk = sketch_sequences(seqs, k, ss)
    n = len(seqs)
    D = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i != j:
                # d(row=i placed-side j): oracle signature (a=placed, b=new)
                D[i, j] = orc.mash_distance(sk[j], sk[i], k, ss)
    return D


@pytest.mark.parametrize("n,b", [(40, 10), (60, 12), (90, 14)])
def test_dc_matrix_matches_oracle_exact(n, b):
    """Bitwise test path: both oracle and engine consume the same
    precomputed doubles, so every decision must match exactly."""
    from dipper_tpu.dc.pipeline import build_dc_tree_from_matrix
    from test_nj import random_additive_matrix

    rng = np.random.default_rng(n)
    D = random_additive_matrix(n, rng)
    D += rng.uniform(0, 0.02, D.shape)
    D = (D + D.T) / 2
    np.fill_diagonal(D, 0)
    D = D / (D.max() * 1.05)

    o = DCOracle(b, n)
    o.run_dc(lambda i: D[i])
    names = [f"L{i}" for i in range(n)]
    want = o.to_newick(names)

    params = Param(in_format="d", dtype="float64",
                   backbone_size=b, batch_size=b)
    got = build_dc_tree_from_matrix(D, names, params)
    rf, nrf = rf_distance(got, want)
    assert rf == 0, f"nRF={nrf}\nwant={want[:300]}\ngot={got[:300]}"


@pytest.mark.parametrize("n,b", [(40, 10)])
def test_dc_mash_close_to_oracle(n, b):
    """Sequence-input path: engine computes distances internally (XLA
    log vs numpy log can differ in the last ulp, flipping exact score
    ties), so allow a small nRF."""
    rng = np.random.default_rng(n)
    names, seqs = simulate_unaligned(n, 1500, rng)
    k, ss = 12, 150
    D = _mash_matrix(seqs, k, ss)

    o = DCOracle(b, n)
    o.run_dc(lambda i: D[i])
    want = o.to_newick(names)

    from dipper_tpu.dc import build_dc_tree

    params = Param(kmer_size=k, sketch_size=ss, in_format="r",
                   dtype="float64", backbone_size=b, batch_size=b)
    got = build_dc_tree(seqs, names, params)

    rf, nrf = rf_distance(got, want)
    assert nrf <= 0.1, f"nRF={nrf}"


def test_dc_msa_matches_oracle():
    from dipper_tpu.io.encode import batch_codes, encode_4bit_codes
    from datagen import simulate_alignment

    rng = np.random.default_rng(5)
    names, seqs = simulate_alignment(50, 800, rng, gap_frac=0.03,
                                     blen_scale=0.5)
    codes, _ = batch_codes(seqs, encode_4bit_codes, pad_value=4)
    D = orc.msa_distance_matrix(codes, 2)

    b = 10
    o = DCOracle(b, len(seqs))
    o.run_dc(lambda i: D[i])
    want = o.to_newick(names)

    from dipper_tpu.dc import build_dc_tree

    params = Param(distance_type=2, in_format="m", dtype="float64",
                   backbone_size=b, batch_size=b)
    got = build_dc_tree(seqs, names, params)
    rf, nrf = rf_distance(got, want)
    assert rf == 0, f"nRF={nrf}"


def test_dc_multichunk_phase2_and_packed_phase3(monkeypatch):
    """Force the multi-chunk regimes (VERDICT r2 #9): phase 2 with
    N-B spanning many chunks and phase 3 with several cluster-build
    dispatches (PHASE3_BUDGET < nclusters*cmax), with B >= 64. Output
    must be bitwise-identical to the single-chunk configuration."""
    import dipper_tpu.dc.pipeline as pl
    from dipper_tpu.dc.pipeline import build_dc_tree_from_matrix
    from test_nj import random_additive_matrix

    n, b = 320, 64
    rng = np.random.default_rng(11)
    D = random_additive_matrix(n, rng)
    D += rng.uniform(0, 0.02, D.shape)
    D = (D + D.T) / 2
    np.fill_diagonal(D, 0)
    D = D / (D.max() * 1.05)
    names = [f"L{i}" for i in range(n)]
    params = Param(in_format="d", dtype="float64",
                   backbone_size=b, batch_size=b)

    want = build_dc_tree_from_matrix(D, names, params)

    monkeypatch.setattr(pl, "PHASE2_CHUNK", 48)   # (320-64)/48 -> 6 chunks
    monkeypatch.setattr(pl, "PHASE3_BUDGET", 8)   # several build dispatches
    got = build_dc_tree_from_matrix(D, names, params)
    assert got == want

    # force the phase-2 MACRO split too (several async whole-phase
    # dispatches, tail macro overlapping): still bitwise-identical
    monkeypatch.setattr(pl, "PHASE2_MACRO_PAIRS", 48 * b * 2)  # 2-chunk macros
    got_macro = build_dc_tree_from_matrix(D, names, params)
    assert got_macro == want

    # big-backbone fallback (PHASE2_MAP_MAX_B exceeded): per-chunk
    # async dispatches instead of the lax.map whole-phase program
    monkeypatch.setattr(pl, "PHASE2_MAP_MAX_B", 0)
    got_chunked = build_dc_tree_from_matrix(D, names, params)
    assert got_chunked == want

    o = DCOracle(b, n)
    o.run_dc(lambda i: D[i])
    rf, nrf = rf_distance(got, o.to_newick(names))
    assert rf == 0, f"nRF={nrf}"


def test_dc_size_buckets_and_big_cluster_path(monkeypatch):
    """Heavy-tailed cluster sizes (one backbone edge attracting
    thousands of queries while the median cluster is tiny). Forcing
    many small sub-batches per pow2 bucket must leave the tree bitwise
    unchanged: bucket-local node-id remapping and the batched mash
    distances produce the same Dq/build results."""
    import dipper_tpu.dc.pipeline as pl
    from dipper_tpu.dc.pipeline import build_dc_tree
    from dipper_tpu.utils.treecmp import rf_distance as rf

    rng = np.random.default_rng(17)
    names, seqs = simulate_unaligned(150, 900, rng)
    params = Param(in_format="r", kmer_size=12, sketch_size=100,
                   dtype="float64", backbone_size=12, batch_size=12)

    want = build_dc_tree(seqs, names, params)

    monkeypatch.setattr(pl, "PHASE3_BUDGET", 16)
    got = build_dc_tree(seqs, names, params)
    assert got == want


def test_dc_streaming_big_cluster_path(monkeypatch):
    """Clusters above _STREAM_CLUSTER_MIN build with streamed distance
    rows (no [cmax, W] precompute — the N=100K quadratic-memory OOM)
    and the frontier-compact witness BFS. Forcing the threshold down
    must leave every tree identical to the default (precomputed-Dq,
    dense-BFS) path: integer intersection counts are impl-independent
    and the BFS variants are state-equivalent."""
    import dipper_tpu.dc.pipeline as pl
    from dipper_tpu.dc.pipeline import build_dc_tree
    from dipper_tpu.utils.treecmp import rf_distance as rf

    rng = np.random.default_rng(23)
    names, seqs = simulate_unaligned(150, 900, rng)
    params = Param(in_format="r", kmer_size=12, sketch_size=100,
                   dtype="float64", backbone_size=12, batch_size=12)

    want = build_dc_tree(seqs, names, params)

    # every cluster >= 8 members streams, with several row blocks AND
    # several insertion-range dispatches per cluster (the carry-chunked
    # driver; _STREAM_STEP must stay a multiple of the row block)
    monkeypatch.setattr(pl, "_STREAM_CLUSTER_MIN", 8)
    monkeypatch.setattr(pl, "_STREAM_ROW_BLOCK", 4)
    monkeypatch.setattr(pl, "_STREAM_STEP", 8)
    got = build_dc_tree(seqs, names, params)
    r, nrf = rf(got, want)
    assert r == 0, f"nRF={nrf}"
    assert got == want  # branch lengths bitwise too


def test_dc_streaming_msa_and_matrix(monkeypatch):
    """The streamed big-cluster build now covers every frontend (the
    quadratic [cmax, W] precompute was still reachable for -i m / -i d
    runs with a dominant cluster). Matrix rows are gathered from the
    resident matrix, so the forced-stream tree is byte-identical; MSA
    rows go through msa_tiled_block whose pair counts are integer-exact
    (the log conversion may differ in the last ulp between programs, so
    the assertion is topology+lengths via rf, with byte equality
    expected in practice)."""
    import dipper_tpu.dc.pipeline as pl
    from dipper_tpu.dc.pipeline import build_dc_tree, build_dc_tree_from_matrix
    from dipper_tpu.io.encode import batch_codes, encode_4bit_codes
    from dipper_tpu.utils.treecmp import rf_distance as rf
    from datagen import simulate_alignment

    rng = np.random.default_rng(29)
    names, seqs = simulate_alignment(120, 700, rng, gap_frac=0.03,
                                     blen_scale=0.5)
    params = Param(distance_type=2, in_format="m", dtype="float64",
                   backbone_size=10, batch_size=10)
    want_msa = build_dc_tree(seqs, names, params)

    codes, _ = batch_codes(seqs, encode_4bit_codes, pad_value=4)
    D = orc.msa_distance_matrix(codes, 2)
    params_m = Param(in_format="d", dtype="float64",
                     backbone_size=10, batch_size=10)
    want_mat = build_dc_tree_from_matrix(D, names, params_m)

    monkeypatch.setattr(pl, "_STREAM_CLUSTER_MIN", 8)
    monkeypatch.setattr(pl, "_STREAM_ROW_BLOCK", 4)
    got_msa = build_dc_tree(seqs, names, params)
    got_mat = build_dc_tree_from_matrix(D, names, params_m)

    r, nrf = rf(got_msa, want_msa)
    assert r == 0, f"msa stream nRF={nrf}"
    assert got_mat == want_mat  # byte-identical (no float conversion)

"""f32 topology parity (SURVEY §7.3, VERDICT r2 #7).

Production defaults to float32 (utils/params.py); every oracle
comparison elsewhere runs f64.

Measured precision semantics (documented, not hidden):
- NJ, exact placement, MSA-frontend placement: f32 reproduces the f64
  topology EXACTLY (nRF=0) — asserted below.
- mash-frontend placement and D&C: mash distances are quantized to
  ~sketch_size+1 values (j = inter/S), so score TIES are pervasive and
  f32-vs-f64 rounding reorders them; the trees genuinely differ
  (measured nRF(f32,f64) ~0.26 at n=60) while being EQUALLY ACCURATE
  against the generating true tree (measured 0.32 f32 vs 0.37 f64).
  The suite therefore asserts quality parity vs the true tree, not
  topology identity. The reference has the same sensitivity: its
  thrust::min_element tie order is thread-scan order over doubles.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dipper_tpu.placement import kclosest
from dipper_tpu.utils.treecmp import rf_distance

from datagen import simulate_unaligned, simulate_alignment
from test_nj import random_additive_matrix


def _newick_k(e, belong, length, names, n):
    return kclosest.edges_to_newick(*jax.device_get((e, belong, length)),
                                    names, n)


def test_nj_f32_topology():
    from dipper_tpu.nj import neighbor_joining_device, nj_tree_newick

    n = 120
    rng = np.random.default_rng(21)
    D = random_additive_matrix(n, rng)
    names = [f"T{i}" for i in range(n)]
    ch64, r64 = neighbor_joining_device(D, dtype="float64")
    ch32, r32 = neighbor_joining_device(D, dtype="float32")
    rf, _ = rf_distance(nj_tree_newick(ch64, r64, names),
                        nj_tree_newick(ch32, r32, names))
    assert rf == 0


def test_kclosest_msa_f32_topology():
    from dipper_tpu.io.encode import batch_codes, encode_4bit_codes

    rng = np.random.default_rng(31)
    names, seqs = simulate_alignment(40, 1200, rng)
    codes, _ = batch_codes(seqs, encode_4bit_codes, pad_value=4)
    nongap64 = jnp.asarray((codes < 4).sum(axis=1), jnp.float64)
    n = len(seqs)

    def build(dtype_name, nongap):
        e, b, l = kclosest.run_placement(
            (jnp.asarray(codes), nongap), num_sequences=n, frontend="msa",
            frontend_static=(2,), dtype_name=dtype_name)
        return _newick_k(e, b, l, names, n)

    rf, _ = rf_distance(build("float64", nongap64),
                        build("float32", nongap64.astype(jnp.float32)))
    assert rf == 0


def _true_tree_data(n, L, seed):
    import sys

    sys.path.insert(0, "scripts")
    from make_dataset import evolve, random_tree, tree_newick

    rng = np.random.default_rng(seed)
    children, blen, root = random_tree(n, rng, 0.2)
    names = [f"S{i}" for i in range(n)]
    true = tree_newick(children, blen, root, names)
    leaves = evolve(children, blen, root, n, L, rng)
    ACGT = np.frombuffer(b"ACGT", np.uint8)
    seqs = []
    for i in range(n):
        arr = ACGT[leaves[i]]
        keep = rng.random(L) >= 0.02
        seqs.append(arr[keep].tobytes())
    return names, seqs, true


def test_kclosest_mash_f32_quality_parity():
    """Mash-frontend f32 vs f64: trees differ (quantized-distance tie
    reshuffling, see module docstring) but must be equally accurate
    against the generating true tree."""
    from dipper_tpu.distance.mash import rank_compress, pad_ranks
    from dipper_tpu.sketch.minhash import sketch_sequences

    n, L, k, ss = 60, 3000, 12, 200
    names, seqs, true = _true_tree_data(n, L, 31)
    sk = sketch_sequences(seqs, k, ss)
    ranks = pad_ranks(rank_compress(jnp.asarray(sk)))

    def build(dtype_name):
        e, b, l = kclosest.run_placement(
            (ranks,), num_sequences=n, frontend="mash",
            frontend_static=(k, ss), dtype_name=dtype_name)
        return _newick_k(e, b, l, names, n)

    nrf64 = rf_distance(build("float64"), true)[1]
    nrf32 = rf_distance(build("float32"), true)[1]
    assert abs(nrf32 - nrf64) <= 0.1, (nrf32, nrf64)


def test_exact_f32_topology():
    from dipper_tpu.placement.exact import run_exact_placement

    n = 45
    rng = np.random.default_rng(41)
    D = random_additive_matrix(n, rng)
    D = D / (D.max() * 1.05)
    names = [f"L{i}" for i in range(n)]

    def build(dtype_name):
        e, b, l = run_exact_placement(
            (jnp.asarray(D, jnp.dtype(dtype_name)),),
            num_sequences=n, frontend="matrix", dtype_name=dtype_name)
        return _newick_k(e, b, l, names, n)

    rf, _ = rf_distance(build("float64"), build("float32"))
    assert rf == 0


def test_dc_f32_quality_parity():
    """DC (mash frontend) f32 vs f64: quality parity vs the true tree
    (topology identity is not expected — see module docstring)."""
    from dipper_tpu.dc import build_dc_tree
    from dipper_tpu.utils.params import Param

    names, seqs, true = _true_tree_data(60, 3000, 51)

    def build(dtype_name):
        params = Param(kmer_size=12, sketch_size=200, in_format="r",
                       dtype=dtype_name)
        params.backbone_size = len(seqs) // 5
        params.batch_size = params.backbone_size
        return build_dc_tree(seqs, names, params)

    nrf64 = rf_distance(build("float64"), true)[1]
    nrf32 = rf_distance(build("float32"), true)[1]
    assert abs(nrf32 - nrf64) <= 0.15, (nrf32, nrf64)

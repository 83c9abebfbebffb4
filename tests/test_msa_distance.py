"""MSA distance engine vs oracle for all six models."""

import numpy as np
import pytest

from dipper_tpu.distance.msa import msa_distance_matrix_device
from dipper_tpu.io.encode import batch_codes, encode_4bit_codes

from oracle import msa_distance_matrix
from datagen import simulate_alignment


def _codes(n=12, L=400, seed=0, gap_frac=0.08):
    rng = np.random.default_rng(seed)
    names, seqs = simulate_alignment(n, L, rng, gap_frac=gap_frac)
    codes, lengths = batch_codes(seqs, encode_4bit_codes, pad_value=4)
    return codes


@pytest.mark.parametrize("dt", [1, 2, 3, 4, 5, 6])
def test_msa_models_match_oracle(dt):
    codes = _codes(seed=dt)
    want = msa_distance_matrix(codes, dt)
    got = msa_distance_matrix_device(codes, dt, dtype="float64")
    # equal_nan: the reference formulas genuinely produce NaN for
    # divergent pairs (log of a negative), and we replicate that.
    assert np.allclose(got, want, rtol=1e-12, atol=1e-12, equal_nan=True), (
        dt, np.nanmax(np.abs(got - want)))


def test_msa_f32_close():
    codes = _codes(seed=42)
    want = msa_distance_matrix(codes, 2)
    got = msa_distance_matrix_device(codes, 2, dtype="float32")
    # tolerance sized for f32 transcendentals (log near the JC pole
    # amplifies rounding; the pair counts themselves are exact int32)
    assert np.allclose(got, want, rtol=2e-3, atol=1e-5)


def test_msa_blocking_consistent():
    codes = _codes(n=20, seed=7)
    a = msa_distance_matrix_device(codes, 2, dtype="float64", row_block=4)
    b = msa_distance_matrix_device(codes, 2, dtype="float64", row_block=64)
    assert np.allclose(a, b)

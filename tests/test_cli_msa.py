"""End-to-end: the CLI with -i m -d 2 (aligned FASTA -> JC distances -> NJ)."""

import numpy as np

from dipper_tpu.cli import main
from dipper_tpu.utils.treecmp import rf_distance
from dipper_tpu.io.encode import batch_codes, encode_4bit_codes

from oracle import neighbor_joining, nj_newick, msa_distance_matrix
from datagen import simulate_alignment, write_fasta


def test_cli_msa_nj(tmp_path):
    rng = np.random.default_rng(9)
    names, seqs = simulate_alignment(25, 300, rng, gap_frac=0.05)
    inp = tmp_path / "in.fa"
    outp = tmp_path / "out.nwk"
    write_fasta(str(inp), names, seqs)

    rc = main(["-i", "m", "-d", "2", "-I", str(inp), "-O", str(outp),
               "--precision", "f64", "--seed", "-1"])
    assert rc == 0

    codes, _ = batch_codes(seqs, encode_4bit_codes, pad_value=4)
    D = msa_distance_matrix(codes, 2)
    children, root = neighbor_joining(D)
    want = nj_newick(children, root, names)
    got = outp.read_text().strip()
    rf, _ = rf_distance(got, want)
    assert rf == 0


def test_cli_msa_shuffle_invariant_topology(tmp_path):
    """Shuffling input order must not change the NJ topology."""
    rng = np.random.default_rng(10)
    names, seqs = simulate_alignment(20, 300, rng, gap_frac=0.03)
    inp = tmp_path / "in.fa"
    write_fasta(str(inp), names, seqs)
    o1 = tmp_path / "o1.nwk"
    o2 = tmp_path / "o2.nwk"
    main(["-i", "m", "-d", "2", "-I", str(inp), "-O", str(o1),
          "--precision", "f64", "--seed", "-1"])
    main(["-i", "m", "-d", "2", "-I", str(inp), "-O", str(o2),
          "--precision", "f64", "--seed", "7"])
    rf, _ = rf_distance(o1.read_text(), o2.read_text())
    assert rf == 0

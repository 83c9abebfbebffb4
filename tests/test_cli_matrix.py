"""End-to-end: the CLI with -i d (PHYLIP matrix -> NJ Newick)."""

import numpy as np

from dipper_tpu.cli import main
from dipper_tpu.io.phylip import write_phylip_lower_triangular
from dipper_tpu.utils.treecmp import rf_distance

from oracle import neighbor_joining, nj_newick
from test_nj import random_additive_matrix


def test_cli_matrix_nj(tmp_path):
    n = 30
    rng = np.random.default_rng(3)
    D = random_additive_matrix(n, rng)
    names = [f"T{i}" for i in range(n)]
    inp = tmp_path / "in.phy"
    outp = tmp_path / "out.nwk"
    write_phylip_lower_triangular(names, D, str(inp))

    rc = main(["-i", "d", "-I", str(inp), "-O", str(outp), "--precision", "f64"])
    assert rc == 0

    got = outp.read_text().strip()
    children, root = neighbor_joining(D)
    want = nj_newick(children, root, names)
    rf, _ = rf_distance(got, want)
    assert rf == 0

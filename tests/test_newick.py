import numpy as np

from dipper_tpu.io.newick import parse_newick, write_newick, adjacency_newick


def test_parse_simple():
    t = parse_newick("((A:1,B:2):0.5,C:3);", total_leaves=3)
    assert t.num_leaves == 3
    assert t.all_nodes["A"].idx == 0
    assert t.all_nodes["B"].idx == 1
    assert t.all_nodes["C"].idx == 2
    # root = first '(' -> idx = total_leaves
    assert t.root.idx == 3
    assert t.root.name == "node_3"
    inner = t.all_nodes["A"].parent
    assert inner.idx == 4
    assert abs(inner.bl - 0.5) < 1e-12
    assert abs(t.all_nodes["C"].bl - 3.0) < 1e-12


def test_parse_quoted_names():
    t = parse_newick("('we ird':1,'x(y)':2);", total_leaves=2)
    assert "we ird" in t.all_nodes
    assert "x(y)" in t.all_nodes


def test_roundtrip():
    s = "((A:1,B:2):0.5,(C:3,D:1):0.25);"
    t = parse_newick(s, total_leaves=4)
    out = write_newick(t)
    t2 = parse_newick(out, total_leaves=4)
    assert sorted(n.name for n in t2.all_nodes.values() if n.is_leaf()) == [
        "A", "B", "C", "D",
    ]
    assert abs(t2.all_nodes["C"].parent.bl - 0.25) < 1e-6


def test_parse_backbone_dataset():
    # a backbone as the engine writes one: the NJ tree of a seeded
    # random Euclidean distance matrix
    from oracle import neighbor_joining, nj_newick

    rng = np.random.default_rng(2)
    pts = rng.random((200, 4))
    D = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1))
    children, root = neighbor_joining(D)
    s = nj_newick(children, root, [f"T{i}" for i in range(200)])
    nleaves = s.count(",") + 1
    assert nleaves == 200
    t = parse_newick(s, total_leaves=nleaves)
    assert t.num_leaves == nleaves
    leaves = [n for n in t.all_nodes.values() if n.is_leaf()]
    assert len(leaves) == nleaves
    # every leaf id unique and in range
    ids = sorted(n.idx for n in leaves)
    assert ids == list(range(nleaves))


def test_adjacency_newick_matches_recursion():
    # star with center 3 (= N for N=3 leaves): ((A,B),C) shaped tree
    # nodes: leaves 0,1,2; internal 3,4
    edges = {
        3: [(0, 1.0), (4, 0.5)],
        4: [(1, 2.0), (2, 3.0), (3, 0.5)],
        0: [(3, 1.0)],
        1: [(4, 2.0)],
        2: [(4, 3.0)],
    }
    s = adjacency_newick(3, ["A", "B", "C"], edges, 3)
    assert s == "(A:1,(B:2,C:3):0.5);"


def test_native_emit_matches_python_walk(monkeypatch):
    """native/newick.cpp produces byte-identical output to the Python
    CSR stack walk (including %.6g branch-length formatting) on real
    placement edge arrays."""
    import numpy as np
    import jax.numpy as jnp
    from dipper_tpu.io import newick as NW
    from dipper_tpu.placement import kclosest

    rng = np.random.default_rng(3)
    n = 120
    pts = rng.random((n, 5))
    D = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1))
    D = (D / (D.max() * 1.05)).astype(np.float64)
    np.fill_diagonal(D, 0.0)
    e, b, ln = kclosest.run_placement(
        (jnp.asarray(D),), num_sequences=n, frontend="matrix",
        dtype_name="float64")
    names = [f"T{i}" for i in range(n)]

    native = NW.edge_arrays_newick(n, names, b, e, ln, n)
    assert NW._nwlib is not None  # library built and loaded
    monkeypatch.setattr(NW, "_nwlib", None)
    monkeypatch.setattr(NW, "_nwlib_tried", True)
    python = NW.edge_arrays_newick(n, names, b, e, ln, n)
    assert native == python

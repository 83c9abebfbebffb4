#!/usr/bin/env python
"""Benchmark-scale synthetic dataset generator.

Stand-in for the reference's AliSim/RNASim dataset scripts
(/root/reference/scripts/alisim.sh:8, generateAlisimDatasets.sh:4-6,
generateRNASimDataset.sh): a random binary tree over N taxa with
uniform(0.02,0.3)-scaled branch lengths, Jukes-Cantor evolution of an
L-bp root sequence down the tree, optional gaps (aligned mode) or
indels (unaligned mode). Writes:

  <out>.fa           FASTA (aligned or unaligned)
  <out>.true.nwk     the generating tree (for nRF accuracy checks)

With --matrix it writes <out>.phy instead of FASTA: the tree's
additive (path-length) distance matrix, lower-triangular PHYLIP, on
which neighbor joining recovers the generating tree exactly.

Memory-bounded: sequences are uint8 arrays, evolved in DFS order and
freed once all children are produced, so peak live state is
O(tree_depth * L), not O(N * L).

Usage:
  python scripts/make_dataset.py -n 30000 -L 10000 -o ds30k [--aligned]
  python scripts/make_dataset.py -n 8000 -o mat8k --matrix
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_tree(n: int, rng, blen_scale: float):
    """Random binary tree over leaves 0..n-1 (internal ids n..2n-2).
    Returns (children, blen, root): children[p] = [c1, c2]."""
    pool = list(range(n))
    children = {}
    blen = np.zeros(2 * n - 1)
    nxt = n
    while len(pool) > 1:
        a = pool.pop(int(rng.integers(len(pool))))
        b = pool.pop(int(rng.integers(len(pool))))
        children[nxt] = [a, b]
        blen[a] = float(rng.uniform(0.02, 0.3)) * blen_scale
        blen[b] = float(rng.uniform(0.02, 0.3)) * blen_scale
        pool.append(nxt)
        nxt += 1
    return children, blen, pool[0]


def tree_newick(children, blen, root, names) -> str:
    """Post-order iterative Newick build (recursion depth is O(N), so
    no Python recursion): each node's string assembled from its
    children's strings."""
    res = {}
    stack = [(root, False)]
    while stack:
        node, done = stack.pop()
        kids = children.get(node)
        if kids is None:
            res[node] = f"{names[node]}:{blen[node]:.6f}"
            continue
        if not done:
            stack.append((node, True))
            for c in kids:
                stack.append((c, False))
            continue
        inner = ",".join(res.pop(c) for c in kids)
        if node == root:
            res[node] = f"({inner});"
        else:
            res[node] = f"({inner}):{blen[node]:.6f}"
    return res[root]


def additive_matrix(children, blen, root, n: int) -> np.ndarray:
    """[n, n] path-length distances between the leaves: at each
    internal node, every leaf pair split by it gets its two depths
    below the node plus the two child branch lengths."""
    D = np.zeros((n, n))
    below = {}  # node -> (leaf ids, distance of each to the node)
    stack = [(root, False)]
    while stack:
        node, done = stack.pop()
        kids = children.get(node)
        if kids is None:
            below[node] = (np.array([node]), np.zeros(1))
            continue
        if not done:
            stack.append((node, True))
            stack.extend((c, False) for c in kids)
            continue
        (la, da), (lb, db) = (below.pop(c) for c in kids)
        da = da + blen[kids[0]]
        db = db + blen[kids[1]]
        block = da[:, None] + db[None, :]
        D[np.ix_(la, lb)] = block
        D[np.ix_(lb, la)] = block.T
        below[node] = (np.concatenate([la, lb]), np.concatenate([da, db]))
    return D


def write_phylip(path: str, names, D: np.ndarray):
    """Lower-triangular PHYLIP (the CLI's -i d input format)."""
    with open(path, "w") as f:
        f.write(f"{len(names)}\n")
        for i, name in enumerate(names):
            row = "\t".join(map("{:.9g}".format, D[i, :i].tolist()))
            f.write(name + ("\t" + row if row else "") + "\n")


def evolve(children, blen, root, n: int, L: int, rng,
           progress=False):
    """JC evolution: returns dict leaf -> uint8 base-code array [L].
    Frees internal sequences as soon as their children are done."""
    seqs = {}
    leaves = {}
    seqs[root] = rng.integers(0, 4, L, dtype=np.uint8)
    stack = [root]
    done = 0
    while stack:
        u = stack.pop()
        su = seqs.pop(u)
        for c in children.get(u, ()):
            p_mut = 0.75 * (1.0 - np.exp(-4.0 / 3.0 * blen[c]))
            mut = rng.random(L) < p_mut
            s = su.copy()
            nm = int(mut.sum())
            if nm:
                s[mut] = rng.integers(0, 4, nm, dtype=np.uint8)
            if c in children:
                seqs[c] = s
                stack.append(c)
            else:
                leaves[c] = s
                done += 1
                if progress and done % 20000 == 0:
                    print(f"  evolved {done}/{n} leaves",
                          file=sys.stderr)
    return leaves


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, required=True, help="taxa")
    ap.add_argument("-L", type=int, default=10000, help="sequence length")
    ap.add_argument("-o", "--out", required=True,
                    help="output prefix (writes .fa and .true.nwk)")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--aligned", action="store_true",
                    help="aligned output with gaps (MSA mode input)")
    ap.add_argument("--matrix", action="store_true",
                    help="write the tree's additive distance matrix "
                         "(<out>.phy) instead of sequences")
    ap.add_argument("--gap-frac", type=float, default=0.05)
    ap.add_argument("--indel-frac", type=float, default=0.02)
    ap.add_argument("--blen-scale", type=float, default=None,
                    help="branch length scale (default 1.0 aligned, "
                         "0.2 unaligned: mash distance saturates as "
                         "e^{-k d})")
    args = ap.parse_args()

    n, L = args.n, args.L
    rng = np.random.default_rng(args.seed)
    scale = args.blen_scale if args.blen_scale is not None else (
        1.0 if args.aligned else 0.2)

    t0 = time.time()
    children, blen, root = random_tree(n, rng, scale)
    names = [f"S{i}" for i in range(n)]
    with open(args.out + ".true.nwk", "w") as f:
        f.write(tree_newick(children, blen, root, names) + "\n")
    print(f"tree in {time.time()-t0:.1f}s", file=sys.stderr)

    if args.matrix:
        t0 = time.time()
        write_phylip(args.out + ".phy", names,
                     additive_matrix(children, blen, root, n))
        print(f"matrix in {time.time()-t0:.1f}s", file=sys.stderr)
        print(f"wrote {args.out}.phy ({n} taxa) + {args.out}.true.nwk")
        return

    t0 = time.time()
    leaves = evolve(children, blen, root, n, L, rng, progress=True)
    print(f"evolution in {time.time()-t0:.1f}s", file=sys.stderr)

    t0 = time.time()
    with open(args.out + ".fa", "wb") as f:
        for i in range(n):
            arr = _BASES[leaves[i]]
            if args.aligned:
                if args.gap_frac:
                    gaps = rng.random(L) < args.gap_frac
                    arr = arr.copy()
                    arr[gaps] = ord("-")
            elif args.indel_frac:
                keep = rng.random(L) >= args.indel_frac
                arr = arr[keep]
            del leaves[i]
            f.write(b">" + names[i].encode() + b"\n" + arr.tobytes() + b"\n")
    print(f"fasta in {time.time()-t0:.1f}s", file=sys.stderr)
    print(f"wrote {args.out}.fa ({n} x ~{L}bp) + {args.out}.true.nwk")


if __name__ == "__main__":
    main()

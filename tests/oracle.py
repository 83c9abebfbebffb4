"""NumPy/pure-Python oracle implementations of the reference algorithms.

These are the executable spec for the JAX engines: direct, readable
re-statements of the math in /root/reference (cited per function), run
in float64. Engines must reproduce these outputs (bit-near for f64 mode,
topology-equal for f32 mode).
"""

from __future__ import annotations

import numpy as np

MASK64 = (1 << 64) - 1
SENTINEL = MASK64  # 0xFFFFFFFFFFFFFFFF empty sketch slot

# ---------------------------------------------------------------------------
# MurmurHash3 x64_128, low 64 bits, for keys of length <= 15 (one block-less
# tail) — spec: src/mash.cu:159-236. Key bytes are the canonical k-mer's
# ASCII characters; seed 42 (src/mash.cu:320-321).
# ---------------------------------------------------------------------------

C1 = 0x87C37B91114253D5
C2 = 0x4CF5AD432745937F


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & MASK64


def _fmix64(k: int) -> int:
    k ^= k >> 33
    k = (k * 0xFF51AFD7ED558CCD) & MASK64
    k ^= k >> 33
    k = (k * 0xC4CEB9FE1A85EC53) & MASK64
    k ^= k >> 33
    return k


def murmur3_x64_128_low64(key: bytes, seed: int = 42) -> int:
    ln = len(key)
    h1 = seed
    h2 = seed
    nblocks = ln // 16
    for i in range(nblocks):
        k1 = int.from_bytes(key[i * 16 : i * 16 + 8], "little")
        k2 = int.from_bytes(key[i * 16 + 8 : i * 16 + 16], "little")
        k1 = (k1 * C1) & MASK64
        k1 = _rotl64(k1, 31)
        k1 = (k1 * C2) & MASK64
        h1 ^= k1
        h1 = _rotl64(h1, 27)
        h1 = (h1 + h2) & MASK64
        h1 = (h1 * 5 + 0x52DCE729) & MASK64
        k2 = (k2 * C2) & MASK64
        k2 = _rotl64(k2, 33)
        k2 = (k2 * C1) & MASK64
        h2 ^= k2
        h2 = _rotl64(h2, 31)
        h2 = (h2 + h1) & MASK64
        h2 = (h2 * 5 + 0x38495AB5) & MASK64
    tail = key[nblocks * 16 :]
    k1 = 0
    k2 = 0
    if len(tail) > 8:
        k2 = int.from_bytes(tail[8:], "little")
        k2 = (k2 * C2) & MASK64
        k2 = _rotl64(k2, 33)
        k2 = (k2 * C1) & MASK64
        h2 ^= k2
    if len(tail) > 0:
        k1 = int.from_bytes(tail[:8], "little")
        k1 = (k1 * C1) & MASK64
        k1 = _rotl64(k1, 31)
        k1 = (k1 * C2) & MASK64
        h1 ^= k1
    h1 ^= ln
    h2 ^= ln
    h1 = (h1 + h2) & MASK64
    h2 = (h2 + h1) & MASK64
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = (h1 + h2) & MASK64
    # h2 += h1 irrelevant for low 64
    return h1


# ---------------------------------------------------------------------------
# Mash sketch: bottom-`sketch_size` multiset of canonical k-mer hashes
# (src/mash.cu:260-369). Canonical = lexicographically smaller of the
# forward / reverse-complement character strings (src/mash.cu:311-321).
# ---------------------------------------------------------------------------

_BASE = b"ACGT"
_COMP = b"TGCA"


def mash_sketch(codes: np.ndarray, k: int, sketch_size: int = 1000) -> np.ndarray:
    """codes: uint8 2-bit codes (0..3). Returns sorted uint64 sketch of
    length `sketch_size`, padded with SENTINEL."""
    n = len(codes)
    hashes = []
    for j in range(n - k + 1):
        km = codes[j : j + k]
        fwd = bytes(_BASE[c] for c in km)
        rev = bytes(_COMP[c] for c in km[::-1])
        key = fwd if fwd <= rev else rev
        hashes.append(murmur3_x64_128_low64(key))
    hashes.sort()
    out = np.full(sketch_size, SENTINEL, dtype=np.uint64)
    m = min(sketch_size, len(hashes))
    out[:m] = np.array(hashes[:m], dtype=np.uint64)
    return out


def mash_inter(a: np.ndarray, b: np.ndarray, sketch_size: int = 1000) -> int:
    """The merge-walk's intersection count (src/mash.cu:426-450). `a`
    plays the role of the old taxon's sketch (column idx), `b` the new
    row's sketch; both ascending, at least sketch_size long."""
    uni = 0
    inter = 0
    bpos = 0
    ai = 0
    while uni < sketch_size:
        aval = int(a[ai])
        while uni < sketch_size and bpos < sketch_size:
            bval = int(b[bpos])
            if bval > aval:
                break
            if bval < aval:
                uni += 1
            else:
                inter += 1
            bpos += 1
        if uni >= sketch_size:
            break
        uni += 1
        ai += 1
    return inter


def mash_distance(a: np.ndarray, b: np.ndarray, k: int, sketch_size: int = 1000) -> float:
    """Merge-walk distance (src/mash.cu:426-455); sides as in mash_inter."""
    j = max(float(mash_inter(a, b, sketch_size)), 1.0) / sketch_size
    return min(1.0, abs(np.log(2.0 * j / (1.0 + j)) / k))


# ---------------------------------------------------------------------------
# MSA distances (src/MSA.cu:81-268). codes: uint8 4-bit codes (0..4).
# ---------------------------------------------------------------------------


def msa_distance(ci: np.ndarray, cj: np.ndarray, distance_type: int) -> float:
    """Distance between row i (tarRowId, 'ec') and column j (curRowId,
    'et') — d(rowId, j) with et from seq j and ec from seq rowId."""
    et = cj.astype(np.int64)
    ec = ci.astype(np.int64)
    both = (et < 4) & (ec < 4)
    if distance_type in (1, 2):
        useful = int(((et < 4) | (ec < 4)).sum())
        match = int(((et < 4) & (et == ec)).sum())
        uncor = 1.0 - match / useful
        if distance_type == 1:
            return uncor
        return -0.75 * np.log(1.0 - uncor / 0.75)
    if distance_type == 3:  # Tajima-Nei (reference variant, MSA.cu:239-251)
        tot = int(both.sum())
        frac = np.zeros(4)
        for x in range(4):
            frac[x] = int((both & (ec == x)).sum()) + int((both & (et == x)).sum())
        match = int((both & (ec == et)).sum())
        lo = np.minimum(ec, et)
        hi = np.maximum(ec, et)
        pr = [
            int((both & (lo == 0) & (hi == 2)).sum()),  # A-G
            int((both & (lo == 0) & (hi == 3)).sum()),  # A-T
            int((both & (lo == 1) & (hi == 2)).sum()),  # C-G
            int((both & (lo == 1) & (hi == 3)).sum()),  # C-T
        ]
        fr = frac / tot / 2.0
        h = 0.5 * (pr[0] * fr[0] * fr[2] + pr[1] * fr[0] * fr[3]
                   + pr[2] * fr[1] * fr[2] + pr[3] * fr[1] * fr[3])
        D = (tot - match) / tot
        b = 0.5 * (1.0 - fr[0] * fr[0] - fr[2] * fr[2] + D * D / h)
        return -b * np.log(1.0 - D / b)
    if distance_type in (4, 6):  # K2P / Jin-Nei (MSA.cu:253-258)
        tot = int(both.sum())
        mism = both & (ec != et)
        p = int((mism & ((ec % 2) == (et % 2))).sum())
        q = int((mism & ((ec % 2) != (et % 2))).sum())
        pp, qq = p / tot, q / tot
        if distance_type == 4:
            return -0.5 * np.log((1 - 2 * pp - qq) * np.sqrt(1 - 2 * qq))
        return 0.5 * (1.0 / (1 - 2 * pp - qq) + 0.5 / (1 - 2 * qq) - 1.5)
    if distance_type == 5:  # Tamura (MSA.cu:260-265); gc counted on mismatches only
        tot = int(both.sum())
        mism = both & (ec != et)
        p = int((mism & ((ec % 2) == (et % 2))).sum())
        q = int((mism & ((ec % 2) != (et % 2))).sum())
        gc1 = int((mism & ((ec == 1) | (ec == 2))).sum())
        gc2 = int((mism & ((et == 1) | (et == 2))).sum())
        pp, qq = p / tot, q / tot
        c = gc1 / tot + gc2 / tot - 2.0 * gc1 * gc2 / tot / tot
        return -c * np.log(1 - pp / c - qq) - 0.5 * (1 - c) * np.log(1 - 2 * qq)
    return 0.0


def msa_distance_matrix(codes: np.ndarray, distance_type: int) -> np.ndarray:
    n = codes.shape[0]
    D = np.zeros((n, n))
    for i in range(n):
        for j in range(i):
            D[i, j] = D[j, i] = msa_distance(codes[i], codes[j], distance_type)
    return D


# ---------------------------------------------------------------------------
# Neighbor joining (src/neighborJoining.cu:197-270): matrix-compaction NJ.
# Returns (children, root) where children[v] = [(child, bl), ...].
# ---------------------------------------------------------------------------


def neighbor_joining(D: np.ndarray):
    D = D.astype(np.float64).copy()
    N = D.shape[0]
    n = N
    real = list(range(N))
    U = D.sum(axis=1)
    children = [[] for _ in range(2 * N)]
    nid = N
    for _ in range(N - 2):
        # Q-scan: minimize d(i,j) - U_i/(n-2) - U_j/(n-2), i != j
        Un = U[:n] / (n - 2)
        Q = D[:n, :n] - Un[:, None] - Un[None, :]
        np.fill_diagonal(Q[:n, :n], np.inf)
        flat = np.argmin(Q)
        x, y = divmod(flat, n)
        if x > y:
            x, y = y, x
        d = D[x, y]
        blx = (d + Un[x] - Un[y]) * 0.5
        bly = d - blx
        if blx < 0:
            bly += blx
            blx = 0.0
        if bly < 0:
            blx += bly
            bly = 0.0
        children[nid].append((real[x], blx))
        children[nid].append((real[y], bly))
        # new node occupies row x; last row moves into y
        newrow = (D[x, :n] + D[y, :n] - d) * 0.5
        U[:n] += newrow - D[x, :n] - D[y, :n]
        Ux = newrow.sum() - newrow[x] - newrow[y]
        D[x, :n] = newrow
        D[:n, x] = newrow
        real[x] = nid
        nid += 1
        last = n - 1
        if y != last:
            D[y, :n] = D[last, :n]
            D[:n, y] = D[:n, last]
            D[y, y] = 0.0
            U[y] = U[last]
            real[y] = real[last]
        D[x, y] = D[y, x] = (D[x, y])  # already moved
        U[x] = Ux
        n -= 1
        # fix distances of new node to itself
        D[x, x] = 0.0
    root = 2 * N - 2
    children[root].append((real[0], D[0, 1] * 0.5))
    children[root].append((real[1], D[0, 1] * 0.5))
    return children, root


def nj_newick(children, root, names) -> str:
    out = []

    def rec(v):
        if children[v]:
            out.append("(")
            for i, (c, bl) in enumerate(children[v]):
                rec(c)
                out.append(":")
                out.append(f"{bl:.6g}")
                out.append(")" if i + 1 == len(children[v]) else ",")
        else:
            out.append(names[v])

    rec(root)
    out.append(";")
    return "".join(out)


# ---------------------------------------------------------------------------
# K-closest placement (src/placement_close_k.cu). Literal transliteration
# with python lists. dist_fn(i) must return the length-i distance row of
# taxon i vs taxa 0..i-1.
# ---------------------------------------------------------------------------

K = 5
INF_D = 2.0


class KPlacementOracle:
    def __init__(self, num_sequences: int, total: int | None = None):
        """`total`: D&C mode — middle nodes numbered placeId+total-1 and
        the initial internal node is `total` (dc/placement_close_k.cu:373,
        :537); node/edge arrays sized for `total`."""
        N = num_sequences
        self.N = N
        self.total = total if total is not None else N
        E = 4 * self.total
        self.e = [-1] * E
        self.belong = [-1] * E
        self.nxt = [-1] * E
        self.head = [-1] * (2 * self.total)
        self.len = [0.0] * E
        self.cd = [[INF_D] * K for _ in range(E)]   # closest_dis
        self.cid = [[-1] * K for _ in range(E)]     # closest_id
        self.idx = 0

    # --- linked-list helpers (mirror reference adjacency building) ---
    def _add_edge(self, u, v, ln):
        i = self.idx
        self.e[i] = v
        self.len[i] = ln
        self.belong[i] = u
        self.nxt[i] = self.head[u]
        self.head[u] = i
        self.idx += 1
        return i

    def _find_edge(self, u, v):
        i = self.head[u]
        while i != -1:
            if self.e[i] == v:
                return i
            i = self.nxt[i]
        raise KeyError((u, v))

    def build_initial_tree(self, d01: float):
        N = self.total
        self._add_edge(0, N, d01 / 2)
        self._add_edge(1, N, d01 / 2)
        self._add_edge(N, 0, d01 / 2)
        self._add_edge(N, 1, d01 / 2)

    def update_closest_nodes(self, x: int):
        """BFS from leaf x inserting it into edge closest-lists
        (src/placement_close_k.cu:86-124)."""
        queue = [(x, -1, 0.0)]
        qi = 0
        while qi < len(queue):
            node, fb, d = queue[qi]
            qi += 1
            i = self.head[node]
            while i != -1:
                if self.e[i] != fb:
                    inserted = False
                    for j in range(K):
                        if self.cd[i][j] > d:
                            self.cd[i].insert(j, d)
                            self.cd[i].pop()
                            self.cid[i].insert(j, x)
                            self.cid[i].pop()
                            queue.append((self.e[i], node, d + self.len[i]))
                            inserted = True
                            break
                    del inserted
                i = self.nxt[i]

    def score_edges(self, dist_row):
        """Returns (best_eid, fracLen, addLen)
        (src/placement_close_k.cu:309-358). Invalid slots hold the
        sentinel tuple (0, 0, 2.0); when every real candidate has
        addi >= 2.0, thrust::min_element lands on slot 0 (always
        invalid: edge 0 is 0->N) and the reference splices edge 0 with
        frac=0 add=2."""
        best = (2.0, 0)  # (addi, eid): sentinel tuple at slot 0
        best_frac = 0.0
        for eid in range(self.idx):
            if self.belong[eid] < self.e[eid]:
                continue
            # empty gap slots (belong=e=-1) exist when a multifurcating
            # backbone has fewer than 4B-4 directed edges; the reference
            # kernel hits UB here (walks head[-1], placement_close_k.cu
            # :339-340) — we define them as invalid, like the engine's
            # belong>e guard
            if self.belong[eid] == -1:
                continue
            x, oth = self.belong[eid], self.e[eid]
            dis1 = 0.0
            for j in range(K):
                if self.cid[eid][j] != -1:
                    v = dist_row[self.cid[eid][j]] - self.cd[eid][j]
                    if v > dis1:
                        dis1 = v
            otheid = self._find_edge(oth, x)
            dis2 = 0.0
            for j in range(K):
                if self.cid[otheid][j] != -1:
                    v = dist_row[self.cid[otheid][j]] - self.cd[otheid][j]
                    if v > dis2:
                        dis2 = v
            L = self.len[eid]
            addi = (dis1 + dis2 - L) / 2
            if addi < 0:
                addi = 0.0
            dis1 -= addi
            dis2 -= addi
            if dis1 < 0:
                dis1 = 0.0
            if dis2 < 0:
                dis2 = 0.0
            if dis1 > L:
                addi += dis1 - L
                dis1 = L
            if dis2 > L:
                addi += dis2 - L
                dis2 = L
            rest = L - dis1 - dis2
            dis1 += rest / 2
            if (addi, eid) < best:
                best = (addi, eid)
                best_frac = dis1
        return best[1], best_frac, best[0]

    def splice(self, eid: int, frac: float, add: float, place_id: int,
               middle: int | None = None):
        """src/placement_close_k.cu:446-528."""
        if middle is None:
            middle = place_id + self.total - 1
        outside = place_id
        x, y = self.belong[eid], self.e[eid]
        orig = self.len[eid]
        xe = self._find_edge(x, y)
        self.e[xe] = middle
        self.len[xe] = frac
        ye = self._find_edge(y, x)
        self.e[ye] = middle
        self.len[ye] = orig - frac
        # middle -> x : closest copied from ye shifted by (orig - frac)
        e_mx = self._add_edge(middle, x, frac)
        for i in range(K):
            if self.cid[ye][i] != -1:
                self.cid[e_mx][i] = self.cid[ye][i]
                self.cd[e_mx][i] = self.cd[ye][i] + orig - frac
        # middle -> y : closest copied from xe shifted by frac
        e_my = self._add_edge(middle, y, orig - frac)
        for i in range(K):
            if self.cid[xe][i] != -1:
                self.cid[e_my][i] = self.cid[xe][i]
                self.cd[e_my][i] = self.cd[xe][i] + frac
        # outside -> middle (empty closest)
        self._add_edge(outside, middle, add)
        # middle -> outside : merge of e_my then e_mx lists
        e_mo = self._add_edge(middle, outside, add)
        for src in (e_my, e_mx):
            for i in range(K):
                if self.cid[src][i] == -1:
                    break
                for j in range(K):
                    if self.cd[e_mo][j] > self.cd[src][i]:
                        self.cd[e_mo].insert(j, self.cd[src][i])
                        self.cd[e_mo].pop()
                        self.cid[e_mo].insert(j, self.cid[src][i])
                        self.cid[e_mo].pop()
                        break

    def run(self, dist_fn, start=2, initial=True):
        if initial:
            row1 = dist_fn(1)
            self.build_initial_tree(row1[0])
            self.update_closest_nodes(0)
            self.update_closest_nodes(1)
        for i in range(start, self.N):
            row = dist_fn(i)
            eid, frac, add = self.score_edges(row)
            self.splice(eid, frac, add, i)
            self.update_closest_nodes(i)

    def init_from_tree(self, tree, backbone_size: int):
        """--add mode: load backbone (src/placement_close_k.cu:126-264).
        Edges added in postorder-DFS (child->parent then parent->child)."""

        def dfs(node):
            for ch in node.children:
                dfs(ch)
            if node.parent is None:
                return
            x, y = node.idx, node.parent.idx
            self._add_edge(x, y, node.bl)
            self._add_edge(y, x, node.bl)

        dfs(tree.root)
        for i in range(backbone_size):
            self.update_closest_nodes(i)
        self.idx = 4 * backbone_size - 4  # reference addQuery idx offset

    def to_newick(self, names):
        from dipper_tpu.io.newick import adjacency_newick

        edges = [[] for _ in range(2 * self.total)]
        for u in range(2 * self.total):
            i = self.head[u]
            while i != -1:
                edges[u].append((self.e[i], self.len[i]))
                i = self.nxt[i]
        return adjacency_newick(self.total, names, edges, self.total)


# ---------------------------------------------------------------------------
# Exact placement (src/placement.cu): per-edge lim computed by brute force.
# ---------------------------------------------------------------------------


class ExactPlacementOracle(KPlacementOracle):
    """Same splice/tree machinery, but edge scoring uses exact lim values
    and the scored direction is parent->child with root = N."""

    def _tree_dists_from(self, src: int, nnodes: int):
        import collections

        d = {src: 0.0}
        par = {src: -1}
        q = collections.deque([src])
        while q:
            u = q.popleft()
            i = self.head[u]
            while i != -1:
                v = self.e[i]
                if v not in d:
                    d[v] = d[u] + self.len[i]
                    par[v] = u
                    q.append(v)
                i = self.nxt[i]
        return d, par

    def score_edges_exact(self, dist_row, num_placed):
        # root the tree at node N; compute depth order
        _, par = self._tree_dists_from(self.N, 0)
        leaves = [v for v in par if v < self.N]
        # per-leaf distances to every node; sentinel tuple at slot 0
        best = (2.0, 0)
        best_frac = 0.0
        # lim[(s,t)] = max over leaves on s-side of (d_new - dist(s, leaf))
        for eid in range(self.idx):
            s, t = self.belong[eid], self.e[eid]
            if s == -1:
                continue
            if par.get(t) != s:
                continue  # score only parent->child
            # leaves on s side = all leaves not in subtree(t)
            sub = set()
            stack = [t]
            while stack:
                u = stack.pop()
                sub.add(u)
                i = self.head[u]
                while i != -1:
                    v = self.e[i]
                    if v != par.get(u) and v not in sub:
                        stack.append(v)
                    i = self.nxt[i]
            ds, _ = self._tree_dists_from(s, 0)
            dt, _ = self._tree_dists_from(t, 0)
            dis1 = 0.0
            dis2 = 0.0
            for lv in leaves:
                if lv in sub:
                    dis2 = max(dis2, dist_row[lv] - dt[lv])
                else:
                    dis1 = max(dis1, dist_row[lv] - ds[lv])
            L = self.len[eid]
            addi = (dis1 + dis2 - L) / 2
            if addi < 0:
                addi = 0.0
            dis1 -= addi
            dis2 -= addi
            if dis1 < 0:
                dis1 = 0.0
            if dis2 < 0:
                dis2 = 0.0
            if dis1 > L:
                addi += dis1 - L
                dis1 = L
            if dis2 > L:
                addi += dis2 - L
                dis2 = L
            rest = L - dis1 - dis2
            dis1 += rest / 2
            if (addi, eid) < best:
                best = (addi, eid)
                best_frac = dis1
        return best[1], best_frac, best[0]

    def splice_exact(self, eid, frac, add, place_id):
        # identical array updates minus closest lists (src/placement.cu:200-253)
        self.splice(eid, frac, add, place_id)

    def run(self, dist_fn, start=2, initial=True):
        if initial:
            row1 = dist_fn(1)
            self.build_initial_tree(row1[0])
        for i in range(start, self.N):
            row = dist_fn(i)
            eid, frac, add = self.score_edges_exact(row, i)
            self.splice_exact(eid, frac, add, i)


# ---------------------------------------------------------------------------
# Divide-and-conquer oracle (src/divide_and_conquer/placement_close_k.cu):
# backbone build with total-offset ids, cluster assignment (tree untouched),
# per-cluster masked insertion with global insertLeafCount numbering.
# ---------------------------------------------------------------------------


class DCOracle(KPlacementOracle):
    def __init__(self, backbone_size: int, total: int):
        super().__init__(backbone_size, total=total)
        self.B = backbone_size

    def run_backbone(self, dist_fn):
        """Phase 1 (findBackboneTreeDC :731-935): identical insertion
        loop over taxa 0..B-1."""
        self.run(dist_fn)  # uses self.N == B, middles offset by total

    def assign_clusters(self, dist_fn):
        """Phase 2 (findClustersDC :937-1113): for each query, the best
        backbone attachment edge; tree unchanged."""
        self.cluster_id = {}
        for q in range(self.B, self.total):
            row = dist_fn(q)
            eid, _, _ = self.score_edges(row)
            self.cluster_id[q] = eid

    def build_cluster_trees(self, dist_fn):
        """Phase 3 (findClusterTreeDC :1251-1535)."""
        contains = {}
        for q in range(self.B, self.total):
            contains.setdefault(self.cluster_id[q], []).append(q)
        insert_leaf_count = self.B
        self.idx = 4 * self.B - 4
        for ceid in sorted(contains):
            members = contains[ceid]
            x, y = self.belong[ceid], self.e[ceid]
            otheid = self._find_edge(y, x)
            # masks (initializeClusterDC :604-635)
            leaf_mask = list(self.cid[ceid]) + list(self.cid[otheid])
            edge_mask = [ceid, otheid]
            for leaf in members:
                row = dist_fn(leaf)
                # masked scoring over edge_mask positions
                # (calculateBranchLengthSpecialIDDC :180-234); sentinel
                # tuple at mask position 0 when nothing beats 2.0
                best = (2.0, 0)
                best_frac = 0.0
                chosen = None
                for pos, eid in enumerate(edge_mask):
                    if self.belong[eid] < self.e[eid]:
                        continue
                    xx, oth = self.belong[eid], self.e[eid]
                    dis1 = 0.0
                    for j in range(K):
                        if self.cid[eid][j] != -1:
                            v = row[self.cid[eid][j]] - self.cd[eid][j]
                            if v > dis1:
                                dis1 = v
                    oe = self._find_edge(oth, xx)
                    dis2 = 0.0
                    for j in range(K):
                        if self.cid[oe][j] != -1:
                            v = row[self.cid[oe][j]] - self.cd[oe][j]
                            if v > dis2:
                                dis2 = v
                    L = self.len[eid]
                    addi = (dis1 + dis2 - L) / 2
                    if addi < 0:
                        addi = 0.0
                    dis1 -= addi
                    dis2 -= addi
                    if dis1 < 0:
                        dis1 = 0.0
                    if dis2 < 0:
                        dis2 = 0.0
                    if dis1 > L:
                        addi += dis1 - L
                        dis1 = L
                    if dis2 > L:
                        addi += dis2 - L
                        dis2 = L
                    rest = L - dis1 - dis2
                    dis1 += rest / 2
                    if (addi, pos) < best:
                        best = (addi, pos)
                        best_frac = dis1
                        chosen = eid
                if chosen is None:
                    chosen = edge_mask[0]
                    best_frac = 0.0
                    best = (2.0, 0)
                middle = insert_leaf_count + self.total - 1
                self.splice(chosen, best_frac, best[0], leaf, middle=middle)
                insert_leaf_count += 1
                # updateClusterInfoDC: new edges appended idx-1..idx-4
                edge_mask += [self.idx - 1, self.idx - 2,
                              self.idx - 3, self.idx - 4]
                leaf_mask.append(leaf)
                # masked BFS with endpoint block
                # (updateClosestNodesInClusterDC :312-356)
                in_mask = set(edge_mask)
                ed1, ed2 = self.e[ceid], self.belong[ceid]
                queue = [(leaf, -1, 0.0)]
                qi = 0
                while qi < len(queue):
                    node, fb, d = queue[qi]
                    qi += 1
                    if node == ed1 or node == ed2:
                        continue
                    i = self.head[node]
                    while i != -1:
                        if i in in_mask and self.e[i] != fb:
                            for j in range(K):
                                if self.cd[i][j] > d:
                                    self.cd[i].insert(j, d)
                                    self.cd[i].pop()
                                    self.cid[i].insert(j, leaf)
                                    self.cid[i].pop()
                                    queue.append(
                                        (self.e[i], node, d + self.len[i]))
                                    break
                        i = self.nxt[i]

    def run_dc(self, dist_fn):
        self.run_backbone(dist_fn)
        self.assign_clusters(dist_fn)
        self.build_cluster_trees(dist_fn)

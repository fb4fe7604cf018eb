"""NumPy oracle implementations — the executable spec for every device kernel.

Each function here is the bit-exact semantic reference for a Pallas/XLA op in
`hga_tpu/ops/`.  Tests assert device == oracle on random and adversarial
inputs (SURVEY.md §5 test plan, item 1).  These run on small inputs only; no
performance is expected of them.

Conventions pinned here (SURVEY.md Appendix A):
* k-mer value: first base most significant, 2 bits/base:
      V(i) = sum_t  b[i+t] << 2*(k-1-t)
* reverse-complement value: RC(i) = sum_t (3-b[i+k-1-t]) << 2*(k-1-t)
* canonical k-mer = min(V, RC); strand 0 if V <= RC else 1.
* device representation: (hi, lo) = (V >> 32, V & 0xffffffff) as uint32 pairs
  (JAX runs without 64-bit integers by default; lexicographic (hi, lo) order
  == uint64 order).
* minimizer hash: murmur3 fmix32 of (lo ^ (hi * 0x9E3779B1)), ties by leftmost
  position.  Window j covers k-mer positions [j, j+w).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

U32 = np.uint32
U64 = np.uint64


# ---------------------------------------------------------------------------
# k-mer layer (L1)
# ---------------------------------------------------------------------------

def kmer_values(codes: np.ndarray, bad: np.ndarray, length: int, k: int):
    """Canonical k-mers of one read.

    Returns (canon uint64[m], strand uint8[m], valid bool[m]) with
    m = max(0, length - k + 1); valid[i] is False if any base in the window is
    flagged bad.
    """
    codes = np.asarray(codes, dtype=np.uint64)
    bad = np.asarray(bad, dtype=np.uint8)
    m = max(0, int(length) - k + 1)
    if m == 0:
        return (np.zeros(0, U64), np.zeros(0, np.uint8), np.zeros(0, bool))
    fwd = np.zeros(m, dtype=U64)
    rc = np.zeros(m, dtype=U64)
    for t in range(k):
        fwd |= codes[t : t + m] << U64(2 * (k - 1 - t))
        rc |= (U64(3) - codes[k - 1 - t : k - 1 - t + m]) << U64(2 * (k - 1 - t))
    canon = np.minimum(fwd, rc)
    strand = (fwd > rc).astype(np.uint8)
    badc = np.concatenate([[0], np.cumsum(bad[: int(length)], dtype=np.int64)])
    valid = (badc[k:] - badc[:-k]) == 0
    return canon, strand, valid


def split_hi_lo(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    v = np.asarray(v, dtype=U64)
    return (v >> U64(32)).astype(U32), (v & U64(0xFFFFFFFF)).astype(U32)


def join_hi_lo(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (np.asarray(hi, U64) << U64(32)) | np.asarray(lo, U64)


def count_kmers(reads: Sequence[Tuple[np.ndarray, np.ndarray, int]], k: int) -> Dict[int, int]:
    """reads: list of (codes, bad, length). Returns {canonical kmer: count}."""
    counts: Dict[int, int] = {}
    for codes, bad, length in reads:
        canon, _, valid = kmer_values(codes, bad, length, k)
        for v in canon[valid]:
            counts[int(v)] = counts.get(int(v), 0) + 1
    return counts


def spectrum_histogram(counts: Dict[int, int], max_count: int) -> np.ndarray:
    """hist[c] = number of distinct k-mers with count c (c clamped)."""
    hist = np.zeros(max_count + 1, dtype=np.int64)
    for c in counts.values():
        hist[min(c, max_count)] += 1
    return hist


def solid_threshold_from_hist(hist: np.ndarray, min_threshold: int = 2) -> int:
    """Pick the valley between the error peak (count≈1) and coverage peak.

    Walk up from count=min_threshold: the threshold is the first count where
    the (smoothed) histogram stops decreasing — standard spectrum-valley rule
    (SURVEY.md L1).  Falls back to min_threshold when no valley exists.
    """
    h = hist.astype(np.float64)
    # 3-wide smoothing to be robust to noise
    sm = h.copy()
    if len(h) > 3:
        sm[1:-1] = (h[:-2] + h[1:-1] + h[2:]) / 3.0
    for c in range(max(1, min_threshold), len(sm) - 1):
        if sm[c + 1] >= sm[c]:
            return c + 1
    return min_threshold


# ---------------------------------------------------------------------------
# minimizer layer (L2)
# ---------------------------------------------------------------------------

def fmix32(x: np.ndarray) -> np.ndarray:
    """murmur3 finalizer (32-bit)."""
    x = np.asarray(x, dtype=U32).copy()
    x ^= x >> U32(16)
    x = (x * U32(0x85EBCA6B)) & U32(0xFFFFFFFF)
    x ^= x >> U32(13)
    x = (x * U32(0xC2B2AE35)) & U32(0xFFFFFFFF)
    x ^= x >> U32(16)
    return x


def kmer_hash32(canon: np.ndarray) -> np.ndarray:
    hi, lo = split_hi_lo(canon)
    return fmix32(lo ^ ((hi * U32(0x9E3779B1)) & U32(0xFFFFFFFF)))


def minimizers(codes, bad, length: int, k: int, w: int):
    """Distinct (pos, canon, strand) minimizers of one read.

    Window j (j = 0..m-w) selects argmin over positions [j, j+w) of
    (hash, pos); invalid k-mers hash to +inf (never selected; windows that are
    entirely invalid select nothing).  Consecutive windows selecting the same
    position yield one entry.
    """
    canon, strand, valid = kmer_values(codes, bad, length, k)
    m = canon.shape[0]
    if m < w:
        return []
    h = kmer_hash32(canon).astype(np.int64)
    h[~valid] = np.int64(1) << 40  # +inf sentinel
    out = []
    last = -1
    for j in range(m - w + 1):
        window = h[j : j + w]
        p = j + int(np.argmin(window))  # argmin is leftmost-min: ties -> left
        if h[p] >= (np.int64(1) << 40):
            continue
        if p != last:
            out.append((p, int(canon[p]), int(strand[p])))
            last = p
    return out


def candidate_pairs_oracle(
    minimizer_entries, read_len, category, k: int,
    max_freq: int, min_shared: int, mode: str = "all",
):
    """Reference for ops.pairs.candidate_pairs.

    minimizer_entries: list over reads of [(pos, canon_kmer, strand), ...]
    Returns sorted list of (a, b, rel, median_diag, shared).
    """
    from collections import defaultdict

    index = defaultdict(list)
    for r, ents in enumerate(minimizer_entries):
        for (p, v, s) in ents:
            index[v].append((r, p, s))
    agg: Dict[Tuple[int, int, int], List[int]] = defaultdict(list)
    for v, occ in index.items():
        if len(occ) > max_freq:
            continue
        for i in range(len(occ)):
            for j in range(i + 1, len(occ)):
                (r1, p1, s1), (r2, p2, s2) = occ[i], occ[j]
                if r1 == r2:
                    continue
                if mode == "cross" and category[r1] == category[r2]:
                    continue
                if r1 < r2:
                    a, b, pa, pb, sa, sb = r1, r2, p1, p2, s1, s2
                else:
                    a, b, pa, pb, sa, sb = r2, r1, p2, p1, s2, s1
                rel = int(sa != sb)
                pb_adj = pb if rel == 0 else int(read_len[b]) - k - pb
                agg[(a, b, rel)].append(pa - pb_adj)
    out = []
    for (a, b, rel), diags in sorted(agg.items()):
        if len(diags) >= min_shared:
            out.append((a, b, rel, sorted(diags)[len(diags) // 2], len(diags)))
    return out


# ---------------------------------------------------------------------------
# alignment layer (L3) — banded Smith-Waterman, linear gap, all-integer
# ---------------------------------------------------------------------------

def banded_sw(
    q: np.ndarray,
    t: np.ndarray,
    band: int,
    diag: int = 0,
    match: int = 2,
    mismatch: int = -4,
    gap: int = -3,
):
    """Banded local Smith-Waterman over base-code arrays q, t.

    Cells restricted to |j - i - diag| <= band (i indexes q, j indexes t,
    both 0-based; H has an implicit 0 row/col).  Linear gap penalty.

    Returns dict with: score, qend, tend (exclusive, i.e. 1-based last cell),
    qstart, tstart (0-based inclusive), matches, aln_len (number of alignment
    columns), identity.  Traceback prefers diag > up (gap in t) > left.
    Best cell: maximum H, ties -> smallest anti-diagonal i+j, then smallest i
    (the wavefront sweep order of the device kernel).
    """
    q = np.asarray(q)
    t = np.asarray(t)
    nq, nt = len(q), len(t)
    NEG = -(10**9)
    H = np.zeros((nq + 1, nt + 1), dtype=np.int64)
    mask = np.zeros((nq + 1, nt + 1), dtype=bool)
    mask[0, 0] = True
    for i in range(1, nq + 1):
        jlo = max(1, i + diag - band)
        jhi = min(nt, i + diag + band)
        for j in range(jlo, jhi + 1):
            sub = match if q[i - 1] == t[j - 1] else mismatch
            best = 0
            if mask[i - 1, j - 1] or (i - 1 == 0 or j - 1 == 0):
                best = max(best, H[i - 1, j - 1] + sub)
            if mask[i - 1, j] or i - 1 == 0:
                best = max(best, H[i - 1, j] + gap)
            if mask[i, j - 1] or j - 1 == 0:
                best = max(best, H[i, j - 1] + gap)
            H[i, j] = best
            mask[i, j] = True
    Hm = np.where(mask, H, NEG)
    score = int(Hm.max())
    if score <= 0:
        return dict(score=0, qend=0, tend=0, qstart=0, tstart=0,
                    matches=0, aln_len=0, identity=0.0)
    cand_i, cand_j = np.nonzero(Hm == score)
    order = np.lexsort((cand_i, cand_i + cand_j))  # min (i+j), then min i
    ei, ej = int(cand_i[order[0]]), int(cand_j[order[0]])
    # traceback
    i, j = ei, ej
    matches = 0
    cols = 0
    while i > 0 and j > 0 and H[i, j] > 0 and mask[i, j]:
        sub = match if q[i - 1] == t[j - 1] else mismatch
        if (mask[i - 1, j - 1] or i - 1 == 0 or j - 1 == 0) and H[i, j] == H[i - 1, j - 1] + sub:
            matches += int(q[i - 1] == t[j - 1])
            i, j = i - 1, j - 1
        elif (mask[i - 1, j] or i - 1 == 0) and H[i, j] == H[i - 1, j] + gap:
            i -= 1
        else:
            j -= 1
        cols += 1
    return dict(
        score=score, qend=ei, tend=ej, qstart=i, tstart=j,
        matches=matches, aln_len=cols,
        identity=matches / cols if cols else 0.0,
    )


def banded_sw_score_only(q, t, band, diag=0, match=2, mismatch=-4, gap=-3):
    """Score + end coordinates only (what the wavefront kernel computes)."""
    r = banded_sw(q, t, band, diag, match, mismatch, gap)
    return r["score"], r["qend"], r["tend"]


# ---------------------------------------------------------------------------
# graph layer (L4)
# ---------------------------------------------------------------------------

def transitive_reduction(edges: List[Tuple[int, int, int]], fuzz: int = 10):
    """Myers-style transitive reduction.

    edges: (u, v, length) directed overlap edges, length = how far v extends
    past u (positive).  An edge u->w is reducible if there are edges u->v and
    v->w with len(u->v) + len(v->w) <= len(u->w) + fuzz.
    Returns the boolean keep-mask aligned with `edges`.
    """
    from collections import defaultdict

    out = defaultdict(list)
    for idx, (u, v, l) in enumerate(edges):
        out[u].append((v, l, idx))
    keep = np.ones(len(edges), dtype=bool)
    for u, adj in out.items():
        for w, lw, idx in adj:
            for v, lv, _ in adj:
                if v == w:
                    continue
                for w2, lvw, _ in out.get(v, []):
                    if w2 == w and lv + lvw <= lw + fuzz:
                        keep[idx] = False
                        break
                if not keep[idx]:
                    break
    return keep


def unitigs_from_edges(n_nodes: int, edges: List[Tuple[int, int]]):
    """Maximal unambiguous paths (in-degree<=1, out-degree<=1 chains).

    Returns list of node paths.  Nodes with branching degree form singleton
    paths.  Deterministic: paths start from the smallest eligible node id.
    """
    from collections import defaultdict

    outd = defaultdict(list)
    ind = defaultdict(list)
    for u, v in edges:
        outd[u].append(v)
        ind[v].append(u)
    visited = np.zeros(n_nodes, dtype=bool)
    paths = []
    for s in range(n_nodes):
        if visited[s]:
            continue
        # start nodes: in-degree != 1 or predecessor is branching
        pred = ind.get(s, [])
        is_start = len(pred) != 1 or len(outd.get(pred[0], [])) != 1
        if not is_start:
            continue
        path = [s]
        visited[s] = True
        cur = s
        while len(outd.get(cur, [])) == 1:
            nxt = outd[cur][0]
            if len(ind.get(nxt, [])) != 1 or visited[nxt]:
                break
            path.append(nxt)
            visited[nxt] = True
            cur = nxt
        paths.append(path)
    # cycles: remaining unvisited nodes with degree 1 chains
    for s in range(n_nodes):
        if not visited[s]:
            path = [s]
            visited[s] = True
            cur = s
            while len(outd.get(cur, [])) == 1:
                nxt = outd[cur][0]
                if visited[nxt]:
                    break
                path.append(nxt)
                visited[nxt] = True
                cur = nxt
            paths.append(path)
    return paths


# ---------------------------------------------------------------------------
# consensus layer (L5)
# ---------------------------------------------------------------------------

def pileup_consensus(
    backbone: np.ndarray,
    alignments: List[Tuple[int, np.ndarray]],
    min_depth: int = 2,
):
    """Substitution/deletion pileup consensus over a backbone sequence.

    alignments: list of (start, column_codes) where column_codes[p] in
    {0..3 base, 4 deletion} gives the aligned read symbol for backbone
    position start+p.  Each column votes among {A,C,G,T,del}; backbone base
    gets an implicit prior vote of 1.  Columns with < min_depth read votes
    keep the backbone base.  Returns consensus codes (deletions removed).
    """
    L = len(backbone)
    votes = np.zeros((L, 5), dtype=np.int64)
    depth = np.zeros(L, dtype=np.int64)
    for start, cols in alignments:
        for p, c in enumerate(cols):
            pos = start + p
            if 0 <= pos < L and 0 <= c <= 4:
                votes[pos, int(c)] += 1
                depth[pos] += 1
    votes[np.arange(L), np.asarray(backbone, dtype=np.int64)] += 1  # prior
    best = votes.argmax(axis=1)  # ties -> lower symbol id (A<C<G<T<del)
    best = np.where(depth >= min_depth, best, np.asarray(backbone, dtype=np.int64))
    return best[best != 4].astype(np.uint8), best.astype(np.uint8)


# ---------------------------------------------------------------------------
# bit-parallel overlap DP (L3, Myers engine) — unit-cost semi-global oracle
# ---------------------------------------------------------------------------

def edit_distance_hw(q, t) -> Tuple[int, int]:
    """Semi-global (infix / edlib-"HW") unit-cost edit distance.

    The whole query aligns somewhere inside the target: D[i][0] = i,
    D[0][j] = 0; returns (min_j D[m][j], argmin j) with the SMALLEST j
    breaking ties.  This is the semantic reference for ops/myers.py — the
    device replacement for the reference's scalar alignment loops on the
    overlap-extension path (SURVEY.md C9).  NOTE: unit-cost edit distance is
    NOT score-equivalent to SW (no match bonus, no affine gaps), so SW score
    thresholds do not transfer; the overlap gate re-calibrates acceptance as
    a maximum edit RATE over the expected overlap segment
    (cfg.min_identity in models/overlap.py), with scored SW reserved for
    coordinate refinement of survivors.
    """
    q = np.asarray(q, dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    m, n = len(q), len(t)
    if m == 0:
        return 0, 0
    prev = np.arange(m + 1, dtype=np.int64)  # column j=0
    best, best_j = int(prev[m]), 0
    for j in range(1, n + 1):
        cur = np.empty(m + 1, np.int64)
        cur[0] = 0
        sub = (q != t[j - 1]).astype(np.int64)
        for i in range(1, m + 1):
            cur[i] = min(prev[i - 1] + sub[i - 1], prev[i] + 1, cur[i - 1] + 1)
        if int(cur[m]) < best:
            best, best_j = int(cur[m]), j
        prev = cur
    return best, best_j


def myers_query_planes(q, qlen: int, W: int):
    """Bit-planes of one query, bit by bit: (q0, q1, vq, mend) lists of W
    ints.  Bit b of word w is query position 31*w + b; positions >= qlen
    and codes >= 4 are invalid (all planes 0 there); mend holds the
    single bit qlen - 1 (none for qlen == 0).  Reference for
    ops.myers.query_planes."""
    q0, q1, vq, mend = ([0] * W for _ in range(4))
    for i in range(min(int(qlen), len(q), 31 * W)):
        c = int(q[i])
        if c >= 4:
            continue
        w, b = divmod(i, 31)
        vq[w] |= 1 << b
        q0[w] |= (c & 1) << b
        q1[w] |= ((c >> 1) & 1) << b
    if qlen > 0:
        w, b = divmod(int(qlen) - 1, 31)
        mend[w] = 1 << b
    return q0, q1, vq, mend


def hw_traceback_votes(q, t):
    """Scalar oracle for the plane-based Myers traceback
    (ops/pileup.accumulate_backbone_votes_myers): full semi-global DP
    matrix, then a backward walk from (m, tend) with move precedence
    diag > up > left, stopping at i == 0 (free target prefix).

    Returns (dist, tend, subs, inss): subs = list of (col, sym) column
    votes with col 0-based and sym in {0..3 read base, 4 deletion};
    inss = list of (col, base, slot) insertion votes, base inserted after
    window column col, slot counted from the END of the insertion run.
    Codes >= 4 on either side never match (cost-1 substitutions).
    """
    q = np.asarray(q, dtype=np.int64)
    t = np.asarray(t, dtype=np.int64)
    m, n = len(q), len(t)
    D = np.zeros((m + 1, n + 1), np.int64)
    D[:, 0] = np.arange(m + 1)
    for j in range(1, n + 1):
        sub = ((q != t[j - 1]) | (q >= 4) | (t[j - 1] >= 4)).astype(np.int64)
        for i in range(1, m + 1):
            D[i, j] = min(D[i - 1, j - 1] + sub[i - 1], D[i - 1, j] + 1,
                          D[i, j - 1] + 1)
    if m == 0:
        return 0, 0, [], []
    tend = int(np.argmin(D[m, 1:]) + 1) if n else 0
    if n and D[m, 0] <= D[m, tend]:
        tend = 0
    dist = int(D[m, tend])
    i, j = m, tend
    subs: list = []
    inss: list = []
    run = 0
    while i >= 1:
        sub = 1 if (j < 1 or q[i - 1] != t[j - 1] or q[i - 1] >= 4
                    or t[j - 1] >= 4) else 0
        if j >= 1 and D[i - 1, j - 1] + sub == D[i, j]:
            subs.append((j - 1, int(q[i - 1])))
            i, j, run = i - 1, j - 1, 0
        elif D[i - 1, j] + 1 == D[i, j]:
            # up moves at j == 0 are read bases aligning BEFORE the window
            # (free target prefix) — not insertions after column -1
            if j >= 1:
                inss.append((j - 1, int(q[i - 1]), run))
            i, run = i - 1, run + 1
        else:
            subs.append((j - 1, 4))
            j, run = j - 1, 0
    return dist, tend, subs, inss

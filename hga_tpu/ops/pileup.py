"""L5 device ops — pileup consensus as scatter-add vote tensors.

Device replacement for the reference's per-column consensus loops
(SURVEY.md C12/C13, BASELINE.json: "batched POA/pileup DP on-device").  The
pileup is a (position x symbol) vote tensor built with one scatter-add over
all alignment columns, and the consensus base is an argmax per column with a
backbone prior — mirroring utils/oracle.pileup_consensus bit-for-bit.

The traceback that turns direction bitmaps into column votes also runs on
device (traceback_columns / accumulate_backbone_votes): a lax.scan walks all
P alignments of a batch backwards in lockstep and the emitted (column,
symbol) streams scatter-add straight into the carried vote tensors — the
dirs tensor never leaves HBM and there is no per-step host loop
(SURVEY.md L5; the reference walks each alignment in a scalar loop).

Symbols: 0..3 = A,C,G,T (substitution vote), 4 = deletion, 5 = unused slot
(reserved for insertion counts).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

I32 = jnp.int32
N_SYM = 6


@functools.partial(jax.jit, static_argnames=("length",))
def consensus_votes(
    cols: jax.Array,      # int32 (N,) backbone columns (0-based)
    syms: jax.Array,      # int32 (N,) symbol per vote (0..4)
    valid: jax.Array,     # bool  (N,)
    length: int,          # backbone capacity (static)
) -> jax.Array:
    """Scatter votes into a (length, N_SYM) tensor."""
    cols = jnp.where(valid, cols, length)      # out-of-range rows are dropped
    flat = cols * N_SYM + jnp.clip(syms, 0, N_SYM - 1)
    votes = jnp.zeros((length * N_SYM,), I32).at[flat].add(
        valid.astype(I32), mode="drop")
    return votes.reshape(length, N_SYM)


@functools.partial(jax.jit, static_argnames=("band", "Lt"))
def traceback_columns(
    dirs: jax.Array,   # int8 (D, P, W) from banded_sw_batch_dirs
    qend: jax.Array,   # int32 (P,) 0 disables the row
    tend: jax.Array,   # int32 (P,)
    q: jax.Array,      # int32 (P, Lq) oriented query codes
    band: int,
    Lt: int,
):
    """Vectorized device traceback over a pair batch (lax.scan, P in lanes).

    Semantically identical to the host walk it replaces (see
    models/correction.py history): per step every active alignment follows
    its direction bit; diagonal/left moves emit a column vote (read base /
    deletion symbol 4), up moves emit an insertion (read base inserted after
    the column, slot counted from the END of the insertion run — traceback
    walks backwards).

    Returns (sub_col, sub_sym, sub_ok, ins_col, ins_base, ins_slot, ins_ok),
    all (S, P) with S = Lq + Lt static.
    """
    D, P, W = dirs.shape
    Lq = q.shape[1]
    S = Lq + Lt
    pid = jnp.arange(P, dtype=I32)

    def step(carry, _):
        i, j, run, active = carry
        d = i + j
        o_d = jnp.maximum(jnp.maximum(1, d - Lt), (d - band + 1) // 2)
        p = i - o_d
        ok = active & (p >= 0) & (p < W) & (d >= 2)
        dir_ = jnp.where(
            ok,
            dirs[jnp.clip(d - 2, 0, D - 1), pid, jnp.clip(p, 0, W - 1)]
            .astype(I32),
            0)
        diag = active & (dir_ == 1)
        up = active & (dir_ == 2)
        left = active & (dir_ == 3)
        qsym = q[pid, jnp.clip(i - 1, 0, Lq - 1)]
        out = (j - 1,                                    # sub_col
               jnp.where(diag, qsym, 4),                 # sub_sym
               diag | left,                              # sub_ok
               j - 1,                                    # ins_col
               qsym,                                     # ins_base
               run,                                      # ins_slot
               up)                                       # ins_ok
        run = jnp.where(up, run + 1, 0)
        i = i - (diag | up).astype(I32)
        j = j - (diag | left).astype(I32)
        active = active & (dir_ != 0) & (i >= 1) & (j >= 1)
        return (i, j, run, active), out

    i0 = qend.astype(I32)
    j0 = tend.astype(I32)
    run0 = jnp.zeros((P,), I32)
    act0 = qend > 0
    _, outs = jax.lax.scan(step, (i0, j0, run0, act0), None, length=S)
    return outs


@functools.partial(jax.jit,
                   static_argnames=("size_v", "lpad", "band", "Lt",
                                    "ins_slots"),
                   donate_argnums=(0,))
def accumulate_backbone_votes_merged(
    merged: jax.Array,     # int32 (size_v + size_i,) FLAT — donated, updated
    dirs: jax.Array,       # int8 (D, P, W)
    qend: jax.Array,       # int32 (P,) — pre-masked by score threshold
    tend: jax.Array,       # int32 (P,)
    q: jax.Array,          # int32 (P, Lq) oriented query codes
    bb: jax.Array,         # int32 (P,) backbone id per pair
    off: jax.Array,        # int32 (P,) window col -> forward backbone col
    lb: jax.Array,         # int32 (P,) backbone true length per pair
    size_v: int,           # static: column votes live in merged[:size_v]
    lpad: int,
    band: int,
    Lt: int,
    ins_slots: int = 3,
) -> jax.Array:
    """Traceback one batch and scatter its votes into the carried tensor.

    `merged` is the column-vote tensor (NB*Lpad*N_SYM ints) and the
    insertion-vote tensor (NB*Lpad*ins_slots*4 ints) laid end to end in ONE
    donated flat buffer, updated in place across batches.

    Everything stays on device: the (D, P, W) dirs tensor is consumed here
    and never copied to host.  Out-of-range / masked votes are routed to an
    out-of-bounds flat index and dropped by the scatter's "drop" mode.

    The traceback scan computes the flat scatter indices IN the step (the
    per-pair bb/off/lb terms fold into the carry-free lane math), so each
    step emits two (P,) int32 index rows instead of seven value/mask rows
    — ~3.5x less scan-output HBM traffic — and the whole batch lands with
    ONE scatter-add instead of two.

    The carried vote tensor is FLAT 1-D on purpose: a tiled device layout
    can pad the tiny minor dims of a (NB, Lpad, 3, 4) tensor many-fold,
    which OOMs at judged scale.  Callers reshape on host.
    """
    D, P, W = dirs.shape
    Lq = q.shape[1]
    S = Lq + Lt
    size_all = merged.shape[0]
    pid = jnp.arange(P, dtype=I32)
    base_v = bb * (lpad * N_SYM)        # (P,) per-pair flat bases
    base_i = bb * (lpad * ins_slots * 4) + size_v

    def step(carry, _):
        i, j, run, active = carry
        d = i + j
        o_d = jnp.maximum(jnp.maximum(1, d - Lt), (d - band + 1) // 2)
        p = i - o_d
        ok = active & (p >= 0) & (p < W) & (d >= 2)
        dir_ = jnp.where(
            ok,
            dirs[jnp.clip(d - 2, 0, D - 1), pid, jnp.clip(p, 0, W - 1)]
            .astype(I32),
            0)
        diag = active & (dir_ == 1)
        up = active & (dir_ == 2)
        left = active & (dir_ == 3)
        qsym = q[pid, jnp.clip(i - 1, 0, Lq - 1)]
        colf = (j - 1) + off                      # forward backbone column
        in_rng = (colf >= 0) & (colf < lb)
        sym = jnp.where(diag, qsym, 4)
        idx_v = base_v + colf * N_SYM + sym
        idx_v = jnp.where((diag | left) & in_rng, idx_v, size_all)
        idx_i = (base_i + (colf * ins_slots
                           + jnp.clip(run, 0, ins_slots - 1)) * 4
                 + jnp.clip(qsym, 0, 3))
        idx_i = jnp.where(up & in_rng & (run < ins_slots), idx_i, size_all)
        run = jnp.where(up, run + 1, 0)
        i = i - (diag | up).astype(I32)
        j = j - (diag | left).astype(I32)
        active = active & (dir_ != 0) & (i >= 1) & (j >= 1)
        return (i, j, run, active), (idx_v, idx_i)

    init = (qend.astype(I32), tend.astype(I32), jnp.zeros((P,), I32),
            qend > 0)
    _, (idx_v, idx_i) = jax.lax.scan(step, init, None, length=S)

    return merged.at[jnp.concatenate(
        [idx_v.reshape(-1), idx_i.reshape(-1)])].add(1, mode="drop")


def _plane_prefix(words_pv, words_mv, i):
    """D(i, col) from that column's Pv/Mv planes: prefix sum of the vertical
    deltas over bits 0..i-1 (semi-global: D(0, col) = 0).

    words_pv/mv: int32 (P, W) the column's planes; i: int32 (P,).
    """
    W = words_pv.shape[1]
    total = jnp.zeros(i.shape, I32)
    for w in range(W):
        nbits = jnp.clip(i - 31 * w, 0, 31)
        # 1<<31 wraps to INT32_MIN; -1 then wraps to M31 — exactly the
        # 31-bit payload mask the planes use
        mask = jnp.left_shift(jnp.int32(1), nbits) - 1
        total = total + (jax.lax.population_count(words_pv[:, w] & mask)
                         - jax.lax.population_count(words_mv[:, w] & mask))
    return total


def _plane_bit(words_pv, words_mv, i):
    """Vertical delta at row i of a column's planes: +1/-1/0 (bit i-1)."""
    W = words_pv.shape[1]
    wi = (i - 1) // 31
    bi = (i - 1) % 31
    d = jnp.zeros(i.shape, I32)
    for w in range(W):
        sel = wi == w
        pb = jax.lax.shift_right_logical(words_pv[:, w], bi) & 1
        mb = jax.lax.shift_right_logical(words_mv[:, w], bi) & 1
        d = jnp.where(sel, pb - mb, d)
    return d


@functools.partial(jax.jit,
                   static_argnames=("size_v", "lpad", "ins_slots",
                                    "max_steps"),
                   donate_argnums=(0,))
def accumulate_backbone_votes_myers(
    merged: jax.Array,     # int32 (size_v + size_i,) FLAT — donated, updated
    pv_planes: jax.Array,  # int32 (Lt, P, W) from myers planes DP
    mv_planes: jax.Array,  # int32 (Lt, P, W)
    dist: jax.Array,       # int32 (P,) semi-global edit distance
    qend: jax.Array,       # int32 (P,) = qlen, pre-masked 0 by the gate
    tend: jax.Array,       # int32 (P,) end column (1-based)
    q: jax.Array,          # int32 (P, Lq) oriented query codes
    t: jax.Array,          # int32 (P, Lt) backbone window codes
    bb: jax.Array,         # int32 (P,) backbone id per pair
    off: jax.Array,        # int32 (P,) window col -> forward backbone col
    lb: jax.Array,         # int32 (P,) backbone true length per pair
    qw: Optional[jax.Array] = None,  # int32 (P, Lq) per-base vote weights
    *,
    size_v: int,
    lpad: int,
    ins_slots: int = 3,
    max_steps: Optional[int] = None,
) -> jax.Array:
    """Plane-based traceback + vote scatter: the Myers-engine replacement
    for accumulate_backbone_votes_merged (same vote semantics, same merged
    flat buffer), fed by the bit-parallel DP instead of the scored
    dirs DP.

    qw: optional per-base vote weights in the ORIENTED query frame
    (quality-weighted consensus, cfg.use_quality): a base/insertion vote
    adds qw[pid, i-1]; a deletion vote weighs the flanking read base the
    same way.  None keeps the unweighted +1 scatter (the default).

    Moves are re-derived from the stored Pv/Mv vertical-delta planes: at
    cell (i, j) holding distance D, the left/diagonal neighbors' distances
    are plane prefix sums of column j-1 and the up neighbor's is D minus the
    vertical delta bit of column j — no direction tensor is ever
    materialized.  Precedence diag > up > left (deterministic gap
    placement, matching utils/oracle.hw_traceback_votes bit-for-bit).
    Traceback stops at i == 0 (free target prefix).

    max_steps: optional static bound on the scan length.  The walk takes
    #diag + #up <= qlen i-decrements and #left <= dist j-only-decrements
    (every up/left move costs one edit), so the path never exceeds
    qlen + dist.  Callers that gate rows on dist <= (1 - min_identity) *
    qlen can therefore pass Lq + ceil((1 - min_identity) * Lq) + 1 and cut
    the lockstep scan (the correction stage's binding constraint,
    ROADMAP.md round-4 split) ~2x without changing a single vote.
    """
    Lt, P, W = pv_planes.shape
    Lq = q.shape[1]
    S = Lq + Lt
    if max_steps is not None:
        S = min(S, max_steps)
    size_all = merged.shape[0]
    pid = jnp.arange(P, dtype=I32)
    base_v = bb * (lpad * N_SYM)
    base_i = bb * (lpad * ins_slots * 4) + size_v

    def step(carry, _):
        i, j, D, run, active = carry
        jm1 = jnp.clip(j - 1, 0, Lt - 1)
        jm2 = jnp.clip(j - 2, 0, Lt - 1)
        pv1 = pv_planes[jm1, pid]          # (P, W) column j's planes
        mv1 = mv_planes[jm1, pid]
        pv2 = pv_planes[jm2, pid]          # column (j-1)'s planes
        mv2 = mv_planes[jm2, pid]
        # up neighbor: D(i-1, j) = D - deltaV(i, j); column 0 has D(i,0)=i
        dv_j = jnp.where(j >= 1, _plane_bit(pv1, mv1, i), 1)
        # left/diag neighbors need column j-1's cell values
        dl = jnp.where(j >= 2, _plane_prefix(pv2, mv2, i), i)       # D(i,j-1)
        dv_jm1 = jnp.where(j >= 2, _plane_bit(pv2, mv2, i), 1)
        dd = dl - dv_jm1                                        # D(i-1,j-1)
        qsym = q[pid, jnp.clip(i - 1, 0, Lq - 1)]
        tsym = t[pid, jm1]
        sub = ((qsym != tsym) | (qsym >= 4) | (tsym >= 4)).astype(I32)
        can_diag = active & (j >= 1) & (dd + sub == D)
        can_up = active & (dv_j == 1)
        can_left = active & (j >= 1) & (dl + 1 == D)
        diag = can_diag
        up = can_up & ~diag
        left = can_left & ~diag & ~up
        colf = (j - 1) + off
        in_rng = (colf >= 0) & (colf < lb)
        sym = jnp.where(diag, qsym, 4)
        idx_v = base_v + colf * N_SYM + sym
        idx_v = jnp.where((diag | left) & in_rng, idx_v, size_all)
        idx_i = (base_i + (colf * ins_slots
                           + jnp.clip(run, 0, ins_slots - 1)) * 4
                 + jnp.clip(qsym, 0, 3))
        # j >= 1: once the walk reaches the free target prefix (j == 0) the
        # remaining read bases align BEFORE the window — voting them as
        # insertions at column off-1 would be spurious when the window
        # starts mid-backbone (off > 0).  The SW dirs engine clips these
        # (its walk stops at j < 1); mirror that here.
        idx_i = jnp.where(up & in_rng & (run < ins_slots) & (j >= 1),
                          idx_i, size_all)
        run = jnp.where(up, run + 1, 0)
        # vote weight: the read base this step consumed (flanking base for
        # a deletion, which consumes none) — one gather shared by both the
        # column and the insertion vote of this step
        w = (jnp.ones((P,), I32) if qw is None
             else qw[pid, jnp.clip(i - 1, 0, Lq - 1)])
        D = D - jnp.where(diag, sub, (up | left).astype(I32))
        i = i - (diag | up).astype(I32)
        j = j - (diag | left).astype(I32)
        active = active & (diag | up | left) & (i >= 1)
        return (i, j, D, run, active), (idx_v, idx_i, w)

    init = (qend.astype(I32), tend.astype(I32), dist.astype(I32),
            jnp.zeros((P,), I32), qend > 0)
    _, (idx_v, idx_i, w) = jax.lax.scan(step, init, None, length=S)
    idx_cat = jnp.concatenate([idx_v.reshape(-1), idx_i.reshape(-1)])
    if qw is None:
        return merged.at[idx_cat].add(1, mode="drop")
    w_flat = w.reshape(-1)
    return merged.at[idx_cat].add(
        jnp.concatenate([w_flat, w_flat]), mode="drop")


def accumulate_backbone_votes(
    votes: jax.Array,      # int32 (NB*Lpad*N_SYM,) FLAT
    ins_votes: jax.Array,  # int32 (NB*Lpad*ins_slots*4,) FLAT
    dirs: jax.Array,
    qend: jax.Array,
    tend: jax.Array,
    q: jax.Array,
    bb: jax.Array,
    off: jax.Array,
    lb: jax.Array,
    lpad: int,
    band: int,
    Lt: int,
    ins_slots: int = 3,
) -> Tuple[jax.Array, jax.Array]:
    """Two-tensor convenience wrapper over accumulate_backbone_votes_merged
    (concatenates per call — production carries the merged buffer instead)."""
    size_v = votes.shape[0]
    merged = accumulate_backbone_votes_merged(
        jnp.concatenate([votes, ins_votes]), dirs, qend, tend, q, bb, off,
        lb, size_v=size_v, lpad=lpad, band=band, Lt=Lt, ins_slots=ins_slots)
    return merged[:size_v], merged[size_v:]


@functools.partial(jax.jit, static_argnames=("min_depth",))
def consensus_call(
    votes: jax.Array,      # int32 (L, N_SYM) or FLAT (L*N_SYM,)
    backbone: jax.Array,   # int32 (L,) backbone base codes
    min_depth: int = 2,
) -> Tuple[jax.Array, jax.Array]:
    """Per-column consensus symbol (argmax with +1 backbone prior).

    Returns (symbols int32 (L,), depth int32 (L,)); columns with depth <
    min_depth keep the backbone base.  Oracle: pileup_consensus.

    Accepts the flat layout the scatter path produces; internally the five
    symbol planes are handled as (5, L) — NEVER (L, 5), whose minor dim
    would pad to a (8, 128) tile (21x HBM at scale).
    """
    if votes.ndim == 2:
        votes = votes.reshape(-1)
    bb = backbone.astype(I32)
    planes = jnp.stack([votes[s::N_SYM] + (bb == s).astype(I32)
                        for s in range(5)], axis=0)          # (5, L)
    depth = jnp.sum(planes, axis=0) - 1       # prior vote excluded
    best = jnp.argmax(planes, axis=0).astype(I32)  # ties -> lower symbol
    out = jnp.where(depth >= min_depth, best, bb)
    return out, depth


@functools.partial(jax.jit, static_argnames=("min_depth", "size_v",
                                             "ins_slots", "cap"))
def consensus_and_insertions(
    merged: jax.Array,     # int32 (size_v + size_i,) flat vote buffer
    backbone: jax.Array,   # int32 (L,) backbone base codes (L = nb*lpad)
    *,
    min_depth: int,
    size_v: int,
    ins_slots: int,
    cap: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Device-side consensus symbols + SPARSE insertion calls.

    The dense path read the whole insertion vote tensor back to host —
    nb x lpad x slots x 4 int32 = ~1.2 GB per judged-scale correction
    group.  Insertion calls are rare (error-rate-bounded), so the
    call happens on device and only the called entries come back:

    returns (sym int8 (L,), n_ins int32, packed int32 (cap,)) with
    packed[i] = ((col_flat * ins_slots + slot) << 2) | base for the first
    n_ins called insertions (ascending flat order).  Callers fetch
    packed[:pow2(n_ins)].  n_ins > cap means the cap was exceeded (callers
    fall back to the dense path; never silently dropped).
    """
    votes = merged[:size_v]
    sym, depth = consensus_call(votes, backbone, min_depth=min_depth)
    ins = merged[size_v:]
    # max/argmax over the 4 base planes via strided slices — NEVER a
    # (M, 4) tensor, whose minor dim of 4 a tiled layout can pad many-fold.
    # Ties pick the lowest base, matching dense argmax.
    p0, p1, p2, p3 = (ins[b::4] for b in range(4))
    m01 = jnp.maximum(p0, p1)
    a01 = (p1 > p0).astype(I32)
    m23 = jnp.maximum(p2, p3)
    a23 = 2 + (p3 > p2).astype(I32)
    cnt = jnp.maximum(m01, m23)
    best = jnp.where(m23 > m01, a23, a01)
    col_of = jnp.arange(cnt.shape[0], dtype=I32) // ins_slots
    need = jnp.maximum(min_depth, (depth + 1) // 2)
    do = cnt >= need[col_of]
    n = jnp.sum(do.astype(I32))
    dest = jnp.where(do, jnp.cumsum(do.astype(I32)) - 1, cap)
    packed_val = (jnp.arange(cnt.shape[0], dtype=I32) << 2) | best
    packed = jnp.zeros((cap + 1,), I32).at[dest].set(
        packed_val, mode="drop")[:cap]
    return sym.astype(jnp.int8), n, packed

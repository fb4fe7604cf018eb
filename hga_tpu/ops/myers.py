"""L3 — bit-parallel Myers overlap DP (the plain XLA reference engine).

Replaces scored banded SW on the overlap-extension hot path (SURVEY.md C9,
"scalar alignment loops"; call stack §4.2) with Myers' 1999 bit-parallel
semi-global edit distance: one int32 word advances 31 DP cells per
elementwise op, and every pair is independent — no cross-pair shifts, no
per-step windows, no band mask.  The wavefront SW DP (ops/align.py) remains
for scored alignment (cfg.overlap_refine / corr_engine = "sw").

This module is the reference the GPU kernel (ops/myers_pallas.py) is
checked against bit for bit, and the engine wherever that kernel does not
run: the CPU, a shared 1-row target, queries over its word cap, and the
resumable column form the ring engine (parallel/ring_myers.py) uses.

Semantics (oracle.edit_distance_hw): infix / "HW" mode — the query aligns
fully, target start and end are free: D[i][0] = i, D[0][j] = 0, the result
is min_j D[m][j] with the smallest such j (the end position in the target).

Word layout: 31 payload bits per int32 word (bit 31 catches the adder and
shifter carries), W = ceil(Lq/31) words per pair.  The query is stored as
two bit-planes (low/high base bit) plus a validity plane; Eq for target
symbol c is then three bitwise ops per word, with no per-symbol Peq table
and therefore no gathers.  Invalid bases (code >= 4: pads, window
sentinels) never match on either side.

The column recurrence per word (Myers search mode, Hyyro's block form):

    Eq = VQ & ~((Q0 ^ T0) | (Q1 ^ T1)) & TV
    Xv = Eq | Mv
    s  = (Eq & Pv) + Pv + carry_in          # carry chains through bit 31
    Xh = (s ^ Pv) | Eq
    Ph = Mv | ~(Xh | Pv)
    Mh = Pv & Xh
    score += bottom-bit(Ph) - bottom-bit(Mh)
    Ph, Mh <<= 1                            # cross-word via bit 30
    Pv' = (Mh | ~(Xv | Ph)) & M31
    Mv' = Ph & Xv
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

I32 = jnp.int32
PAYLOAD = 31
M31 = (1 << 31) - 1          # payload mask (bit 31 clear)
M30 = (1 << 30) - 1


class MyersResult(NamedTuple):
    dist: jax.Array   # int32 (N,) min semi-global edit distance
    tend: jax.Array   # int32 (N,) end position in target (1-based, 0 if m=0)


def n_words(Lq: int) -> int:
    return max(1, -(-Lq // PAYLOAD))


def query_planes(q: jax.Array, qlen: jax.Array, W: int):
    """Bit-planes of the query: Q0/Q1 (low/high base bit) and VQ (validity).

    q: int32 (N, Lq) base codes; codes >= 4 and positions >= qlen are
    invalid.  Returns three int32 (N, W) arrays (bit b of word w = query
    position w*31+b) and the per-pair end-bit mask mend (N, W) with the
    single bit (qlen-1) set.
    """
    N, Lq = q.shape
    pad = W * PAYLOAD - Lq
    qp = jnp.pad(q.astype(I32), ((0, 0), (0, pad)), constant_values=4)
    pos = jnp.arange(W * PAYLOAD, dtype=I32)[None, :]
    ql = qlen.astype(I32)[:, None]
    valid = (pos < ql) & (qp < 4)
    b0 = (qp & 1).astype(I32)
    b1 = ((qp >> 1) & 1).astype(I32)
    shifts = (jnp.arange(W * PAYLOAD, dtype=I32) % PAYLOAD)[None, :]

    def plane(bits):
        # each bit lands on its own position of its word, so an integer sum
        # over the word's 31 positions equals their OR (exact, no carries)
        v = (bits << shifts).astype(I32).reshape(N, W, PAYLOAD)
        return jnp.sum(v, axis=2, dtype=I32)

    q0 = plane(b0 * valid)
    q1 = plane(b1 * valid)
    vq = plane(valid.astype(I32))
    end_bit = jnp.maximum(ql - 1, 0)
    mend = jnp.where(
        (end_bit // PAYLOAD == jnp.arange(W)[None, :]) & (ql > 0),
        (1 << (end_bit % PAYLOAD)).astype(I32), 0)
    return q0, q1, vq, mend


def myers_init_state(qlen: jax.Array, W: int):
    """Fresh column-0 state (pv, mv, score, best, bj) for a query batch."""
    N = qlen.shape[0]
    ql = qlen.astype(I32)
    return (jnp.full((N, W), M31, I32), jnp.zeros((N, W), I32),
            ql, ql, jnp.zeros((N,), I32))


def myers_cols(q0, q1, vq, mend, t, tlen, state, j0=0):
    """Advance the Myers recurrence over the target columns in `t`.

    state: (pv, mv, score, best, bj) from myers_init_state or a previous
    myers_cols call; j0 is the GLOBAL index of t's first column (tend values
    and the tlen mask stay global).  This resumable form is what the ring
    sequence-parallel engine (parallel/ring_myers.py) hands from chip to
    chip: the (pv, mv, score, best, bj) tuple IS the halo.
    """
    N, W = q0.shape
    Lt = t.shape[1]
    tl = tlen.astype(I32)
    tt = t.astype(I32)
    j0 = jnp.asarray(j0, I32)

    def col(j, carry):
        pv, mv, score, best, bj = carry
        tc = jax.lax.dynamic_slice_in_dim(tt, j, 1, axis=1)     # (N, 1)
        t0 = -(tc & 1)
        t1 = -((tc >> 1) & 1)
        tvm = -(((tc >= 0) & (tc < 4)).astype(I32))  # -1 valid, else 0:
        # full compare so any code outside 0..3 (sentinels, negative pads,
        # aliases >= 8) never matches, matching the documented contract
        eq = (vq & ~((q0 ^ t0) | (q1 ^ t1))) & tvm
        xv = eq | mv
        a = eq & pv
        # multi-word add with carry through bit 31, vectorized with a scan
        # over the W axis is overkill for W<=5: unroll via per-word slices
        s_words = []
        c = jnp.zeros((N, 1), I32)
        for w in range(W):
            sw = a[:, w:w + 1] + pv[:, w:w + 1] + c
            c = jax.lax.shift_right_logical(sw, 31) & 1
            s_words.append(sw & M31)
        s = jnp.concatenate(s_words, axis=1)
        xh = (s ^ pv) | eq
        ph = mv | ~(xh | pv)
        mh = pv & xh
        pb = ph & mend
        mb = mh & mend
        pbit = jnp.sign(jnp.sum(jnp.abs(jnp.sign(pb)), axis=1)).astype(I32)
        mbit = jnp.sign(jnp.sum(jnp.abs(jnp.sign(mb)), axis=1)).astype(I32)
        score = score + pbit - mbit
        # cross-word left shift via bit 30
        cp = jnp.concatenate(
            [jnp.zeros((N, 1), I32),
             jax.lax.shift_right_logical(ph[:, :-1], 30) & 1], axis=1)
        cm = jnp.concatenate(
            [jnp.zeros((N, 1), I32),
             jax.lax.shift_right_logical(mh[:, :-1], 30) & 1], axis=1)
        ph = ((ph << 1) & M31) | cp
        mh = ((mh << 1) & M31) | cm
        pv = (mh | ~(xv | ph)) & M31
        mv = ph & xv
        jg = j0 + j
        take = (score < best) & (jg < tl)
        bj = jnp.where(take, jg + 1, bj)
        best = jnp.where(take, score, best)
        return (pv, mv, score, best, bj)

    return jax.lax.fori_loop(0, Lt, col, state)


def myers_cols_planes(q0, q1, vq, mend, t, tlen, state, j0=0):
    """myers_cols, additionally COLLECTING the per-column Pv/Mv bit-planes.

    Returns (final_state, pv_planes, mv_planes) with planes int32
    (Lt, N, W): planes[c] is the vertical-delta state AFTER processing
    target column j0+c+1.  D(i, j) for any cell reconstructs as the prefix
    sum of the plane bits (+1 where Pv, -1 where Mv, bits 0..i-1), which is
    what the plane-based traceback (ops/pileup.accumulate_backbone_votes_
    myers) uses to re-derive alignment moves at gate speed — the device
    replacement for the reference's scalar traceback loops (SURVEY.md C12,
    §4.4) without a scored-DP direction tensor.
    """
    N, W = q0.shape
    Lt = t.shape[1]
    tl = tlen.astype(I32)
    tt = t.astype(I32)
    j0 = jnp.asarray(j0, I32)

    def col(carry, j):
        pv, mv, score, best, bj = carry
        tc = jax.lax.dynamic_slice_in_dim(tt, j, 1, axis=1)     # (N, 1)
        t0 = -(tc & 1)
        t1 = -((tc >> 1) & 1)
        tvm = -(((tc >= 0) & (tc < 4)).astype(I32))
        eq = (vq & ~((q0 ^ t0) | (q1 ^ t1))) & tvm
        xv = eq | mv
        a = eq & pv
        s_words = []
        c = jnp.zeros((N, 1), I32)
        for w in range(W):
            sw = a[:, w:w + 1] + pv[:, w:w + 1] + c
            c = jax.lax.shift_right_logical(sw, 31) & 1
            s_words.append(sw & M31)
        s = jnp.concatenate(s_words, axis=1)
        xh = (s ^ pv) | eq
        ph = mv | ~(xh | pv)
        mh = pv & xh
        pb = ph & mend
        mb = mh & mend
        pbit = jnp.sign(jnp.sum(jnp.abs(jnp.sign(pb)), axis=1)).astype(I32)
        mbit = jnp.sign(jnp.sum(jnp.abs(jnp.sign(mb)), axis=1)).astype(I32)
        score = score + pbit - mbit
        cp = jnp.concatenate(
            [jnp.zeros((N, 1), I32),
             jax.lax.shift_right_logical(ph[:, :-1], 30) & 1], axis=1)
        cm = jnp.concatenate(
            [jnp.zeros((N, 1), I32),
             jax.lax.shift_right_logical(mh[:, :-1], 30) & 1], axis=1)
        ph = ((ph << 1) & M31) | cp
        mh = ((mh << 1) & M31) | cm
        pv = (mh | ~(xv | ph)) & M31
        mv = ph & xv
        jg = j0 + j
        take = (score < best) & (jg < tl)
        bj = jnp.where(take, jg + 1, bj)
        best = jnp.where(take, score, best)
        return (pv, mv, score, best, bj), (pv, mv)

    final, (pvp, mvp) = jax.lax.scan(col, state,
                                     jnp.arange(Lt, dtype=I32))
    return final, pvp, mvp


@functools.partial(jax.jit, static_argnames=("W",))
def myers_batch_planes(q: jax.Array, t: jax.Array, qlen: jax.Array,
                       tlen: jax.Array, W: int = 0):
    """myers_batch + per-column Pv/Mv planes (XLA reference engine).

    Returns (MyersResult, pv_planes, mv_planes), planes int32 (Lt, N, W).
    On the GPU, ops/myers_pallas.myers_batch_planes_pallas computes the
    identical result.
    """
    N, Lq = q.shape
    W = W or n_words(Lq)
    q0, q1, vq, mend = query_planes(q, qlen, W)
    state = myers_init_state(qlen, W)
    (_, _, _, best, bj), pvp, mvp = myers_cols_planes(
        q0, q1, vq, mend, t, tlen, state)
    zero = qlen.astype(I32) == 0
    res = MyersResult(dist=jnp.where(zero, 0, best),
                      tend=jnp.where(zero, 0, bj))
    return res, pvp, mvp


@functools.partial(jax.jit, static_argnames=("W",))
def myers_batch(q: jax.Array, t: jax.Array, qlen: jax.Array,
                tlen: jax.Array, W: int = 0) -> MyersResult:
    """Batched bit-parallel semi-global edit distance (XLA column scan).

    q, t: int32 base codes (N, Lq), (N, Lt); codes outside 0..3 never match.
    Runs on every backend; on the GPU the Pallas kernel in
    ops/myers_pallas.py computes the identical result.
    """
    N, Lq = q.shape
    W = W or n_words(Lq)
    q0, q1, vq, mend = query_planes(q, qlen, W)   # (N, W) each
    state = myers_init_state(qlen, W)
    _, _, _, best, bj = myers_cols(q0, q1, vq, mend, t, tlen, state)
    zero = qlen.astype(I32) == 0
    return MyersResult(dist=jnp.where(zero, 0, best),
                       tend=jnp.where(zero, 0, bj))

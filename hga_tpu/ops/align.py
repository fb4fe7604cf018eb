"""L3 device ops — banded Smith-Waterman as an anti-diagonal wavefront.

Device replacement for the reference's scalar cell-at-a-time alignment
loops (SURVEY.md C9, BASELINE.json: "scalar alignment loops" become "tiled
wavefront DP kernels").  The production overlap gate and correction DP run
the bit-parallel Myers engine (ops/myers.py); this scored DP serves
cfg.overlap_refine = "sw" and cfg.corr_engine = "sw".

Layout:

* A batch of P pairs is aligned simultaneously; the DP state is a pair of
  anti-diagonal vectors shaped (P, W) — P pairs by band width W.
* Cells on anti-diagonal d are indexed by query position i (no parity gaps):
  the vector slot p holds cell (i, j) with i = o(d) + p, j = d - i, where
  o(d) = max(1, d - Lt, ceil((d - band) / 2)) is the band's lower i bound.
* All three DP dependencies live on the two previous anti-diagonals at slot
  offsets {Δ1-1, Δ1, Δ2-1} with Δn = o(d) - o(d-n) ∈ {0,1,2} — pure vector
  shifts, zero intra-step dependencies (the classic wavefront property).
* Linear gap, all-integer scores (bit-identical contigs need no floats,
  SURVEY.md §8.3 item 2).

Scoring semantics are oracle.banded_sw with diag=0: callers center the band
by pre-shifting the target window (models/overlap.py); best cell ties break
by smallest anti-diagonal then smallest i — the sweep order here.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

I32 = jnp.int32
NEG = jnp.int32(-(2**30))


class SWResult(NamedTuple):
    score: jax.Array  # int32 (P,) best local score (0 if none positive)
    qend: jax.Array   # int32 (P,) query end, 1-based inclusive (0 if score 0)
    tend: jax.Array   # int32 (P,) target end, 1-based inclusive


def _o_of(d, band: int, Lt: int):
    """Lower i bound of the band on anti-diagonal d (traced or static)."""
    return jnp.maximum(jnp.maximum(1, d - Lt), (d - band + 1) // 2)


def _shift(ext: jax.Array, s, W: int) -> jax.Array:
    """ext: (P, W+4) NEG-padded by 2 each side; returns ext[:, 2+s : 2+s+W]
    for traced s in {-1, 0, 1, 2}."""
    P = ext.shape[0]
    return jax.lax.dynamic_slice(ext, (jnp.int32(0), (2 + s).astype(I32)),
                                 (P, W))


def _pad2(x: jax.Array) -> jax.Array:
    P = x.shape[0]
    pad = jnp.full((P, 2), NEG, I32)
    return jnp.concatenate([pad, x, pad], axis=1)


@functools.partial(
    jax.jit, static_argnames=("band", "match", "mismatch", "gap"))
def banded_sw_batch(
    q: jax.Array,     # int32 (P, Lq) base codes (content past qlen ignored)
    t: jax.Array,     # int32 (P, Lt)
    qlen: jax.Array,  # int32 (P,)
    tlen: jax.Array,  # int32 (P,)
    band: int = 64,
    match: int = 2,
    mismatch: int = -4,
    gap: int = -3,
) -> SWResult:
    """Batched banded local SW, score + end coordinates (wavefront sweep)."""
    P, Lq = q.shape
    Lt = t.shape[1]
    W = band + 1
    W = ((W + 127) // 128) * 128  # lane-pad the band vector

    q_ext = jnp.pad(q.astype(I32), ((0, 0), (0, W)))          # i-slice safety
    t_rev = jnp.flip(t.astype(I32), axis=1)
    t_ext = jnp.pad(t_rev, ((0, 0), (0, W)))                  # j-slice safety

    p_idx = jnp.arange(W, dtype=I32)[None, :]
    qlen_c = qlen.astype(I32)[:, None]
    tlen_c = tlen.astype(I32)[:, None]

    def step(d, carry):
        ad1, ad2, best, best_d, best_p = carry
        o_d = _o_of(d, band, Lt)
        d1 = o_d - _o_of(d - 1, band, Lt)
        d2 = o_d - _o_of(d - 2, band, Lt)

        i = o_d + p_idx          # (1, W) broadcast over P
        j = d - i

        qs = jax.lax.dynamic_slice(q_ext, (jnp.int32(0), o_d - 1), (P, W))
        ts = jax.lax.dynamic_slice(t_ext, (jnp.int32(0), Lt - d + o_d), (P, W))
        sub = jnp.where(qs == ts, jnp.int32(match), jnp.int32(mismatch))

        ad1e = _pad2(ad1)
        ad2e = _pad2(ad2)
        diag_v = _shift(ad2e, d2 - 1, W)
        up_v = _shift(ad1e, d1 - 1, W)
        left_v = _shift(ad1e, d1, W)
        # implicit zero row/column H[0, *] = H[*, 0] = 0
        diag_v = jnp.where((i == 1) | (j == 1), 0, diag_v)
        up_v = jnp.where(i == 1, 0, up_v)
        left_v = jnp.where(j == 1, 0, left_v)

        v = jnp.maximum(
            jnp.maximum(diag_v + sub, jnp.int32(0)),
            jnp.maximum(up_v + jnp.int32(gap), left_v + jnp.int32(gap)),
        )
        i_hi = jnp.minimum(jnp.minimum(Lq, d - 1), (d + band) // 2)
        valid = (p_idx <= i_hi - o_d) & (i <= qlen_c) & (j >= 1) & (j <= tlen_c)
        v = jnp.where(valid, v, NEG)

        m = jnp.max(v, axis=1)
        pm = jnp.argmax(v, axis=1).astype(I32)  # first max -> smallest i
        better = m > best
        best = jnp.where(better, m, best)
        best_d = jnp.where(better, d, best_d)
        best_p = jnp.where(better, pm, best_p)
        return (v, ad1, best, best_d, best_p)

    ad_init = jnp.full((P, W), NEG, I32)
    best0 = jnp.zeros((P,), I32)
    carry = (ad_init, ad_init, best0, best0, best0)
    carry = jax.lax.fori_loop(2, Lq + Lt + 1, step, carry)
    _, _, best, best_d, best_p = carry

    has = best > 0
    qend = jnp.where(has, _o_of(best_d, band, Lt) + best_p, 0)
    tend = jnp.where(has, best_d - qend, 0)
    return SWResult(score=jnp.maximum(best, 0), qend=qend, tend=tend)


@functools.partial(
    jax.jit, static_argnames=("band", "match", "mismatch", "gap"))
def banded_sw_batch_dirs(
    q: jax.Array,
    t: jax.Array,
    qlen: jax.Array,
    tlen: jax.Array,
    band: int = 64,
    match: int = 2,
    mismatch: int = -4,
    gap: int = -3,
) -> Tuple[SWResult, jax.Array]:
    """Wavefront SW that also records per-cell traceback directions.

    Returns (SWResult, dirs) with dirs int8 (D, P, W), D = Lq+Lt-1 steps
    (index d-2), W the padded band width; dir codes: 0 = local start (stop),
    1 = diagonal, 2 = up (gap in target), 3 = left (gap in query) — matching
    the oracle's diag > up > left preference.  Used by the correction /
    polishing stage (models/correction.py) where base-level columns are
    needed; the score-only variant stays cheaper for overlap detection.
    """
    P, Lq = q.shape
    Lt = t.shape[1]
    W = ((band + 1 + 127) // 128) * 128

    q_ext = jnp.pad(q.astype(I32), ((0, 0), (0, W)))
    t_rev = jnp.flip(t.astype(I32), axis=1)
    t_ext = jnp.pad(t_rev, ((0, 0), (0, W)))
    p_idx = jnp.arange(W, dtype=I32)[None, :]
    qlen_c = qlen.astype(I32)[:, None]
    tlen_c = tlen.astype(I32)[:, None]

    def step(carry, d):
        ad1, ad2, best, best_d, best_p = carry
        o_d = _o_of(d, band, Lt)
        d1 = o_d - _o_of(d - 1, band, Lt)
        d2 = o_d - _o_of(d - 2, band, Lt)
        i = o_d + p_idx
        j = d - i
        qs = jax.lax.dynamic_slice(q_ext, (jnp.int32(0), o_d - 1), (P, W))
        ts = jax.lax.dynamic_slice(t_ext, (jnp.int32(0), Lt - d + o_d), (P, W))
        sub = jnp.where(qs == ts, jnp.int32(match), jnp.int32(mismatch))
        ad1e = _pad2(ad1)
        ad2e = _pad2(ad2)
        diag_v = _shift(ad2e, d2 - 1, W)
        up_v = _shift(ad1e, d1 - 1, W)
        left_v = _shift(ad1e, d1, W)
        diag_v = jnp.where((i == 1) | (j == 1), 0, diag_v)
        up_v = jnp.where(i == 1, 0, up_v)
        left_v = jnp.where(j == 1, 0, left_v)
        cand_diag = diag_v + sub
        cand_up = up_v + jnp.int32(gap)
        cand_left = left_v + jnp.int32(gap)
        v = jnp.maximum(jnp.maximum(cand_diag, jnp.int32(0)),
                        jnp.maximum(cand_up, cand_left))
        # direction of the winning predecessor (diag > up > left > stop)
        dirs = jnp.where(
            v == cand_diag, jnp.int8(1),
            jnp.where(v == cand_up, jnp.int8(2),
                      jnp.where(v == cand_left, jnp.int8(3), jnp.int8(0))))
        dirs = jnp.where(v == 0, jnp.int8(0), dirs)
        i_hi = jnp.minimum(jnp.minimum(Lq, d - 1), (d + band) // 2)
        valid = (p_idx <= i_hi - o_d) & (i <= qlen_c) & (j >= 1) & (j <= tlen_c)
        v = jnp.where(valid, v, NEG)
        dirs = jnp.where(valid, dirs, jnp.int8(0))
        m = jnp.max(v, axis=1)
        pm = jnp.argmax(v, axis=1).astype(I32)
        better = m > best
        best = jnp.where(better, m, best)
        best_d = jnp.where(better, d, best_d)
        best_p = jnp.where(better, pm, best_p)
        return (v, ad1, best, best_d, best_p), dirs

    ad_init = jnp.full((P, W), NEG, I32)
    z = jnp.zeros((P,), I32)
    carry = (ad_init, ad_init, z, z, z)
    ds = jnp.arange(2, Lq + Lt + 1, dtype=I32)
    carry, dir_steps = jax.lax.scan(step, carry, ds)
    _, _, best, best_d, best_p = carry
    has = best > 0
    qend = jnp.where(has, _o_of(best_d, band, Lt) + best_p, 0)
    tend = jnp.where(has, best_d - qend, 0)
    res = SWResult(score=jnp.maximum(best, 0), qend=qend, tend=tend)
    return res, dir_steps


def o_of_host(d, band: int, Lt: int):
    """Host mirror of the band's lower i bound (for traceback indexing)."""
    import numpy as np

    return np.maximum(np.maximum(1, d - Lt), (d - band + 1) // 2)


def sw_cells(qlen, tlen, band: int):
    """Number of in-band DP cells actually defined (for GCUPS accounting)."""
    import numpy as np

    qlen = np.asarray(qlen)
    tlen = np.asarray(tlen)
    total = 0
    for L, T in zip(qlen.ravel(), tlen.ravel()):
        i = np.arange(1, L + 1)
        lo = np.maximum(1, i - band)
        hi = np.minimum(T, i + band)
        total += int(np.maximum(0, hi - lo + 1).sum())
    return total

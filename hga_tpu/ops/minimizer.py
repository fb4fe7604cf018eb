"""L2 device ops — (w,k)-minimizer selection as a vectorized window-min.

Device replacement for the reference's per-read rolling minimizer /
shared-k-mer seed selection (SURVEY.md C6).  The window-minimum over w
consecutive hashed k-mers is computed for the whole (reads x windows) plane
at once from w statically-shifted views — O(w) fused elementwise passes, no
queues, no data-dependent control flow (cf. PAPERS.md "Parallel approach
to sliding window sums").

Semantics (oracle: utils/oracle.minimizers):
* hash = fmix32(lo ^ hi*golden); invalid k-mers never win a window.
* window j over k-mer positions [j, j+w); winner = leftmost minimal hash.
* consecutive windows choosing the same position emit one minimizer.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from hga_tpu.ops.kmer import KmerBatch, kmer_hash32

I32 = jnp.int32
U32 = jnp.uint32


class MinimizerBatch(NamedTuple):
    """Per-read minimizers; arrays shaped (R, n_windows) with `take` masking.

    Slot j corresponds to window j; a slot is real iff take[j] (window j is
    the first window won by that position).
    """

    pos: jax.Array     # int32  — k-mer position of the selected minimizer
    hi: jax.Array      # uint32 — canonical k-mer hi word at pos
    lo: jax.Array      # uint32
    strand: jax.Array  # uint8  — orientation that won canonicalization
    take: jax.Array    # bool


@functools.partial(jax.jit, static_argnames=("w", "k"))
def select_minimizers(kb: KmerBatch, w: int, length: jax.Array, k: int) -> MinimizerBatch:
    """length: int32 (R,) true read lengths — windows extending past the read
    end are suppressed entirely (oracle iterates j in [0, len-k+1-w])."""
    R, m = kb.hi.shape
    n_win = m - w + 1
    if n_win <= 0:
        raise ValueError(f"read capacity yields {m} k-mers < window {w}")

    h = kmer_hash32(kb.hi, kb.lo)
    inv = ~kb.valid  # invalid k-mers must lose every comparison

    # window-min over w shifted views; strict < keeps the leftmost winner
    best_h = jax.lax.dynamic_slice_in_dim(h, 0, n_win, axis=1)
    best_inv = jax.lax.dynamic_slice_in_dim(inv, 0, n_win, axis=1)
    best_pos = jnp.zeros((R, n_win), I32)
    for t in range(1, w):
        ch = jax.lax.dynamic_slice_in_dim(h, t, n_win, axis=1)
        cinv = jax.lax.dynamic_slice_in_dim(inv, t, n_win, axis=1)
        # candidate wins iff (inv, h) < (best_inv, best_h) lexicographically
        wins = (~cinv & best_inv) | ((cinv == best_inv) & (ch < best_h))
        best_h = jnp.where(wins, ch, best_h)
        best_inv = jnp.where(wins, cinv, best_inv)
        best_pos = jnp.where(wins, t, best_pos)
    pos = best_pos + jnp.arange(n_win, dtype=I32)[None, :]

    # dedupe consecutive windows that chose the same position
    first = jnp.ones((R, 1), bool)
    new_sel = jnp.concatenate([first, pos[:, 1:] != pos[:, :-1]], axis=1)
    win = jnp.arange(n_win, dtype=I32)[None, :]
    window_real = win <= (length[:, None] - (k + w - 1))
    take = new_sel & ~best_inv & window_real

    hi = jnp.take_along_axis(kb.hi, pos, axis=1)
    lo = jnp.take_along_axis(kb.lo, pos, axis=1)
    strand = jnp.take_along_axis(kb.strand, pos, axis=1)
    return MinimizerBatch(pos=pos, hi=hi, lo=lo, strand=strand, take=take)

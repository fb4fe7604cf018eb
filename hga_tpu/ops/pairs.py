"""L2 device ops — candidate overlap pairs from shared minimizers.

Device replacement for the reference's hash-map seed index + bucket
cross-product pair generation (SURVEY.md C6/C7).  The index IS a sorted
tensor: entries (minimizer, read, pos, strand) sorted by minimizer value form
the hit lists; pair generation is a bounded sorted self-join — entry i pairs
with entries i+1..i+max_freq-1 of the same run (static unroll, so the shape
stays data-independent); aggregation per (a, b, orientation) is another sort
+ segment-reduce.

Frequency filtering (drop minimizers occurring > max_freq times, the
repeat-masking heuristic) bounds both noise and the static pair capacity.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from hga_tpu.ops.count import SENTINEL, _run_boundaries

I32 = jnp.int32
U32 = jnp.uint32


class CandidatePairs(NamedTuple):
    """Compact candidate pair list (capacity-padded).

    a, b:    int32 — read ids, a < b
    rel:     int32 — 0 same strand, 1 b is reverse-complemented
    diag:    int32 — representative diagonal pos_a - pos_b' (median over
             shared seeds; pos_b' is b's seed position in orientation rel)
    shared:  int32 — number of shared (frequency-filtered) minimizers
    n:       int32 scalar — real pairs (<= capacity)
    overflow:int32 scalar — aggregated pairs dropped for capacity
    """

    a: jax.Array
    b: jax.Array
    rel: jax.Array
    diag: jax.Array
    shared: jax.Array
    n: jax.Array
    overflow: jax.Array


@functools.partial(
    jax.jit,
    static_argnames=("k", "max_freq", "min_shared", "pair_cap", "mode"),
)
def candidate_pairs(
    hi: jax.Array,       # uint32 (N,) minimizer k-mer hi (sentinel = unused)
    lo: jax.Array,       # uint32 (N,)
    read: jax.Array,     # int32 (N,) read id per entry
    pos: jax.Array,      # int32 (N,) k-mer position in the read
    strand: jax.Array,   # int32 (N,) orientation that won canonicalization
    read_len: jax.Array, # int32 (R,) true length per read id
    category: jax.Array, # int32 (R,) source category per read id
    k: int,
    max_freq: int,
    min_shared: int,
    pair_cap: int,
    mode: str = "all",   # "all": any pair; "cross": category[a] != category[b]
) -> CandidatePairs:
    N = hi.shape[0]

    # ---- sorted index: order entries by minimizer value ----
    hi_s, lo_s, read_s, pos_s, str_s = jax.lax.sort(
        (hi, lo, read, pos, strand), num_keys=2)
    is_new, run_id = _run_boundaries(hi_s, lo_s)
    freq = jnp.zeros((N,), I32).at[run_id].add(1)
    entry_ok = (freq[run_id] <= max_freq) & ~(
        (hi_s == SENTINEL) & (lo_s == SENTINEL))

    # ---- bounded self-join: i pairs with i+o within the same run ----
    a_list, b_list, rel_list, diag_list, ok_list = [], [], [], [], []
    for o in range(1, max_freq):
        same_run = run_id[o:] == run_id[:-o]
        pad = jnp.zeros((o,), bool)
        same_run = jnp.concatenate([same_run, pad])
        j_read = jnp.roll(read_s, -o)
        j_pos = jnp.roll(pos_s, -o)
        j_str = jnp.roll(str_s, -o)
        j_ok = jnp.roll(entry_ok, -o)
        ok = same_run & entry_ok & j_ok & (read_s != j_read)
        if mode == "cross":
            ok &= category[read_s] != category[j_read]
        # canonical order a < b
        swap = read_s > j_read
        pa = jnp.where(swap, j_pos, pos_s)
        pb = jnp.where(swap, pos_s, j_pos)
        sa = jnp.where(swap, j_str, str_s)
        sb = jnp.where(swap, str_s, j_str)
        ra = jnp.minimum(read_s, j_read)
        rb = jnp.maximum(read_s, j_read)
        rel = (sa != sb).astype(I32)
        lb = read_len[rb]
        pb_adj = jnp.where(rel == 1, lb - k - pb, pb)
        diag = pa - pb_adj
        a_list.append(jnp.where(ok, ra, jnp.int32(0x7FFFFFFF)))
        b_list.append(jnp.where(ok, rb, jnp.int32(0x7FFFFFFF)))
        rel_list.append(rel)
        diag_list.append(diag)
        ok_list.append(ok)

    A = jnp.concatenate(a_list)
    B = jnp.concatenate(b_list)
    REL = jnp.concatenate(rel_list)
    DIAG = jnp.concatenate(diag_list)
    OK = jnp.concatenate(ok_list)

    # ---- aggregate per (a, b, rel): shared-seed count + median diagonal ----
    M = A.shape[0]
    A_s, B_s, REL_s, DIAG_s, OK_s = jax.lax.sort(
        (A, B, REL, DIAG, OK.astype(I32)), num_keys=4)
    first = jnp.ones((1,), bool)
    diff = (A_s[1:] != A_s[:-1]) | (B_s[1:] != B_s[:-1]) | (REL_s[1:] != REL_s[:-1])
    p_new = jnp.concatenate([first, diff])
    p_run = jnp.cumsum(p_new.astype(I32)) - 1
    cnt = jnp.zeros((M,), I32).at[p_run].add(OK_s)
    idx = jnp.arange(M, dtype=I32)
    run_start = jnp.full((M,), M, I32).at[p_run].min(idx)
    # median diagonal of the run (runs are diag-sorted within (a,b,rel))
    med_idx = jnp.clip(run_start + cnt // 2, 0, M - 1)
    keep = (
        p_new
        & (cnt[p_run] >= min_shared)
        & (A_s != jnp.int32(0x7FFFFFFF))
    )
    med_diag = DIAG_s[med_idx[p_run]]

    # ---- compact kept pair-heads to the front ----
    key = jnp.where(keep, idx, jnp.int32(M))
    _, c_a, c_b, c_rel, c_diag, c_cnt = jax.lax.sort(
        (key, A_s, B_s, REL_s, med_diag, cnt[p_run]), num_keys=1)
    n_kept = jnp.sum(keep.astype(I32))
    n = jnp.minimum(n_kept, pair_cap)
    sl = lambda x: jax.lax.slice_in_dim(x, 0, pair_cap)
    pad_mask = jnp.arange(pair_cap, dtype=I32) >= n
    return CandidatePairs(
        a=jnp.where(pad_mask, -1, sl(c_a)),
        b=jnp.where(pad_mask, -1, sl(c_b)),
        rel=jnp.where(pad_mask, 0, sl(c_rel)),
        diag=jnp.where(pad_mask, 0, sl(c_diag)),
        shared=jnp.where(pad_mask, 0, sl(c_cnt)),
        n=n,
        overflow=n_kept - n,
    )

"""L1 device ops — k-mer counting as sort + segment-reduce.

Device replacement for the reference's C++ hash-table k-mer counters
(SURVEY.md C4, BASELINE.json: "C++ hash-table k-mer counters" become
"device-resident sorted/bucketed k-mer tensors").  A hash table is a
pointer-chasing, cache-miss-bound structure; on device the same multiset-count
is a bitonic `lax.sort` over (hi, lo) pairs followed by run-boundary
detection and a scatter-add segment sum — all static shapes, all vector ops.

Every function uses a shared sentinel (0xffffffff, 0xffffffff) for
empty/invalid slots; real canonical k-mers (k <= 32) can never equal it
because the canonical value is min(fwd, rc) and a 2k-bit value with all bits
set has an all-A complement.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

U32 = jnp.uint32
I32 = jnp.int32
SENTINEL = jnp.uint32(0xFFFFFFFF)


class CountedKmers(NamedTuple):
    """Compact sorted multiset: first n entries are distinct k-mers + counts.

    hi, lo: uint32[C] sorted ascending (sentinel-padded tail)
    count:  int32[C]  count per distinct k-mer (0 in the padded tail)
    n:      int32 scalar — number of real distinct k-mers
    """

    hi: jax.Array
    lo: jax.Array
    count: jax.Array
    n: jax.Array


def _run_boundaries(hi_s: jax.Array, lo_s: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """is_new[i] marks the first element of each equal-(hi,lo) run; run_id is
    the 0-based run index per element."""
    n = hi_s.shape[0]
    first = jnp.ones((1,), bool)
    diff = (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])
    is_new = jnp.concatenate([first, diff])
    run_id = jnp.cumsum(is_new.astype(I32)) - 1
    return is_new, run_id


@jax.jit
def sort_and_count(hi: jax.Array, lo: jax.Array, weight: jax.Array) -> CountedKmers:
    """Weighted multiset count of (hi, lo) pairs; sentinel pairs are ignored.

    hi/lo/weight are flat arrays of equal (static) length.  Returns a compact
    CountedKmers of the same capacity.  Oracle: utils/oracle.count_kmers.
    """
    hi = hi.ravel()
    lo = lo.ravel()
    weight = weight.ravel().astype(I32)
    N = hi.shape[0]

    hi_s, lo_s, w_s = jax.lax.sort((hi, lo, weight), num_keys=2)
    is_new, run_id = _run_boundaries(hi_s, lo_s)
    cnt_per_run = jnp.zeros((N,), I32).at[run_id].add(w_s)

    real = ~((hi_s == SENTINEL) & (lo_s == SENTINEL))
    take = is_new & real
    # compact the run heads to the front, preserving sorted order
    compact_key = jnp.where(take, run_id, jnp.int32(N))
    _, c_hi, c_lo, c_cnt = jax.lax.sort(
        (compact_key, hi_s, lo_s, jnp.where(take, cnt_per_run[run_id], 0)),
        num_keys=1,
    )
    n = jnp.sum(take.astype(I32))
    # sentinel-out the tail so downstream merges can ignore it
    idx = jnp.arange(N, dtype=I32)
    pad = idx >= n
    c_hi = jnp.where(pad, SENTINEL, c_hi)
    c_lo = jnp.where(pad, SENTINEL, c_lo)
    c_cnt = jnp.where(pad, 0, c_cnt)
    return CountedKmers(hi=c_hi, lo=c_lo, count=c_cnt, n=n)


def count_kmer_batch(kb, max_out: int | None = None) -> CountedKmers:
    """Count a KmerBatch (from ops.kmer.extract_kmers)."""
    hi = jnp.where(kb.valid, kb.hi, SENTINEL)
    lo = jnp.where(kb.valid, kb.lo, SENTINEL)
    w = kb.valid.astype(I32)
    return sort_and_count(hi, lo, w)


@jax.jit
def merge_counted(a: CountedKmers, b: CountedKmers) -> CountedKmers:
    """Merge two compact counted sets (counts of equal k-mers add).

    Output capacity = |a| + |b| (static).  Used for batch-wise accumulation
    and for cross-shard merges after an all_gather.
    """
    hi = jnp.concatenate([a.hi, b.hi])
    lo = jnp.concatenate([a.lo, b.lo])
    w = jnp.concatenate([a.count, b.count])
    return sort_and_count(hi, lo, w)


@functools.partial(jax.jit, static_argnames=("max_count",))
def spectrum_histogram(ck: CountedKmers, max_count: int) -> jax.Array:
    """hist[c] = #distinct k-mers with count c (clamped to max_count)."""
    c = jnp.clip(ck.count, 0, max_count)
    w = (jnp.arange(ck.hi.shape[0], dtype=I32) < ck.n).astype(jnp.int64
         if jax.config.jax_enable_x64 else I32)
    return jnp.zeros((max_count + 1,), I32).at[c].add(w)


@jax.jit
def filter_solid(ck: CountedKmers, threshold: jax.Array) -> CountedKmers:
    """Keep k-mers with count >= threshold, compacted to the front."""
    N = ck.hi.shape[0]
    idx = jnp.arange(N, dtype=I32)
    solid = (ck.count >= threshold) & (idx < ck.n)
    key = jnp.where(solid, idx, jnp.int32(N))
    _, hi, lo, cnt = jax.lax.sort((key, ck.hi, ck.lo, ck.count), num_keys=1)
    n = jnp.sum(solid.astype(I32))
    pad = idx >= n
    return CountedKmers(
        hi=jnp.where(pad, SENTINEL, hi),
        lo=jnp.where(pad, SENTINEL, lo),
        count=jnp.where(pad, 0, cnt),
        n=n,
    )


@jax.jit
def member_sorted(set_hi: jax.Array, set_lo: jax.Array,
                  q_hi: jax.Array, q_lo: jax.Array) -> jax.Array:
    """Exact membership of each query (hi, lo) in a sentinel-padded set.

    Membership is a sorted merge (no 2-key binary search needed): tag set
    elements 0 and queries 1, sort by (hi, lo), propagate a has-set flag
    within each equal run, scatter back through the sort permutation.
    Sentinel queries return False (the set must not contain the sentinel,
    which CountedKmers guarantees for real entries).
    """
    S = set_hi.shape[0]
    qshape = q_hi.shape
    q_hi = q_hi.ravel()
    q_lo = q_lo.ravel()
    Q = q_hi.shape[0]
    hi = jnp.concatenate([set_hi, q_hi])
    lo = jnp.concatenate([set_lo, q_lo])
    tag = jnp.concatenate([jnp.zeros((S,), I32), jnp.ones((Q,), I32)])
    orig = jnp.arange(S + Q, dtype=I32)
    hi_s, lo_s, tag_s, orig_s = jax.lax.sort((hi, lo, tag, orig), num_keys=3)
    is_new, run_id = _run_boundaries(hi_s, lo_s)
    has_set = jnp.zeros((S + Q,), I32).at[run_id].max(1 - tag_s)
    member_sorted_pos = (has_set[run_id] > 0) & (tag_s == 1)
    # exclude the sentinel run
    member_sorted_pos &= ~((hi_s == SENTINEL) & (lo_s == SENTINEL))
    out = jnp.zeros((S + Q,), bool).at[orig_s].set(member_sorted_pos)
    return out[S:].reshape(qshape)

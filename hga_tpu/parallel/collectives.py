"""L6 — cross-shard merge collectives (the reference has no equivalent).

The reference merges nothing: one process owns the single hash table and the
single overlap graph (SURVEY.md §3.2).  Here the global k-mer spectrum and
edge lists are distributed state, merged with XLA collectives inside
`shard_map`, which XLA lowers to NCCL collectives over NVLink on a
multi-GPU host:

* `count_kmers_sharded` — each shard counts its reads locally (sort +
  segment-sum, ops/count.py), then the compacted (kmer, count) lists are
  all_gather'ed and re-counted; every shard holds the exact global multiset.
* `spectrum_hist_sharded` — same, returning just the psum-able histogram.
* `route_by_bucket` — ragged all_to_all k-mer routing by hash bucket, the
  Ulysses-style shuffle for owner-shard counting at scales where an
  all_gather replica of the table would not fit (SURVEY.md §3.1).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from hga_tpu.parallel.compat import shard_map

from hga_tpu.ops import count as C
from hga_tpu.ops import kmer as K

I32 = jnp.int32


def _local_count(packed, bad, length, k: int, cap: int) -> C.CountedKmers:
    kb = K.extract_kmers(packed, bad, length, k)
    ck = C.count_kmer_batch(kb)
    # compact to a fixed per-shard capacity for the gather
    n = packed.shape[0] * (packed.shape[1] * 16 - k + 1)
    if cap >= n:
        pad = cap - n
        return C.CountedKmers(
            hi=jnp.pad(ck.hi, (0, pad), constant_values=C.SENTINEL),
            lo=jnp.pad(ck.lo, (0, pad), constant_values=C.SENTINEL),
            count=jnp.pad(ck.count, (0, pad)),
            n=ck.n,
        )
    return C.CountedKmers(hi=ck.hi[:cap], lo=ck.lo[:cap],
                          count=ck.count[:cap], n=jnp.minimum(ck.n, cap))


def count_kmers_sharded(
    mesh: Mesh,
    packed: jax.Array,   # uint32 (R, W), R divisible by mesh 'data' size
    bad: jax.Array,
    length: jax.Array,
    k: int,
    shard_cap: int,
) -> C.CountedKmers:
    """Exact global k-mer counts, replicated on every shard.

    Each shard's distinct-k-mer list must fit in `shard_cap`; overflow is
    detectable via result-of-`_local_count` n == shard_cap (callers assert).
    """

    def f(p, b, l):
        local = _local_count(p, b, l, k, shard_cap)
        g_hi = jax.lax.all_gather(local.hi, "data", tiled=True)
        g_lo = jax.lax.all_gather(local.lo, "data", tiled=True)
        g_cnt = jax.lax.all_gather(local.count, "data", tiled=True)
        return C.sort_and_count(g_hi, g_lo, g_cnt)

    fn = shard_map(
        f, mesh=mesh,
        in_specs=(P("data"), P("data"), P("data")),
        out_specs=C.CountedKmers(hi=P(), lo=P(), count=P(), n=P()),
        check_rep=False,
    )
    return fn(packed, bad, length)


def spectrum_hist_sharded(
    mesh: Mesh, packed, bad, length, k: int, shard_cap: int, max_count: int
) -> jax.Array:
    """Global spectrum histogram via all_gather merge (exact)."""
    ck = count_kmers_sharded(mesh, packed, bad, length, k, shard_cap)
    return C.spectrum_histogram(ck, max_count)


def count_kmers_bucketed(
    mesh: Mesh,
    packed: jax.Array,   # uint32 (R, W) sharded on 'data'
    bad: jax.Array,
    length: jax.Array,
    k: int,
    bucket_cap: int,
) -> Tuple[C.CountedKmers, jax.Array]:
    """Owner-shard k-mer counting: each chip ends up with the counts of ITS
    hash bucket only (disjoint k-mer spaces, sharded outputs).

    The scalable production path (SURVEY.md §3.1 TP-analog row): one ragged
    all_to_all routes every k-mer to its owner, each shard sorts/counts only
    total/n_shards k-mers — unlike count_kmers_sharded, no replicated global
    re-sort.  Returns (counted, overflow) with counted.{hi,lo,count} sharded
    over 'data' (capacity n_shards * bucket_cap) and counted.n holding the
    per-shard distinct counts as an (n_shards,) vector.
    """
    n_shards = mesh.devices.size

    def f(p, b, l):
        kb = K.extract_kmers(p, b, l, k)
        h = jnp.where(kb.valid, kb.hi, C.SENTINEL).ravel()
        lov = jnp.where(kb.valid, kb.lo, C.SENTINEL).ravel()
        hsh = K.kmer_hash32(h, lov)
        valid = ~((h == C.SENTINEL) & (lov == C.SENTINEL))
        dst = (hsh % jnp.uint32(n_shards)).astype(I32)
        dst = jnp.where(valid, dst, n_shards)
        dst_s, h_s, lo_s = jax.lax.sort((dst, h, lov), num_keys=1)
        N = dst_s.shape[0]
        idx = jnp.arange(N, dtype=I32)
        first_of_dst = jnp.full((n_shards + 1,), N, I32).at[dst_s].min(
            idx, mode="drop")
        rank = idx - first_of_dst[dst_s]
        lanes_hi = jnp.full((n_shards, bucket_cap), C.SENTINEL)
        lanes_lo = jnp.full((n_shards, bucket_cap), C.SENTINEL)
        ok = (rank < bucket_cap) & (dst_s < n_shards)
        pos = jnp.where(ok, dst_s * bucket_cap + rank, n_shards * bucket_cap)
        lanes_hi = lanes_hi.ravel().at[pos].set(h_s, mode="drop").reshape(
            n_shards, bucket_cap)
        lanes_lo = lanes_lo.ravel().at[pos].set(lo_s, mode="drop").reshape(
            n_shards, bucket_cap)
        overflow = jnp.sum(((rank >= bucket_cap)
                            & (dst_s < n_shards)).astype(I32))
        got_hi = jax.lax.all_to_all(lanes_hi, "data", split_axis=0,
                                    concat_axis=0, tiled=False).reshape(-1)
        got_lo = jax.lax.all_to_all(lanes_lo, "data", split_axis=0,
                                    concat_axis=0, tiled=False).reshape(-1)
        w = (~((got_hi == C.SENTINEL) & (got_lo == C.SENTINEL))).astype(I32)
        ck = C.sort_and_count(got_hi, got_lo, w)
        return (C.CountedKmers(hi=ck.hi, lo=ck.lo, count=ck.count,
                               n=ck.n[None]),
                jax.lax.psum(overflow, "data"))

    fn = shard_map(
        f, mesh=mesh,
        in_specs=(P("data"), P("data"), P("data")),
        out_specs=(C.CountedKmers(hi=P("data"), lo=P("data"),
                                  count=P("data"), n=P("data")), P()),
        check_rep=False,
    )
    return fn(packed, bad, length)


def spectrum_hist_bucketed(
    mesh: Mesh,
    packed: jax.Array,   # uint32 (R, W) sharded on 'data'
    bad: jax.Array,
    length: jax.Array,
    k: int,
    bucket_cap: int,
    max_count: int,
) -> Tuple[jax.Array, jax.Array]:
    """Exact global spectrum histogram via OWNER-SHARD counting.

    Unlike count_kmers_sharded (all_gather + full re-sort replicated on
    every chip — per-shard work grows with the TOTAL k-mer set), this is
    the scalable Ulysses path (SURVEY.md §3.1/§3.2): k-mers are routed to
    their hash-owner shard with one ragged all_to_all, each shard
    sorts/counts ONLY its own bucket (disjoint k-mer spaces), and the
    global histogram is a psum of local histograms.  Per-shard work is
    total/n_shards + the shuffle — the >=80%-at-2-hosts scaling design.

    Returns (hist, overflow): callers size bucket_cap with slack and check
    overflow == 0 (SURVEY.md §8.3-4).
    """
    n_shards = mesh.devices.size

    def f(p, b, l):
        kb = K.extract_kmers(p, b, l, k)
        h = jnp.where(kb.valid, kb.hi, C.SENTINEL).ravel()
        lov = jnp.where(kb.valid, kb.lo, C.SENTINEL).ravel()
        hsh = K.kmer_hash32(h, lov)
        valid = ~((h == C.SENTINEL) & (lov == C.SENTINEL))
        dst = (hsh % jnp.uint32(n_shards)).astype(I32)
        dst = jnp.where(valid, dst, n_shards)
        dst_s, h_s, lo_s = jax.lax.sort((dst, h, lov), num_keys=1)
        N = dst_s.shape[0]
        idx = jnp.arange(N, dtype=I32)
        first_of_dst = jnp.full((n_shards + 1,), N, I32).at[dst_s].min(
            idx, mode="drop")
        rank = idx - first_of_dst[dst_s]
        lanes_hi = jnp.full((n_shards, bucket_cap), C.SENTINEL)
        lanes_lo = jnp.full((n_shards, bucket_cap), C.SENTINEL)
        ok = (rank < bucket_cap) & (dst_s < n_shards)
        pos = jnp.where(ok, dst_s * bucket_cap + rank, n_shards * bucket_cap)
        lanes_hi = lanes_hi.ravel().at[pos].set(h_s, mode="drop").reshape(
            n_shards, bucket_cap)
        lanes_lo = lanes_lo.ravel().at[pos].set(lo_s, mode="drop").reshape(
            n_shards, bucket_cap)
        overflow = jnp.sum(((rank >= bucket_cap)
                            & (dst_s < n_shards)).astype(I32))
        got_hi = jax.lax.all_to_all(lanes_hi, "data", split_axis=0,
                                    concat_axis=0, tiled=False).reshape(-1)
        got_lo = jax.lax.all_to_all(lanes_lo, "data", split_axis=0,
                                    concat_axis=0, tiled=False).reshape(-1)
        # local count of OWNED k-mers only — shards hold disjoint sets
        w = (~((got_hi == C.SENTINEL) & (got_lo == C.SENTINEL))).astype(I32)
        ck = C.sort_and_count(got_hi, got_lo, w)
        hist = C.spectrum_histogram(ck, max_count)
        return jax.lax.psum(hist, "data"), jax.lax.psum(overflow, "data")

    fn = shard_map(
        f, mesh=mesh,
        in_specs=(P("data"), P("data"), P("data")),
        out_specs=(P(), P()),
        check_rep=False,
    )
    return fn(packed, bad, length)


def route_by_bucket(
    mesh: Mesh,
    hi: jax.Array,       # uint32 (R*m,) flat local k-mers (sentinel-padded)
    lo: jax.Array,
    bucket_cap: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Ulysses-style all_to_all: send each k-mer to its owner shard.

    Owner = top bits of the k-mer hash mod n_shards.  Each (src, dst) lane
    has fixed capacity `bucket_cap`; overflowing k-mers are dropped and
    counted in the returned overflow scalar (callers size bucket_cap with
    slack and assert overflow == 0, SURVEY.md §8.3 item 4).

    Returns (hi, lo, overflow) where hi/lo are the k-mers owned by this
    shard, capacity n_shards * bucket_cap, sentinel-padded.
    """
    n_shards = mesh.devices.size

    def f(h, lol):
        h = h.ravel()
        lov = lol.ravel()
        hsh = K.kmer_hash32(h, lov)
        valid = ~((h == C.SENTINEL) & (lov == C.SENTINEL))
        dst = (hsh % jnp.uint32(n_shards)).astype(I32)
        dst = jnp.where(valid, dst, n_shards)  # invalid sorts last
        # stable sort by destination, then slot into fixed-capacity lanes
        dst_s, h_s, lo_s = jax.lax.sort((dst, h, lov), num_keys=1)
        N = dst_s.shape[0]
        idx = jnp.arange(N, dtype=I32)
        first_of_dst = jnp.full((n_shards + 1,), N, I32).at[dst_s].min(
            idx, mode="drop")
        rank = idx - first_of_dst[dst_s]          # rank within destination
        lanes_hi = jnp.full((n_shards, bucket_cap), C.SENTINEL)
        lanes_lo = jnp.full((n_shards, bucket_cap), C.SENTINEL)
        ok = (rank < bucket_cap) & (dst_s < n_shards)
        lane_pos = jnp.where(ok, dst_s * bucket_cap + rank, n_shards * bucket_cap)
        lanes_hi = lanes_hi.ravel().at[lane_pos].set(h_s, mode="drop").reshape(
            n_shards, bucket_cap)
        lanes_lo = lanes_lo.ravel().at[lane_pos].set(lo_s, mode="drop").reshape(
            n_shards, bucket_cap)
        overflow = jnp.sum(((rank >= bucket_cap) & (dst_s < n_shards)).astype(I32))
        got_hi = jax.lax.all_to_all(lanes_hi, "data", split_axis=0,
                                    concat_axis=0, tiled=False)
        got_lo = jax.lax.all_to_all(lanes_lo, "data", split_axis=0,
                                    concat_axis=0, tiled=False)
        return (got_hi.reshape(-1), got_lo.reshape(-1),
                jax.lax.psum(overflow, "data"))

    fn = shard_map(
        f, mesh=mesh,
        in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data"), P()),
        check_rep=False,
    )
    return fn(hi, lo)

"""Stage 1 (judged config 1) — k-mer counting + spectrum histogram.

Pipeline: packed read batches -> device k-mer extraction (ops.kmer) ->
device sort/segment-sum counting (ops.count) -> cross-batch merge ->
histogram -> valley threshold -> solid k-mer set.

The reference implements this as a streaming C++ hash-table pass with a
Python histogram plot (SURVEY.md C4/C5, call stack §4.1).  Here each batch is
counted on device with static shapes, batch results are compacted and merged
with one final device sort, and the threshold valley is picked on host from
the (tiny) histogram.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hga_tpu.config import AssemblerConfig
from hga_tpu.io.encode import PackedReads
from hga_tpu.ops import count as C
from hga_tpu.ops import kmer as K
from hga_tpu.utils.oracle import solid_threshold_from_hist

log = logging.getLogger(__name__)


@dataclasses.dataclass
class SpectrumResult:
    """Host-side result of the counting stage.

    hi/lo/count may hold the full distinct set (mesh/legacy paths) or only
    the SOLID k-mers (count >= threshold; the fast single-device path —
    nothing downstream consumes sub-threshold k-mers, so none is read
    back).  `distinct` always carries the true
    distinct total.
    """

    hi: np.ndarray        # uint32[n] canonical k-mers (sorted)
    lo: np.ndarray        # uint32[n]
    count: np.ndarray     # int32[n]
    hist: np.ndarray      # int64[max_count+1]
    threshold: int        # chosen solid threshold
    k: int
    distinct: int = -1    # total distinct k-mers (-1: same as hi.size)

    @property
    def n_distinct(self) -> int:
        return int(self.distinct) if self.distinct >= 0 else int(self.hi.shape[0])

    def solid_set(self) -> Tuple[np.ndarray, np.ndarray]:
        m = self.count >= self.threshold
        return self.hi[m], self.lo[m]

    def save(self, path: str) -> None:
        np.savez_compressed(path, hi=self.hi, lo=self.lo, count=self.count,
                            hist=self.hist, threshold=np.int64(self.threshold),
                            k=np.int64(self.k),
                            distinct=np.int64(self.n_distinct))

    @staticmethod
    def load(path: str) -> "SpectrumResult":
        z = np.load(path)
        return SpectrumResult(hi=z["hi"], lo=z["lo"], count=z["count"],
                              hist=z["hist"], threshold=int(z["threshold"]),
                              k=int(z["k"]),
                              distinct=int(z["distinct"])
                              if "distinct" in z.files else -1)


def _count_batch_fn(k: int):
    @jax.jit
    def f(packed, bad, length):
        kb = K.extract_kmers(packed, bad, length, k)
        return C.count_kmer_batch(kb)

    return f


def _extract_batch_fn(k: int):
    """Device k-mer extraction only (no per-batch sort, no readback)."""

    @jax.jit
    def f(packed, bad, length):
        kb = K.extract_kmers(packed, bad, length, k)
        hi = jnp.where(kb.valid, kb.hi, C.SENTINEL)
        lo = jnp.where(kb.valid, kb.lo, C.SENTINEL)
        return hi.ravel(), lo.ravel()

    return f


# One-shot global sort cap (k-mer slots): inputs up to this sort in one
# padded device sort; larger inputs go through the two-level hierarchical
# merge (super-chunk sorts -> compacted distinct slices -> final weighted
# merge), which bounds peak HBM at ~SUPER_SLOTS regardless of input size
# (SURVEY.md §8.3-4; ROADMAP "hierarchical merge" scale item).
MAX_GLOBAL_SORT = 1 << 26           # 67M slots
SUPER_SLOTS = 1 << 26               # hierarchical super-chunk size
SLICE_QUANTUM = 1 << 24             # compacted-slice size bucket (16M)


def _count_reads_device(idx, pr: PackedReads, cfg: AssemblerConfig,
                        B: int) -> SpectrumResult:
    """Single-device fast path: minimal host<->device traffic.

    A per-batch compact-and-fetch design moves ~6x the necessary bytes:
    every batch's distinct set comes to host and goes BACK to device for
    the final merge.  Here extraction streams on device, ONE global sort
    counts everything, and the only readbacks are the histogram and the
    SOLID set — the only k-mers any downstream stage consumes
    (seeding/correction; SURVEY.md C5/C12).
    """
    ex = _extract_batch_fn(cfg.k)

    def batches():
        for s in range(0, len(idx), B):
            sel = idx[s : s + B]
            packed = pr.packed[sel]
            bad = pr.bad[sel]
            length = pr.length[sel]
            if packed.shape[0] < B:
                pad = B - packed.shape[0]
                packed = np.pad(packed, ((0, pad), (0, 0)))
                bad = np.pad(bad, ((0, pad), (0, 0)))
                length = np.pad(length, (0, pad))
            yield (jnp.asarray(packed), jnp.asarray(bad), jnp.asarray(length))

    from hga_tpu.parallel.stream import pipelined_map

    def _sorted_chunk(parts_hi, parts_lo, parts_w):
        """Concat parts (padding to a power-of-two capacity so the sort's
        compile is reused across dataset sizes via the persistent
        compilation cache) and sort-count them."""
        slots = sum(int(p.shape[0]) for p in parts_hi)
        cap = 1 << max(22, (slots - 1).bit_length())
        if cap > slots:
            pad = jnp.full((cap - slots,), C.SENTINEL, jnp.uint32)
            parts_hi = parts_hi + [pad]
            parts_lo = parts_lo + [pad]
            parts_w = parts_w + [jnp.zeros((cap - slots,), jnp.int32)]
        return C.sort_and_count(jnp.concatenate(parts_hi),
                                jnp.concatenate(parts_lo),
                                jnp.concatenate(parts_w))

    parts_hi: List[jax.Array] = []
    parts_lo: List[jax.Array] = []
    slices: List[Tuple[jax.Array, jax.Array, jax.Array]] = []
    acc_slots = 0

    def flush():
        """Super-chunk: sort-count the accumulated parts, keep only the
        compacted distinct slice (rounded up to SLICE_QUANTUM so the slice
        shapes — and their compiles — repeat) on device."""
        nonlocal parts_hi, parts_lo, acc_slots
        if not parts_hi:
            return
        w = [jnp.ones((int(p.shape[0]),), jnp.int32) for p in parts_hi]
        ck = _sorted_chunk(parts_hi, parts_lo, w)
        n = int(ck.n)
        m = min(int(ck.hi.shape[0]),
                ((max(n, 1) + SLICE_QUANTUM - 1) // SLICE_QUANTUM)
                * SLICE_QUANTUM)
        slices.append((ck.hi[:m], ck.lo[:m], ck.count[:m]))
        parts_hi, parts_lo, acc_slots = [], [], 0

    hierarchical = (len(idx) * (pr.pad_len - cfg.k + 1)) > MAX_GLOBAL_SORT
    for hi_d, lo_d in pipelined_map(ex, batches()):
        parts_hi.append(hi_d)
        parts_lo.append(lo_d)
        acc_slots += int(hi_d.shape[0])
        if hierarchical and acc_slots >= SUPER_SLOTS:
            flush()

    if not parts_hi and not slices:
        hist = np.zeros(cfg.max_count + 1, np.int64)
        thr = cfg.solid_threshold or solid_threshold_from_hist(hist)
        z = np.zeros(0, np.uint32)
        return SpectrumResult(hi=z, lo=z.copy(), count=np.zeros(0, np.int32),
                              hist=hist, threshold=int(thr), k=cfg.k,
                              distinct=0)

    if not slices:
        # single-level: one global sort over the raw extracted k-mers
        w = [jnp.ones((int(p.shape[0]),), jnp.int32) for p in parts_hi]
        merged = _sorted_chunk(parts_hi, parts_lo, w)
    else:
        # two-level: weighted merge of the compacted super-chunk slices
        flush()
        merged = _sorted_chunk([s[0] for s in slices],
                               [s[1] for s in slices],
                               [s[2] for s in slices])
    del parts_hi, parts_lo, slices
    hist = np.asarray(C.spectrum_histogram(merged, cfg.max_count))
    distinct = int(merged.n)
    thr = cfg.solid_threshold or solid_threshold_from_hist(hist)
    solid = C.filter_solid(merged, jnp.int32(thr))
    ns = int(solid.n)
    hi = np.asarray(solid.hi[:ns])
    lo = np.asarray(solid.lo[:ns])
    cnt = np.asarray(solid.count[:ns])
    log.info("spectrum: %d distinct %d-mers (%d solid), threshold=%d",
             distinct, cfg.k, ns, thr)
    return SpectrumResult(hi=hi, lo=lo, count=cnt, hist=hist,
                          threshold=int(thr), k=cfg.k, distinct=distinct)


def count_reads(
    pr: PackedReads,
    cfg: AssemblerConfig,
    category: Optional[int] = None,
    mesh=None,
) -> SpectrumResult:
    """Count canonical k-mers of (a category of) a read set; pick threshold.

    Batches are fixed-shape so the per-batch jit compiles once; batch results
    are compacted on host and merged with a single final device sort
    (SURVEY.md §4.1 build path).

    With a >1-device mesh, every batch is sharded over the 'data' axis and
    counted with the shard_map collective path (local sort-count per chip +
    all_gather merge, parallel/collectives.py) — the production pipeline's
    distributed counting (SURVEY.md L6/§3.2).
    """
    idx = np.arange(pr.n_reads)
    if category is not None:
        idx = idx[pr.category == category]
    B = cfg.batch_reads
    ndev = int(mesh.devices.size) if mesh is not None else 1
    if ndev <= 1:
        return _count_reads_device(idx, pr, cfg, B)

    # multi-device mesh path (single-device returned above)
    from jax.sharding import PartitionSpec as SP, NamedSharding

    from hga_tpu.parallel import collectives as PC

    B = ((B + ndev - 1) // ndev) * ndev
    kmers_per_read = pr.pad_len - cfg.k + 1
    # 2x-uniform capacity; the worst case (every k-mer hashing to one
    # owner) is kept as the one-shot overflow retry (count -> allocate
    # -> fill, SURVEY.md §8.3-4)
    bucket_cap = 2 * (B // ndev) * kmers_per_read // ndev + 1024
    worst_cap = (B // ndev) * kmers_per_read
    dp = NamedSharding(mesh, SP("data"))

    def put(packed, bad, length):
        return (jax.device_put(packed, dp), jax.device_put(bad, dp),
                jax.device_put(length, dp))

    def f(packed, bad, length):
        # owner-shard (Ulysses all_to_all) counting: per-chip work is
        # batch/n_shards; shards hold DISJOINT k-mer sets, so the host
        # compaction below concatenates without a global re-sort
        args = put(packed, bad, length)
        ck, overflow = PC.count_kmers_bucketed(
            mesh, *args, cfg.k, bucket_cap)
        return ck, overflow, args

    def take_parts(out):
        from hga_tpu.parallel.hostpart import fetch

        ck, overflow, args = out
        if int(fetch(overflow)) > 0:  # pragma: no cover - skewed hash retry
            log.info("spectrum: bucket overflow, retrying at worst case")
            ck, _ = PC.count_kmers_bucketed(mesh, *args, cfg.k, worst_cap)
        # per-shard compact segments: shard s's distinct k-mers sit at
        # [s*seg, s*seg + n_s); multi-process shards are gathered (fetch)
        hi = fetch(ck.hi)
        lo = fetch(ck.lo)
        cnt = fetch(ck.count)
        ns = fetch(ck.n)
        seg = hi.shape[0] // ndev
        sel = np.concatenate(
            [np.arange(s * seg, s * seg + int(ns[s]))
             for s in range(ndev)])
        return hi[sel], lo[sel], cnt[sel]

    def batches():
        for s in range(0, len(idx), B):
            sel = idx[s : s + B]
            packed = pr.packed[sel]
            bad = pr.bad[sel]
            length = pr.length[sel]
            if packed.shape[0] < B:  # pad the tail batch to the static shape
                pad = B - packed.shape[0]
                packed = np.pad(packed, ((0, pad), (0, 0)))
                bad = np.pad(bad, ((0, pad), (0, 0)))
                length = np.pad(length, (0, pad))
            yield (jnp.asarray(packed), jnp.asarray(bad), jnp.asarray(length))

    from hga_tpu.parallel.stream import pipelined_map

    parts_hi: List[np.ndarray] = []
    parts_lo: List[np.ndarray] = []
    parts_cnt: List[np.ndarray] = []
    # host packing/padding of batch i+1..i+2 overlaps batch i's device
    # sort-count (PP analog, parallel/stream.py)
    for ck in pipelined_map(f, batches()):
        hi_p, lo_p, cnt_p = take_parts(ck)
        parts_hi.append(hi_p)
        parts_lo.append(lo_p)
        parts_cnt.append(cnt_p)

    if parts_hi:
        hi = np.concatenate(parts_hi)
        lo = np.concatenate(parts_lo)
        cnt = np.concatenate(parts_cnt)
    else:
        hi = np.zeros(0, np.uint32)
        lo = np.zeros(0, np.uint32)
        cnt = np.zeros(0, np.int32)

    if hi.size:
        merged = C.sort_and_count(jnp.asarray(hi), jnp.asarray(lo),
                                  jnp.asarray(cnt))
        hist = np.asarray(C.spectrum_histogram(merged, cfg.max_count))
        n = int(merged.n)
        hi = np.asarray(merged.hi[:n])
        lo = np.asarray(merged.lo[:n])
        cnt = np.asarray(merged.count[:n])
    else:
        hist = np.zeros(cfg.max_count + 1, np.int64)

    thr = cfg.solid_threshold or solid_threshold_from_hist(hist)
    log.info("spectrum: %d distinct %d-mers, threshold=%d", hi.size, cfg.k, thr)
    return SpectrumResult(hi=hi, lo=lo, count=cnt, hist=hist,
                          threshold=int(thr), k=cfg.k)

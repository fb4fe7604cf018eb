"""Stage 2 (judged config 2) — minimizer seeding + candidate overlap pairs.

Pipeline: packed reads -> device minimizer selection (ops.minimizer) ->
flat (minimizer, read, pos, strand) entry tensor -> device sorted-join pair
generation (ops.pairs).

The reference builds a hash-map seed index and cross-products its buckets
(SURVEY.md §4.2); here the index is a sorted tensor and the bucket
cross-product is a bounded sorted self-join, both on device.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from hga_tpu.config import AssemblerConfig
from hga_tpu.io.encode import PackedReads
from hga_tpu.ops import kmer as K
from hga_tpu.ops import minimizer as M
from hga_tpu.ops import pairs as P
from hga_tpu.ops.count import SENTINEL

log = logging.getLogger(__name__)


@dataclasses.dataclass
class SeedEntries:
    """Flat host-side minimizer entries for a read set."""

    hi: np.ndarray
    lo: np.ndarray
    read: np.ndarray
    pos: np.ndarray
    strand: np.ndarray


@dataclasses.dataclass
class SeedingResult:
    a: np.ndarray
    b: np.ndarray
    rel: np.ndarray
    diag: np.ndarray
    shared: np.ndarray
    overflow: int

    @property
    def n_pairs(self) -> int:
        return int(self.a.shape[0])

    def save(self, path: str) -> None:
        np.savez_compressed(path, a=self.a, b=self.b, rel=self.rel,
                            diag=self.diag, shared=self.shared,
                            overflow=np.int64(self.overflow))

    @staticmethod
    def load(path: str) -> "SeedingResult":
        z = np.load(path)
        return SeedingResult(a=z["a"], b=z["b"], rel=z["rel"], diag=z["diag"],
                             shared=z["shared"], overflow=int(z["overflow"]))


def solid_mask(hi: np.ndarray, lo: np.ndarray, solid) -> np.ndarray:
    """Membership of seed k-mers in the solid set (device sorted-merge)."""
    from hga_tpu.ops.count import member_sorted

    s_hi, s_lo = solid
    return np.asarray(member_sorted(
        jnp.asarray(s_hi.astype(np.uint32)),
        jnp.asarray(s_lo.astype(np.uint32)),
        jnp.asarray(hi.astype(np.uint32)),
        jnp.asarray(lo.astype(np.uint32))))


def _minimizer_batch_fn(k: int, w: int):
    @jax.jit
    def f(packed, bad, length):
        kb = K.extract_kmers(packed, bad, length, k)
        return M.select_minimizers(kb, w, length, k)

    return f


def _compact_batch_fn(k: int, w: int, row_bits: int, full: bool = False):
    """Minimizer selection + DEVICE compaction of the taken entries.

    The dense (B, n_win) minimizer planes must never cross to host: for
    long backbones (pad ~40 kb) a 4096-read batch is ~GBs of readback
    while the real entries are ~2% of the slots.  A cumsum-scatter packs
    the taken entries to the front of cap output rows; the host then
    fetches count (tiny) and one power-of-two-rounded slice per array
    (bounded compiled shapes).

    cap is sized from the minimizer density: the expected take rate is
    2/(w+1), so 4x slots/(w+1) leaves a 2x margin (and w <= 3 gets the full
    slot count — lossless by construction).  The scatter drops entries past
    cap; callers see the TRUE count and re-run the batch with full=True
    (cap = every slot, the overflow-proof shape) when count > cap, so no
    configuration can lose seeds silently (round-3 advisor item 1: the
    previous fixed slots/2 cap lost seeds for w <= 3, and adversarial
    homopolymer runs can reach take density 1 at ANY w).
    """

    @jax.jit
    def f(packed, bad, length):
        kb = K.extract_kmers(packed, bad, length, k)
        mb = M.select_minimizers(kb, w, length, k)
        B, n_win = mb.take.shape
        slots = B * n_win
        cap = slots if full else min(slots, 4 * slots // (w + 1) + 64)
        flat = mb.take.ravel()
        dest = jnp.where(flat, jnp.cumsum(flat.astype(jnp.int32)) - 1, cap)

        def put(x):
            return jnp.zeros((cap + 1,), x.dtype).at[dest].set(
                x.ravel(), mode="drop")[:cap]

        row = jax.lax.broadcasted_iota(jnp.int32, (B, n_win), 0)
        # pack (row, strand, pos) into ONE readback word — the compacted
        # entry readback is 3 words/entry instead of 5 (whether long-pad
        # extraction is still readback-bound on the card is to be
        # re-measured, ROADMAP Queue 3 item 3).
        # Bit split is dynamic: row_bits = log2(B), pos gets 30 - row_bits
        # — always enough because the slot budget bounds B * pad <= 2^24
        # (megabase contig backbones at polish time get B = 8, pos 27 bits)
        pos_bits = 30 - row_bits
        meta = ((row << (pos_bits + 1))
                | (mb.strand.astype(jnp.int32) << pos_bits)
                | mb.pos.astype(jnp.int32))
        count = jnp.sum(flat.astype(jnp.int32))
        return (put(mb.hi), put(mb.lo), put(meta), count)

    return f


# device minimizer-plane slots (reads x windows) per extraction batch: the
# batch row count scales DOWN for long pads so HBM and per-batch latency
# stay bounded (a 45 kb-pad read set at batch 4096 is 184M slots otherwise)
EXTRACT_SLOT_BUDGET = 1 << 24


def extract_seed_entries(pr: PackedReads, cfg: AssemblerConfig,
                         idx: Optional[np.ndarray] = None) -> SeedEntries:
    """Device minimizer selection + device compaction, batch-wise."""
    if idx is None:
        idx = np.arange(pr.n_reads)
    # small read sets (e.g. contig backbones) must not pad up to a huge
    # static batch; power-of-two rounding bounds the compiled shapes; the
    # slot budget bounds rows x windows for long pads
    B = min(cfg.batch_reads, 4096,
            max(8, 1 << (max(1, len(idx)) - 1).bit_length()),
            max(8, 1 << max(0, (EXTRACT_SLOT_BUDGET // max(pr.pad_len, 1))
                            .bit_length() - 1)))
    row_bits = (B - 1).bit_length()
    pos_bits = 30 - row_bits
    # always satisfiable: the slot budget bounds B * pad (see
    # _compact_batch_fn), but guard the raw-pad case where B was clamped
    # by batch_reads rather than the budget
    assert pr.pad_len <= (1 << pos_bits), (
        f"pad_len {pr.pad_len} exceeds the packed-meta budget at B={B}")
    f = _compact_batch_fn(cfg.k, cfg.w, row_bits)
    log.info("seeding: extracting minimizers for %d reads (batch %d)",
             len(idx), B)

    def batches():
        for s in range(0, len(idx), B):
            sel = idx[s : s + B]
            packed, bad, length = pr.packed[sel], pr.bad[sel], pr.length[sel]
            nb = packed.shape[0]
            if nb < B:
                packed = np.pad(packed, ((0, B - nb), (0, 0)))
                bad = np.pad(bad, ((0, B - nb), (0, 0)))
                length = np.pad(length, (0, B - nb))
            yield (f(jnp.asarray(packed), jnp.asarray(bad),
                     jnp.asarray(length)), sel, nb)

    from hga_tpu.parallel.stream import pipelined_map

    his, los, reads, poss, strands = [], [], [], [], []
    # device minimizer selection of later batches overlaps this batch's
    # sliced readback (PP analog, parallel/stream.py)
    f_full = None
    for out, sel, nb in pipelined_map(lambda *x: x, batches()):
        hi_c, lo_c, meta_c, count = out
        K_n = int(count)
        cap = hi_c.shape[0]
        if K_n > cap:
            # density exceeded the sized cap (tiny w or adversarial input):
            # re-run this batch at the lossless full-slot cap
            log.warning("seeding: batch take count %d > cap %d — "
                        "re-running at full capacity", K_n, cap)
            if f_full is None:
                f_full = _compact_batch_fn(cfg.k, cfg.w, row_bits,
                                           full=True)
            packed, bad, length = pr.packed[sel], pr.bad[sel], pr.length[sel]
            if packed.shape[0] < B:
                padn = B - packed.shape[0]
                packed = np.pad(packed, ((0, padn), (0, 0)))
                bad = np.pad(bad, ((0, padn), (0, 0)))
                length = np.pad(length, (0, padn))
            hi_c, lo_c, meta_c, count = f_full(
                jnp.asarray(packed), jnp.asarray(bad), jnp.asarray(length))
            cap = hi_c.shape[0]
        if K_n == 0:
            continue
        # fetch ONLY the compacted prefix, pow2-rounded to bound shapes
        Kp = min(cap, max(1 << 14, 1 << (K_n - 1).bit_length()))
        fetch = lambda x: np.asarray(x[:Kp])[:K_n]
        meta = fetch(meta_c)
        rows = meta >> (pos_bits + 1)
        keep = rows < nb                  # padded rows produce no entries,
        # but guard anyway (their length is 0 so take is already False)
        # a canonical k-mer is 2k bits: for k <= 16 the hi word is
        # identically zero, so skipping its readback cuts a third of the
        # extraction's readback bytes
        his.append(np.zeros(int(keep.sum()), np.uint32) if cfg.k <= 16
                   else fetch(hi_c)[keep])
        los.append(fetch(lo_c)[keep])
        poss.append((meta & ((1 << pos_bits) - 1))[keep])
        strands.append(((meta >> pos_bits) & 1)[keep].astype(np.int32))
        reads.append(sel[rows[keep]].astype(np.int32))
    cat = lambda xs, dt: (np.concatenate(xs).astype(dt) if xs else np.zeros(0, dt))
    return SeedEntries(
        hi=cat(his, np.uint32), lo=cat(los, np.uint32),
        read=cat(reads, np.int32), pos=cat(poss, np.int32),
        strand=cat(strands, np.int32),
    )


def find_candidates(
    pr: PackedReads,
    cfg: AssemblerConfig,
    mode: str = "all",
    idx: Optional[np.ndarray] = None,
    pair_cap: Optional[int] = None,
    solid=None,
) -> SeedingResult:
    """Config-2 stage: minimizers -> frequency-filtered candidate pairs.

    solid: optional (hi, lo) solid-k-mer arrays; seeds whose k-mer is not
    solid are dropped before pair generation (SURVEY.md C5: the spectrum's
    discriminative k-mers drive candidate detection in the reference).

    Above ~3M minimizer entries the bounded device self-join would
    materialize O(N * max_freq) pair slots at once; all-vs-all dispatches to
    the chunked sorted-index route (models/overlap_long, same pair
    semantics, memory bounded by the chunk) — the judged config-2 path at
    E. coli scale.
    """
    if mode == "all" and idx is None and pair_cap is None:
        from hga_tpu.models.overlap_long import (INDEXED_ROUTE_ENTRIES,
                                                 find_candidates_all_indexed)

        est = 2 * int(pr.length.sum()) // max(cfg.w, 1)
        if est > INDEXED_ROUTE_ENTRIES:
            return find_candidates_all_indexed(pr, cfg, solid=solid)
    ent = extract_seed_entries(pr, cfg, idx)
    ent_hi, ent_lo = ent.hi, ent.lo
    if solid is not None and cfg.use_solid_seeds:
        keep = solid_mask(ent_hi, ent_lo, solid)
        log.info("seeding: %d/%d seeds are solid", int(keep.sum()), keep.size)
        ent_hi = np.where(keep, ent_hi, np.uint32(0xFFFFFFFF))
        ent_lo = np.where(keep, ent_lo, np.uint32(0xFFFFFFFF))
    N = max(16, int(ent_hi.shape[0]))
    if pair_cap is None:
        pair_cap = max(64, 8 * pr.n_reads)
    # pad entry arrays to a padded static size (multiple of 1024)
    Np = ((N + 1023) // 1024) * 1024
    pad = Np - ent_hi.shape[0]
    hi = np.pad(ent_hi, (0, pad), constant_values=0xFFFFFFFF)
    lo = np.pad(ent_lo, (0, pad), constant_values=0xFFFFFFFF)
    read = np.pad(ent.read, (0, pad))
    pos = np.pad(ent.pos, (0, pad))
    strand = np.pad(ent.strand, (0, pad))

    run = lambda cap: P.candidate_pairs(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(read),
        jnp.asarray(pos), jnp.asarray(strand),
        jnp.asarray(pr.length.astype(np.int32)),
        jnp.asarray(pr.category.astype(np.int32)),
        k=cfg.k, max_freq=cfg.max_seed_freq,
        min_shared=cfg.min_shared_minimizers,
        pair_cap=cap, mode=mode,
    )
    cp = run(pair_cap)
    if int(cp.overflow) > 0:
        # two-pass count -> allocate -> fill: the first pass already counted
        # the kept pairs (n + overflow), so exactly ONE re-run at the right
        # power-of-two capacity suffices (each capacity is a fresh compile
        # — never grow capacity in a retry loop)
        need = int(cp.n) + int(cp.overflow)
        pair_cap = 1 << max(6, (need - 1).bit_length())
        log.info("seeding: pair capacity -> %d (need %d)", pair_cap, need)
        cp = run(pair_cap)
    n = int(cp.n)
    res = SeedingResult(
        a=np.asarray(cp.a)[:n], b=np.asarray(cp.b)[:n],
        rel=np.asarray(cp.rel)[:n], diag=np.asarray(cp.diag)[:n],
        shared=np.asarray(cp.shared)[:n], overflow=int(cp.overflow),
    )
    log.info("seeding: %d entries -> %d candidate pairs (overflow %d)",
             N, n, res.overflow)
    return res

"""Stage 3 (judged config 3) — overlap extension over candidate pairs.

Two-pass device engine (replacing the reference's per-pair scalar DP,
SURVEY.md §4.2):

1. **Myers gate** (the throughput path): every candidate's expected overlap
   segment — derived from the seed diagonal — runs through the bit-parallel
   semi-global edit-distance engine (ops.myers_pallas on the GPU, 31 cells
   per int32 op per pair, UNBANDED so indel drift cannot silently fall out
   of a band).  Acceptance is a maximum edit rate over the segment:
   dist <= (1 - cfg.min_identity) * segment_len.
2. **Scored SW refine** on the survivors only: the banded wavefront DP
   (ops.align) computes exact scores + end coordinates;
   a reversed pass on the matched prefixes gives start coordinates
   (end-then-start trick).  Since the gate kills the false candidates, the
   scored pass runs on a small fraction of the pairs.

The band is centered by construction: the target is re-oriented (reverse
complement when rel=1) and shifted by the candidate's estimated diagonal.
Base-level CIGARs are only materialized where correction needs them
(models/correction.py).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hga_tpu.config import AssemblerConfig
from hga_tpu.io.encode import PackedReads, unpack_codes
from hga_tpu.models.seeding import SeedingResult
from hga_tpu.ops.align import SWResult, banded_sw_batch
from hga_tpu.parallel.stream import pipelined_map

log = logging.getLogger(__name__)

SENT_BASE = 4  # padding base code: never matches a real base 0..3

# wall-clock split of the last overlap run (gate vs refine seconds, pair
# counts) — read by bench/scale harnesses to answer "does the scored-SW
# refine matter at scale?" with numbers (round-2 verdict item 3a)
LAST_TIMINGS: Dict[str, float] = {}


def _sw_inner(cfg: "AssemblerConfig", band: int):
    """Single-shard scored SW (ops/align.py, the XLA wavefront DP)."""

    def inner(q, t, ql, tl):
        q, t = q.astype(jnp.int32), t.astype(jnp.int32)  # int8 codes in
        return banded_sw_batch(q, t, ql, tl, band=band, match=cfg.match,
                               mismatch=cfg.mismatch, gap=cfg.gap)

    return inner


def default_sw(cfg: "AssemblerConfig", mesh=None):
    """Score-only SW dispatch.  With a >1-device mesh the pair batch is
    shard_map'ed over the 'data' axis — each chip sweeps its share of pairs
    with the same DP (embarrassingly parallel, no collectives needed;
    SURVEY.md §3.1 data-parallel row)."""
    from hga_tpu.parallel.mesh import shard_batch_fn

    cache = {}

    def sw(q, t, ql, tl, band):
        if band not in cache:
            cache[band] = shard_batch_fn(mesh, _sw_inner(cfg, band),
                                         n_in=4, out_axes=SWResult)
        return cache[band](q, t, ql, tl)

    return sw


def _edit_inner():
    """Single-shard edit-distance DP: the Pallas kernel where
    ops/myers_pallas.gpu_kernel_takes says so (GPU, query within the word
    cap, one target row per pair), ops/myers.py otherwise.  The choice is
    static per traced shape."""
    from hga_tpu.ops.myers import myers_batch
    from hga_tpu.ops.myers_pallas import gpu_kernel_takes, myers_batch_pallas

    def inner(q, t, ql, tl):
        N, Lq = q.shape
        if gpu_kernel_takes(Lq, t.shape[0], N):
            return myers_batch_pallas(q, t, ql, tl)
        # codes arrive as int8; the XLA engine widens them on device
        return myers_batch(q.astype(jnp.int32), t.astype(jnp.int32), ql, tl)

    return inner


# Target length beyond which a mesh run COLUMN-SHARDS the target over the
# chips (ring sequence-parallel Myers, parallel/ring_myers.py) instead of
# replicating it per pair batch: at megabase Lt the per-pair window gather
# and the single-chip column scan dominate, and the ring's per-chip
# footprint is Lt/n_dev (SURVEY.md §3.1 SP/CP row, §6 long-context).
RING_MIN_LT = 1 << 16


def default_edit(cfg: "AssemblerConfig", mesh=None, ring_min_lt: int = RING_MIN_LT):
    """Edit-distance dispatch for the overlap gate (see default_sw for the
    mesh data-parallel behavior).  On a mesh, targets longer than
    ring_min_lt dispatch to the ring sequence-parallel engine — the
    long-context path (whole-genome segment sweeps, utils/evalx
    segment_identity) where one target is shared by every query and its
    columns live chip-sharded."""
    from hga_tpu.ops.myers import MyersResult
    from hga_tpu.parallel.mesh import shard_batch_fn

    inner = _edit_inner()
    sharded = shard_batch_fn(mesh, inner, n_in=4, out_axes=MyersResult)
    if mesh is None or mesh.devices.size <= 1:
        return sharded

    from hga_tpu.parallel.ring_myers import myers_ring

    ndev = mesh.devices.size

    def f(q, t, ql, tl):
        N = q.shape[0]
        Lt = t.shape[1]
        B = 2 * ndev
        # ring when the target is huge OR shared (a 1-row target cannot
        # shard over 'data' in the DP path; its columns shard instead)
        if (Lt % ndev == 0 and N % B == 0
                and (t.shape[0] == 1 or Lt >= ring_min_lt)):
            return myers_ring(mesh, q, t, ql, tl)
        if t.shape[0] == 1:
            t = jnp.broadcast_to(t, (N, Lt))
        return sharded(q, t, ql, tl)

    return f


@dataclasses.dataclass
class OverlapRecords:
    """PAF-shaped overlaps (SURVEY.md Appendix A).

    Coordinates are 0-based half-open in each read's FORWARD frame; rel=1
    means b maps reverse-complemented.  score is the DP score (all-integer);
    dist is the gate's unit-cost edit distance over the expected overlap
    segment (identity ~= 1 - dist / block_len).
    """

    a: np.ndarray
    b: np.ndarray
    rel: np.ndarray
    score: np.ndarray
    a_start: np.ndarray
    a_end: np.ndarray
    b_start: np.ndarray
    b_end: np.ndarray
    a_len: np.ndarray
    b_len: np.ndarray
    dist: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.dist is None:
            self.dist = np.zeros(self.a.shape[0], np.int32)

    @property
    def n(self) -> int:
        return int(self.a.shape[0])

    def identity(self) -> np.ndarray:
        """Per-record alignment identity estimate from the gate distance."""
        blk = np.maximum(np.maximum(self.a_end - self.a_start,
                                    self.b_end - self.b_start), 1)
        return np.clip(1.0 - self.dist / blk, 0.0, 1.0)

    def save(self, path: str) -> None:
        np.savez_compressed(path, **dataclasses.asdict(self))

    @staticmethod
    def load(path: str) -> "OverlapRecords":
        z = np.load(path)
        return OverlapRecords(**{k: z[k] for k in z.files})

    def to_paf(self, names_a, names_b) -> str:
        lines = []
        for i in range(self.n):
            blk = max(int(self.a_end[i] - self.a_start[i]),
                      int(self.b_end[i] - self.b_start[i]))
            matches = max(blk - int(self.dist[i]), 0)
            lines.append("\t".join(map(str, [
                names_a[self.a[i]], self.a_len[i], self.a_start[i], self.a_end[i],
                "+-"[int(self.rel[i])],
                names_b[self.b[i]], self.b_len[i], self.b_start[i], self.b_end[i],
                matches, blk, 255,
                f"NM:i:{int(self.dist[i])}",
                f"AS:i:{int(self.score[i])}",
                f"de:f:{int(self.dist[i]) / max(blk, 1):.4f}",
            ])))
        return "\n".join(lines) + ("\n" if lines else "")


def _oriented_codes(codes: np.ndarray, lengths: np.ndarray,
                    flip: np.ndarray) -> np.ndarray:
    """Reverse-complement rows where flip, respecting true lengths.

    Fully vectorized (one gather + selects) — no per-read host loop.
    """
    n, L = codes.shape
    idx = (lengths.astype(np.int64)[:, None] - 1) - np.arange(L)[None, :]
    rc = np.where(idx >= 0,
                  np.take_along_axis(codes, np.clip(idx, 0, L - 1), 1),
                  SENT_BASE)
    rc = np.where(rc < 4, 3 - rc, SENT_BASE)
    return np.where(flip[:, None], rc, codes).astype(codes.dtype)


def _window_gather(codes_b: np.ndarray, lengths_b: np.ndarray,
                   off: np.ndarray, Wt: int) -> np.ndarray:
    """t_win[i, x] = codes_b[i, x + off[i]], out-of-range -> SENT_BASE."""
    n, L = codes_b.shape
    x = np.arange(Wt)[None, :] + off[:, None]
    valid = (x >= 0) & (x < lengths_b[:, None])
    xc = np.clip(x, 0, L - 1)
    out = np.take_along_axis(codes_b, xc, axis=1)
    out[~valid] = SENT_BASE
    return out


def _myers_gate(q, la, lb, diag, t_gather, nb, cfg, edit, Wt):
    """Edit-distance gate over one candidate batch.

    q: (P, Lq) ORIENTED query codes (SENT past length); diag: expected
    a_pos - b_pos in the oriented frames.  The expected overlap segment of a
    is [max(0, diag), min(la, lb + diag)); it is clipped out of q and run
    through the UNBANDED bit-parallel edit-distance engine against a target
    window with band/2 slack on each side.  Accept iff the segment is long
    enough and dist <= (1 - min_identity) * segment_len.

    Returns (keep, dist, seg_len, q_seg_start).
    """
    P, Lq = q.shape
    qs = np.clip(diag, 0, la)
    qe = np.maximum(np.minimum(la, lb + diag), qs)
    seg = (qe - qs).astype(np.int64)
    x = np.arange(Lq)[None, :]
    gidx = x + qs[:, None]
    q_seg = np.where(x < seg[:, None],
                     np.take_along_axis(q, np.clip(gidx, 0, Lq - 1), 1),
                     SENT_BASE).astype(np.int32)
    off_m = qs - diag - cfg.band // 2
    t_m = t_gather(off_m)
    # dispatch only — the caller forces results a couple of batches later,
    # overlapping this batch's device sweep with the next batch's host
    # window gathers (parallel/stream.py PP analog)
    res = edit(jnp.asarray(q_seg.astype(np.int8)),
               jnp.asarray(t_m.astype(np.int8)),
               jnp.asarray(seg.astype(np.int32)),
               jnp.asarray(np.full(P, Wt, np.int32)))
    return res, seg, qs


def _gate_keep(res, seg, nb, cfg):
    """Force a dispatched gate batch and apply the edit-rate threshold.

    Also returns the forward pass's target end column (1-based window
    coords) — the "myers" refine derives b_end from it for free."""
    P = seg.shape[0]
    dist = np.asarray(res.dist).astype(np.int64)
    tend = np.asarray(res.tend).astype(np.int64)
    max_ed = np.floor((1.0 - cfg.min_identity) * seg).astype(np.int64)
    keep = ((np.arange(P) < nb)
            & (seg >= cfg.min_overlap_len)
            & (dist <= max_ed))
    return keep[:nb], dist[:nb], tend[:nb]


def _rev_segment(q, qs, seg, Lq):
    """Row i reversed over its segment [qs_i, qs_i + seg_i), SENT past it."""
    x = np.arange(Lq)[None, :]
    ridx = (qs + seg)[:, None] - 1 - x
    out = np.where(x < seg[:, None],
                   np.take_along_axis(q, np.clip(ridx, 0, Lq - 1), 1),
                   SENT_BASE)
    return out.astype(np.int32)


def _myers_refine(q, qs, seg, dist, off_m, t_win, nb, cfg, edit, Wt):
    """Start coordinates via ONE reversed bit-parallel pass (the round-2
    verdict's refine-free option: the forward gate's tend is b_end; the
    same engine on reversed sequences yields b_start at gate speed instead
    of two banded scored-SW sweeps per survivor).

    Returns (b_or_start_rel_window_base=False) actually (b_or_start, ok):
    b_or_start in ORIENTED-target coordinates (off_m + Wt - tend_rev); ok
    requires the reversed pass to reproduce the forward edit distance (the
    analog of the SW path's rscore >= score consistency check).
    """
    P, Lq = q.shape
    q_rev = _rev_segment(q, qs, seg, Lq)
    t_rev = t_win[:, ::-1].copy()
    res = edit(jnp.asarray(q_rev.astype(np.int8)),
               jnp.asarray(t_rev.astype(np.int8)),
               jnp.asarray(seg.astype(np.int32)),
               jnp.asarray(np.full(P, Wt, np.int32)))
    dist_r = np.asarray(res.dist).astype(np.int64)
    tend_r = np.asarray(res.tend).astype(np.int64)
    b_or_start = off_m + Wt - tend_r
    ok = (np.arange(P) < nb) & (dist_r == dist) & (seg > 0)
    return b_or_start, ok


def compute_overlaps(
    pr: PackedReads,
    cands: SeedingResult,
    cfg: AssemblerConfig,
    sw_fn=None,
    edit_fn=None,
    batch_pairs: int = 4096,
    mesh=None,
) -> OverlapRecords:
    """Two-pass overlap engine: Myers edit-rate gate, then SW refine.

    Multi-process: each process gates/refines a contiguous block of the
    candidate list on its local devices; records are re-replicated by a
    rank-ordered gather, preserving single-process record order
    (parallel/hostpart)."""
    from hga_tpu.parallel import hostpart as HP

    if cands.n_pairs == 0:
        z = np.zeros(0, np.int32)
        return OverlapRecords(z, z, z, z, z, z, z, z, z, z)
    partition = (sw_fn is None and edit_fn is None and HP.nproc() > 1
                 and cands.n_pairs >= HP.nproc())
    if partition:
        p_lo, p_hi = HP.block_range(cands.n_pairs)
        cands = SeedingResult(
            a=cands.a[p_lo:p_hi], b=cands.b[p_lo:p_hi],
            rel=cands.rel[p_lo:p_hi], diag=cands.diag[p_lo:p_hi],
            shared=cands.shared[p_lo:p_hi], overflow=cands.overflow)
        mesh = HP.local_mesh(mesh)
    HP.note("gate_pairs", cands.n_pairs)
    sw = sw_fn or default_sw(cfg, mesh)
    edit = edit_fn or default_edit(cfg, mesh)

    codes = unpack_codes(pr.packed).astype(np.int32)  # (R, pad_len)
    # mask bases past each read's length so they can never match
    Lpad = codes.shape[1]
    past = np.arange(Lpad)[None, :] >= pr.length[:, None]
    codes[past] = SENT_BASE
    lengths = pr.length.astype(np.int32)

    Lq = Lpad
    Wt = Lq + cfg.band + 8

    # ---- pass 1: bit-parallel Myers gate over EVERY candidate ----
    # don't pad a small candidate list up to a huge static batch; round to a
    # power of two so the number of distinct compiled shapes stays bounded
    bp = min(batch_pairs, max(8, 1 << (cands.n_pairs - 1).bit_length()))

    def gate_batches():
        for s in range(0, cands.n_pairs, bp):
            a = cands.a[s : s + bp].astype(np.int64)
            b = cands.b[s : s + bp].astype(np.int64)
            rel = cands.rel[s : s + bp].astype(np.int32)
            diag = cands.diag[s : s + bp].astype(np.int64)
            nb = a.shape[0]
            if nb < bp:
                padn = bp - nb
                a, b = np.pad(a, (0, padn)), np.pad(b, (0, padn))
                rel, diag = np.pad(rel, (0, padn)), np.pad(diag, (0, padn))
            la = lengths[a].astype(np.int64)
            lb = lengths[b].astype(np.int64)
            t_or = _oriented_codes(codes[b], lengths[b], rel == 1)
            gather = lambda off: _window_gather(t_or, lb, off, Wt)
            res, seg, qs = _myers_gate(
                codes[a], la, lb, diag, gather, nb, cfg, edit, Wt)
            yield res, seg, qs, nb

    t_gate0 = time.perf_counter()
    g_keep, g_dist, g_tend, g_qs, g_seg = [], [], [], [], []
    for res, seg, qs, nb in pipelined_map(lambda *b: b, gate_batches()):
        keep, dist, tend = _gate_keep(res, seg, nb, cfg)
        g_keep.append(keep)
        g_dist.append(dist)
        g_tend.append(tend)
        g_qs.append(qs[:nb])
        g_seg.append(seg[:nb])
    t_gate = time.perf_counter() - t_gate0
    keep_all = np.concatenate(g_keep)
    dist_all = np.concatenate(g_dist)
    f_a = cands.a[keep_all].astype(np.int64)
    f_b = cands.b[keep_all].astype(np.int64)
    f_rel = cands.rel[keep_all].astype(np.int32)
    f_diag = cands.diag[keep_all].astype(np.int32)
    f_dist = dist_all[keep_all].astype(np.int32)
    f_tend = np.concatenate(g_tend)[keep_all].astype(np.int64)
    f_qs = np.concatenate(g_qs)[keep_all].astype(np.int64)
    f_seg = np.concatenate(g_seg)[keep_all].astype(np.int64)
    n_f = f_a.shape[0]
    log.info("overlap gate: %d candidates -> %d pass edit-rate filter",
             cands.n_pairs, n_f)
    if n_f == 0 and not partition:
        # under partition the zero-survivor process must still reach the
        # final allgather (a collective) with its empty shard
        z = np.zeros(0, np.int32)
        return OverlapRecords(z, z, z, z, z, z, z, z, z, z)

    # ---- pass 2: survivor coordinates ----
    if cfg.overlap_refine not in ("myers", "sw"):
        raise ValueError(f"overlap_refine must be 'myers' or 'sw', "
                         f"got {cfg.overlap_refine!r}")
    t_ref0 = time.perf_counter()
    batch_pairs = min(batch_pairs, max(8, 1 << (max(1, n_f) - 1).bit_length()))
    outs = {k: [] for k in ("a", "b", "rel", "score", "a_start", "a_end",
                            "b_start", "b_end", "dist")}
    use_myers = cfg.overlap_refine == "myers"
    my_iter = range(0, n_f, batch_pairs) if use_myers else range(0)
    sw_iter = range(0, n_f, batch_pairs) if not use_myers else range(0)

    for s in my_iter:
        sl = slice(s, s + batch_pairs)
        a, b = f_a[sl], f_b[sl]
        rel = f_rel[sl]
        diag = f_diag[sl].astype(np.int64)
        dist = f_dist[sl].astype(np.int64)
        tend, qs, seg = f_tend[sl], f_qs[sl], f_seg[sl]
        nb = a.shape[0]
        P = batch_pairs
        if nb < P:
            padn = P - nb
            a, b = np.pad(a, (0, padn)), np.pad(b, (0, padn))
            rel, diag = np.pad(rel, (0, padn)), np.pad(diag, (0, padn))
            dist, tend = np.pad(dist, (0, padn)), np.pad(tend, (0, padn))
            qs, seg = np.pad(qs, (0, padn)), np.pad(seg, (0, padn))
        lb = lengths[b].astype(np.int64)
        t_or = _oriented_codes(codes[b], lengths[b], rel == 1)
        off_m = qs - diag - cfg.band // 2       # the gate's window base
        t_win = _window_gather(t_or, lb, off_m, Wt)
        b_or_start, ok = _myers_refine(
            codes[a], qs, seg, dist, off_m, t_win, nb, cfg, edit, Wt)
        b_or_end = off_m + tend
        b_or_start = np.clip(b_or_start, 0, lb)
        b_or_end = np.clip(b_or_end, b_or_start, lb)
        b_fwd_start = np.where(rel == 1, lb - b_or_end, b_or_start)
        b_fwd_end = np.where(rel == 1, lb - b_or_start, b_or_end)
        score = cfg.match * np.maximum(seg - dist, 0)
        keep = ok & (score >= cfg.min_overlap_score)
        outs["a"].append(a[keep].astype(np.int32))
        outs["b"].append(b[keep].astype(np.int32))
        outs["rel"].append(rel[keep])
        outs["score"].append(score[keep].astype(np.int32))
        outs["a_start"].append(qs[keep].astype(np.int32))
        outs["a_end"].append((qs + seg)[keep].astype(np.int32))
        outs["b_start"].append(b_fwd_start[keep].astype(np.int32))
        outs["b_end"].append(b_fwd_end[keep].astype(np.int32))
        outs["dist"].append(dist[keep].astype(np.int32))

    for s in sw_iter:
        a = f_a[s : s + batch_pairs]
        b = f_b[s : s + batch_pairs]
        rel = f_rel[s : s + batch_pairs]
        diag = f_diag[s : s + batch_pairs]
        dist = f_dist[s : s + batch_pairs]
        nb = a.shape[0]
        P = batch_pairs
        if nb < P:  # pad the tail batch
            padn = P - nb
            a = np.pad(a, (0, padn))
            b = np.pad(b, (0, padn))
            rel = np.pad(rel, (0, padn))
            diag = np.pad(diag, (0, padn))
            dist = np.pad(dist, (0, padn))

        q = codes[a]
        qlen = np.where(np.arange(P) < nb, lengths[a], 0).astype(np.int32)
        t_or = _oriented_codes(codes[b], lengths[b], rel == 1)
        # expected j - i = pos_b_oriented - pos_a = -diag: shift t so the
        # band is centered, keeping `band` slack to the left
        off = -diag - cfg.band // 2
        t_win = _window_gather(t_or, lengths[b].astype(np.int64), off, Wt)
        tlen = np.where(np.arange(P) < nb, Wt, 0).astype(np.int32)

        fwd = sw(jnp.asarray(q.astype(np.int8)),
                 jnp.asarray(t_win.astype(np.int8)), jnp.asarray(qlen),
                 jnp.asarray(tlen), cfg.band)
        score = np.asarray(fwd.score)
        qend = np.asarray(fwd.qend)
        tend = np.asarray(fwd.tend)

        # Reverse pass on the matched prefixes for start coordinates: align
        # reversed(q[:qend]) vs reversed(t[:tend]).  The reversed path lives
        # on diagonals (tend - qend) - c with c in [-band, band] and
        # |tend - qend| <= band, so a 2*band reverse band always contains it
        # and the reverse score equals the forward score.  End cells map
        # back as qstart = qend - qend', tstart = tend - tend'.
        qidx = (qend[:, None] - 1) - np.arange(Lq)[None, :]
        qr = np.where(qidx >= 0,
                      np.take_along_axis(q, np.clip(qidx, 0, Lq - 1), 1),
                      SENT_BASE).astype(np.int32)
        tidx = (tend[:, None] - 1) - np.arange(Wt)[None, :]
        tr = np.where(tidx >= 0,
                      np.take_along_axis(t_win, np.clip(tidx, 0, Wt - 1), 1),
                      SENT_BASE).astype(np.int32)
        rev = sw(jnp.asarray(qr.astype(np.int8)),
                 jnp.asarray(tr.astype(np.int8)),
                 jnp.asarray(qend.astype(np.int32)),
                 jnp.asarray(tend.astype(np.int32)), 2 * cfg.band)
        rscore = np.asarray(rev.score)
        qstart = qend - np.asarray(rev.qend)
        tstart = tend - np.asarray(rev.tend)

        # map window coords back to the oriented b frame, then forward frame
        b_or_start = tstart + off
        b_or_end = tend + off
        lb = lengths[b]
        b_fwd_start = np.where(rel == 1, lb - b_or_end, b_or_start)
        b_fwd_end = np.where(rel == 1, lb - b_or_start, b_or_end)

        keep = (
            (np.arange(P) < nb)
            & (score >= cfg.min_overlap_score)
            & ((qend - qstart) >= cfg.min_overlap_len)
            & (rscore >= score)  # reverse pass must reproduce the score
        )
        outs["a"].append(a[keep].astype(np.int32))
        outs["b"].append(b[keep].astype(np.int32))
        outs["rel"].append(rel[keep])
        outs["score"].append(score[keep].astype(np.int32))
        outs["a_start"].append(qstart[keep].astype(np.int32))
        outs["a_end"].append(qend[keep].astype(np.int32))
        outs["b_start"].append(b_fwd_start[keep].astype(np.int32))
        outs["b_end"].append(b_fwd_end[keep].astype(np.int32))
        outs["dist"].append(dist[keep].astype(np.int32))

    cat = {k: (np.concatenate(v) if v else np.zeros(0, np.int32))
           for k, v in outs.items()}
    if partition:
        cat = HP.allgather_concat(cat)
    rec = OverlapRecords(
        a_len=lengths[cat["a"]], b_len=lengths[cat["b"]], **cat)
    t_ref = time.perf_counter() - t_ref0
    LAST_TIMINGS.update(gate_s=round(t_gate, 3), refine_s=round(t_ref, 3),
                        gate_pairs=cands.n_pairs, refine_pairs=n_f)
    log.info("overlap: %d candidates -> %d overlaps "
             "(gate %.2fs on %d pairs, refine %.2fs on %d survivors)",
             cands.n_pairs, rec.n, t_gate, cands.n_pairs, t_ref, n_f)
    return rec


def compute_overlaps_cross(
    pr_a: PackedReads,
    pr_b: PackedReads,
    cfg: AssemblerConfig,
    sw_fn=None,
    edit_fn=None,
    batch_pairs: int = 4096,
    mesh=None,
) -> OverlapRecords:
    """Judged config 3: overlaps BETWEEN two read sets (short reads as
    queries `a`, long reads as targets `b`).

    The reference queries its short-read index with each long read
    (SURVEY.md §4.2); here the cross-category candidates come from the
    merged sorted minimizer index and each candidate runs the same two-pass
    engine as compute_overlaps: bit-parallel Myers edit-rate gate, then the
    banded wavefront kernel on survivors for exact scores/coordinates
    (b coordinates in the long read's forward frame; the READ is
    reverse-complemented for rel=1 so alignments share the target's forward
    context).
    """
    from hga_tpu.models.correction import find_candidates_cross
    from hga_tpu.parallel import hostpart as HP

    a, b, rel, diag = find_candidates_cross(pr_a, pr_b, cfg)
    if len(a) == 0:
        z = np.zeros(0, np.int32)
        return OverlapRecords(z, z, z, z, z, z, z, z, z, z)
    # multi-process: partition the candidate list (contiguous blocks, local
    # devices, rank-ordered gather) — see compute_overlaps
    partition = (sw_fn is None and edit_fn is None and HP.nproc() > 1
                 and len(a) >= HP.nproc())
    if partition:
        p_lo, p_hi = HP.block_range(len(a))
        a, b = a[p_lo:p_hi], b[p_lo:p_hi]
        rel, diag = rel[p_lo:p_hi], diag[p_lo:p_hi]
        mesh = HP.local_mesh(mesh)
    sw = sw_fn or default_sw(cfg, mesh)
    edit = edit_fn or default_edit(cfg, mesh)

    a_codes = unpack_codes(pr_a.packed).astype(np.int32)
    Lq = a_codes.shape[1]
    a_codes[np.arange(Lq)[None, :] >= pr_a.length[:, None]] = SENT_BASE
    b_codes = unpack_codes(pr_b.packed).astype(np.int32)
    Lb = b_codes.shape[1]
    b_codes[np.arange(Lb)[None, :] >= pr_b.length[:, None]] = SENT_BASE
    b_flat = b_codes.reshape(-1)

    Wt = Lq + cfg.band + 8

    def _b_gather(bb, lb, off):
        pos_f = np.arange(Wt)[None, :] + off[:, None]
        in_range = (pos_f >= 0) & (pos_f < lb[:, None])
        vals = b_flat[bb[:, None] * Lb + np.clip(pos_f, 0, Lb - 1)]
        return np.where(in_range, vals, SENT_BASE).astype(np.int32)

    # ---- pass 1: Myers gate ----
    n0 = len(a)
    bp = min(batch_pairs, max(8, 1 << (n0 - 1).bit_length()))

    def gate_batches():
        for s in range(0, n0, bp):
            aa = a[s : s + bp].astype(np.int64)
            bb = b[s : s + bp].astype(np.int64)
            rr = rel[s : s + bp].astype(np.int32)
            dd = diag[s : s + bp].astype(np.int64)
            nb = aa.shape[0]
            if nb < bp:
                padn = bp - nb
                aa, bb = np.pad(aa, (0, padn)), np.pad(bb, (0, padn))
                rr, dd = np.pad(rr, (0, padn)), np.pad(dd, (0, padn))
            la = pr_a.length[aa].astype(np.int64)
            lb = pr_b.length[bb].astype(np.int64)
            q = _oriented_codes(a_codes[aa], la, rr == 1)
            # oriented a_pos i sits at b forward pos i + base_off (seed
            # algebra); diag_c follows the a_pos - b_pos convention
            base_off = np.where(rr == 1, dd + lb - la, -dd).astype(np.int64)
            gather = lambda off: _b_gather(bb, lb, off)
            res, seg, qs = _myers_gate(
                q, la, lb, -base_off, gather, nb, cfg, edit, Wt)
            yield res, seg, qs, nb

    t_gate0 = time.perf_counter()
    g_keep, g_dist, g_tend, g_qs, g_seg = [], [], [], [], []
    for res, seg, qs, nb in pipelined_map(lambda *x: x, gate_batches()):
        keep, dist, tend = _gate_keep(res, seg, nb, cfg)
        g_keep.append(keep)
        g_dist.append(dist)
        g_tend.append(tend)
        g_qs.append(qs[:nb])
        g_seg.append(seg[:nb])
    t_gate = time.perf_counter() - t_gate0
    keep_all = np.concatenate(g_keep)
    dist_all = np.concatenate(g_dist)
    f_a = a[keep_all].astype(np.int64)
    f_b = b[keep_all].astype(np.int64)
    f_rel = rel[keep_all].astype(np.int32)
    f_diag = diag[keep_all].astype(np.int32)
    f_dist = dist_all[keep_all].astype(np.int32)
    f_tend = np.concatenate(g_tend)[keep_all].astype(np.int64)
    f_qs = np.concatenate(g_qs)[keep_all].astype(np.int64)
    f_seg = np.concatenate(g_seg)[keep_all].astype(np.int64)
    n_f = f_a.shape[0]
    log.info("overlap-cross gate: %d candidates -> %d pass edit-rate filter",
             n0, n_f)
    if n_f == 0 and not partition:
        z = np.zeros(0, np.int32)
        return OverlapRecords(z, z, z, z, z, z, z, z, z, z)

    # ---- pass 2: survivor coordinates ----
    if cfg.overlap_refine not in ("myers", "sw"):
        raise ValueError(f"overlap_refine must be 'myers' or 'sw', "
                         f"got {cfg.overlap_refine!r}")
    t_ref0 = time.perf_counter()
    batch_pairs = min(batch_pairs, max(8, 1 << (max(1, n_f) - 1).bit_length()))
    outs = {k: [] for k in ("a", "b", "rel", "score", "a_start", "a_end",
                            "b_start", "b_end", "dist")}
    use_myers = cfg.overlap_refine == "myers"
    my_iter = range(0, n_f, batch_pairs) if use_myers else range(0)
    sw_iter = range(0, n_f, batch_pairs) if not use_myers else range(0)

    for s in my_iter:
        sl = slice(s, s + batch_pairs)
        aa, bb = f_a[sl], f_b[sl]
        rr = f_rel[sl]
        dd = f_diag[sl].astype(np.int64)
        dist = f_dist[sl].astype(np.int64)
        tend, qs, seg = f_tend[sl], f_qs[sl], f_seg[sl]
        nb = aa.shape[0]
        P = batch_pairs
        if nb < P:
            padn = P - nb
            aa, bb = np.pad(aa, (0, padn)), np.pad(bb, (0, padn))
            rr, dd = np.pad(rr, (0, padn)), np.pad(dd, (0, padn))
            dist, tend = np.pad(dist, (0, padn)), np.pad(tend, (0, padn))
            qs, seg = np.pad(qs, (0, padn)), np.pad(seg, (0, padn))
        la = pr_a.length[aa].astype(np.int64)
        lb = pr_b.length[bb].astype(np.int64)
        flip = rr == 1
        q = _oriented_codes(a_codes[aa], la, flip).astype(np.int32)
        # the gate ran with diag = -base_off; off_m = qs - diag - band/2
        base_off = np.where(flip, dd + lb - la, -dd).astype(np.int64)
        off_m = qs + base_off - cfg.band // 2
        t_win = _b_gather(bb, lb, off_m)
        b_start_f, ok = _myers_refine(
            q, qs, seg, dist, off_m, t_win, nb, cfg, edit, Wt)
        b_end_f = off_m + tend                  # b is NOT oriented here
        b_start_f = np.clip(b_start_f, 0, lb)
        b_end_f = np.clip(b_end_f, b_start_f, lb)
        # oriented-a segment coords -> the read's forward frame
        a_start_f = np.where(flip, la - (qs + seg), qs)
        a_end_f = np.where(flip, la - qs, qs + seg)
        score = cfg.match * np.maximum(seg - dist, 0)
        keep = ok & (score >= cfg.min_overlap_score)
        outs["a"].append(aa[keep].astype(np.int32))
        outs["b"].append(bb[keep].astype(np.int32))
        outs["rel"].append(rr[keep])
        outs["score"].append(score[keep].astype(np.int32))
        outs["a_start"].append(a_start_f[keep].astype(np.int32))
        outs["a_end"].append(a_end_f[keep].astype(np.int32))
        outs["b_start"].append(b_start_f[keep].astype(np.int32))
        outs["b_end"].append(b_end_f[keep].astype(np.int32))
        outs["dist"].append(dist[keep].astype(np.int32))

    for s in sw_iter:
        aa = f_a[s : s + batch_pairs]
        bb = f_b[s : s + batch_pairs]
        rr = f_rel[s : s + batch_pairs]
        dd = f_diag[s : s + batch_pairs]
        dist = f_dist[s : s + batch_pairs]
        nb = aa.shape[0]
        P = batch_pairs
        if nb < P:
            padn = P - nb
            aa, bb = np.pad(aa, (0, padn)), np.pad(bb, (0, padn))
            rr, dd = np.pad(rr, (0, padn)), np.pad(dd, (0, padn))
            dist = np.pad(dist, (0, padn))
        la = pr_a.length[aa].astype(np.int64)
        lb = pr_b.length[bb].astype(np.int64)
        flip = rr == 1
        q = _oriented_codes(a_codes[aa], la, flip).astype(np.int32)
        qlen = np.where(np.arange(P) < nb, pr_a.length[aa], 0).astype(np.int32)
        off = np.where(flip, dd + lb - la, -dd).astype(np.int64) - cfg.band // 2
        t_win = _b_gather(bb, lb, off)
        tlen = np.where(np.arange(P) < nb, Wt, 0).astype(np.int32)

        fwd = sw(jnp.asarray(q.astype(np.int8)),
                 jnp.asarray(t_win.astype(np.int8)), jnp.asarray(qlen),
                 jnp.asarray(tlen), cfg.band)
        score = np.asarray(fwd.score)
        qend = np.asarray(fwd.qend)
        tend = np.asarray(fwd.tend)
        qidx2 = (qend[:, None] - 1) - np.arange(Lq)[None, :]
        qr = np.where(qidx2 >= 0,
                      np.take_along_axis(q, np.clip(qidx2, 0, Lq - 1), 1),
                      SENT_BASE).astype(np.int32)
        tidx = (tend[:, None] - 1) - np.arange(Wt)[None, :]
        tr = np.where(tidx >= 0,
                      np.take_along_axis(t_win, np.clip(tidx, 0, Wt - 1), 1),
                      SENT_BASE).astype(np.int32)
        rev = sw(jnp.asarray(qr.astype(np.int8)),
                 jnp.asarray(tr.astype(np.int8)),
                 jnp.asarray(qend.astype(np.int32)),
                 jnp.asarray(tend.astype(np.int32)), 2 * cfg.band)
        rscore = np.asarray(rev.score)
        q_start = qend - np.asarray(rev.qend)
        t_start = tend - np.asarray(rev.tend)

        # window -> long-read forward coords; query coords -> the read's
        # forward frame when the read was flipped
        b_start_f = t_start + off
        b_end_f = tend + off
        a_start_f = np.where(flip, la - qend, q_start)
        a_end_f = np.where(flip, la - q_start, qend)
        keep = ((np.arange(P) < nb)
                & (score >= cfg.min_overlap_score)
                & ((qend - q_start) >= cfg.min_overlap_len)
                & (rscore >= score))
        outs["a"].append(aa[keep].astype(np.int32))
        outs["b"].append(bb[keep].astype(np.int32))
        outs["rel"].append(rr[keep])
        outs["score"].append(score[keep].astype(np.int32))
        outs["a_start"].append(a_start_f[keep].astype(np.int32))
        outs["a_end"].append(a_end_f[keep].astype(np.int32))
        outs["b_start"].append(b_start_f[keep].astype(np.int32))
        outs["b_end"].append(b_end_f[keep].astype(np.int32))
        outs["dist"].append(dist[keep].astype(np.int32))

    cat = {k: (np.concatenate(v) if v else np.zeros(0, np.int32))
           for k, v in outs.items()}
    if partition:
        cat = HP.allgather_concat(cat)
    rec = OverlapRecords(
        a_len=pr_a.length[cat["a"]].astype(np.int32),
        b_len=pr_b.length[cat["b"]].astype(np.int32), **cat)
    t_ref = time.perf_counter() - t_ref0
    LAST_TIMINGS.update(gate_s=round(t_gate, 3), refine_s=round(t_ref, 3),
                        gate_pairs=n0, refine_pairs=n_f)
    log.info("overlap-cross: %d candidates -> %d overlaps "
             "(gate %.2fs on %d pairs, refine %.2fs on %d survivors)",
             len(a), rec.n, t_gate, n0, t_ref, n_f)
    return rec

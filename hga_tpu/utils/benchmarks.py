"""Benchmarks — GCUPS for the DP engines, reads/s for counting & pipeline.

Every result names the device it ran on (platform, device_kind, device
count) and the implementation that ran (``impl``): the engine is the one
the pipeline's own dispatch picks for that backend and shape, so a number
taken on the CPU can never pass for a device number.  Times are the best
of a few calls after a warm-up call, each forced with block_until_ready.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np


def device_info() -> Dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices())}


def best_seconds(fn, *args, reps: int = 5) -> float:
    """Best wall seconds of one fn(*args) call, compile excluded."""
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def _pairs(n_pairs: int, Lq: int, Lt: int):
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.integers(0, 4, (n_pairs, Lq)).astype(np.int32))
    t = jnp.asarray(rng.integers(0, 4, (n_pairs, Lt)).astype(np.int32))
    ql = jnp.asarray(np.full(n_pairs, Lq, np.int32))
    tl = jnp.asarray(np.full(n_pairs, Lt, np.int32))
    return q, t, ql, tl


def bench_sw(n_pairs: int = 8192, Lq: int = 128, Lt: int = 256,
             band: int = 64) -> Dict:
    """Banded-SW GCUPS on config-3-shaped pairs (short read vs long window):
    the XLA wavefront DP behind overlap_refine = "sw"."""
    import functools

    from hga_tpu.ops.align import banded_sw_batch, sw_cells

    args = _pairs(n_pairs, Lq, Lt)
    cells = sw_cells([Lq], [Lt], band) * n_pairs
    dt = best_seconds(functools.partial(banded_sw_batch, band=band), *args)
    return {"impl": "xla", "seconds": dt, "gcups": cells / dt / 1e9,
            "cells": cells, "n_pairs": n_pairs, "Lq": Lq, "Lt": Lt,
            "band": band}


def bench_myers(n_pairs: int = 8192, Lq: int = 112, Lt: int = 192) -> Dict:
    """Overlap-gate GCUPS on the engine the pipeline's dispatch picks
    (models/overlap._edit_inner): the Pallas kernel on the GPU, the XLA
    column loop elsewhere.  Default shape: a 100 bp read padded to 112
    against its gate window.

    Cell accounting is the full Lq x Lt DP matrix per pair — exactly the
    cells the UNBANDED semi-global recurrence evaluates.
    """
    from hga_tpu.models.overlap import _edit_inner
    from hga_tpu.ops.myers_pallas import gpu_kernel_takes

    args = _pairs(n_pairs, Lq, Lt)
    cells = n_pairs * Lq * Lt
    dt = best_seconds(_edit_inner(), *args)
    impl = "pallas" if gpu_kernel_takes(Lq, n_pairs, n_pairs) else "xla"
    return {"impl": impl, "seconds": dt, "gcups": cells / dt / 1e9,
            "cells": cells, "n_pairs": n_pairs, "Lq": Lq, "Lt": Lt}


def bench_correction(n_pairs: int = 4096, Lq: int = 112, band: int = 64,
                     engine: str = "myers") -> Dict:
    """Correction-step alignments/s: DP + traceback + vote scatter, the
    full fused device step of models/correction (cfg.corr_engine).

    engine="myers": planes DP (Pallas kernel on the GPU) + plane-based
    traceback;
    engine="sw": scored dirs wavefront DP + dirs traceback.  Same vote
    buffer, same batch shapes as production (read pad 112, window
    Lq + band + 8).
    """
    import jax
    import jax.numpy as jnp

    from hga_tpu.config import AssemblerConfig
    from hga_tpu.models.correction import _consensus_step_fn
    from hga_tpu.ops import pileup as PU
    from hga_tpu.ops.myers_pallas import gpu_kernel_takes

    cfg = AssemblerConfig(band=band, corr_engine=engine)
    Wt = Lq + band + 8
    nb, Lpad = 8, 4096
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.integers(0, 4, (n_pairs, Lq)).astype(np.int32))
    t = jnp.asarray(rng.integers(0, 4, (n_pairs, Wt)).astype(np.int32))
    ql = jnp.asarray(np.full(n_pairs, Lq, np.int32))
    tl = jnp.asarray(np.full(n_pairs, Wt, np.int32))
    bb = jnp.asarray(rng.integers(0, nb, n_pairs).astype(np.int32))
    off = jnp.asarray(rng.integers(0, Lpad - Wt, n_pairs).astype(np.int32))
    lb = jnp.asarray(np.full(n_pairs, Lpad, np.int32))
    INS = 3
    size_v = nb * Lpad * PU.N_SYM
    step = _consensus_step_fn(cfg, cfg.min_overlap_score, Wt, nb, Lpad, INS)

    m0 = jnp.zeros((size_v + nb * Lpad * INS * 4,), jnp.int32)
    # the step donates its vote buffer, so each call gets a fresh copy
    best = best_seconds(lambda: step(m0.copy(), q, t, ql, tl, bb, off, lb))
    cells = n_pairs * Lq * Wt
    impl = ("pallas" if engine == "myers"
            and gpu_kernel_takes(Lq, n_pairs, n_pairs) else "xla")
    return {"engine": engine, "impl": impl, "seconds": best,
            "aln_per_s": n_pairs / best, "gcups": cells / best / 1e9,
            "n_pairs": n_pairs, "Lq": Lq, "Wt": Wt}


def bench_count(n_reads: int = 8192, read_len: int = 112, k: int = 21) -> Dict:
    """Config-1 counting reads/s (extract + sort-count + histogram)."""
    import jax
    import jax.numpy as jnp

    from hga_tpu.ops import count as C
    from hga_tpu.ops import kmer as K

    rng = np.random.default_rng(0)
    W = read_len // 16
    packed = jnp.asarray(
        rng.integers(0, 2**32, (n_reads, W), dtype=np.uint64).astype(np.uint32))
    bad = jnp.zeros((n_reads, (read_len + 31) // 32), jnp.uint32)
    length = jnp.full((n_reads,), read_len, jnp.int32)

    @jax.jit
    def count(p, b, l):
        kb = K.extract_kmers(p, b, l, k)
        return C.spectrum_histogram(C.count_kmer_batch(kb), 64)

    dt = best_seconds(count, packed, bad, length)
    return {"impl": "xla", "seconds": dt, "reads_per_s": n_reads / dt,
            "kmers_per_s": n_reads * (read_len - k + 1) / dt}


def bench_pipeline(genome_len: int = 20_000, coverage: float = 20.0) -> Dict:
    """Small end-to-end short-read assembly reads/s."""
    from hga_tpu.config import AssemblerConfig
    from hga_tpu.io.encode import pack_reads
    from hga_tpu.models.assembly import assemble
    from hga_tpu.models.overlap import compute_overlaps
    from hga_tpu.models.seeding import find_candidates
    from hga_tpu.utils import sim

    cfg = AssemblerConfig(k=15, w=5, band=32, batch_reads=2048,
                          min_shared_minimizers=2, min_overlap_len=30)
    genome = sim.random_genome(genome_len, seed=0)
    seqs, names = sim.simulate_short_reads(genome, coverage=coverage,
                                           read_len=120, error_rate=0.003,
                                           seed=1)
    pr = pack_reads(seqs, names=names, pad_len=128)
    t0 = time.perf_counter()
    cands = find_candidates(pr, cfg)
    ov = compute_overlaps(pr, cands, cfg)
    res = assemble(pr, ov, cfg)
    dt = time.perf_counter() - t0
    return {"reads": pr.n_reads, "seconds": dt,
            "reads_per_s": pr.n_reads / dt,
            "contigs": len(res.contigs)}


def bench_scaling(n_reads: int = 16384, read_len: int = 112,
                  k: int = 21) -> Dict:
    """Counting-stage reads/s on 1 device vs the mesh of all devices.

    Measures the OWNER-SHARD counting path (spectrum_hist_bucketed:
    all_to_all route + disjoint local counts, per-shard work = total/n).
    On the virtual CPU mesh the "devices" share the same physical cores, so
    the ratio only validates correctness + overhead, never speedup.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hga_tpu.ops import count as C
    from hga_tpu.ops import kmer as K
    from hga_tpu.parallel import collectives as PC
    from hga_tpu.parallel.mesh import make_mesh

    ndev = len(jax.devices())
    rng = np.random.default_rng(0)
    W = read_len // 16
    packed_h = rng.integers(0, 2**32, (n_reads, W), dtype=np.uint64).astype(np.uint32)
    bad_h = np.zeros((n_reads, (read_len + 31) // 32), np.uint32)
    len_h = np.full(n_reads, read_len, np.int32)

    @jax.jit
    def single(p, b, l):
        kb = K.extract_kmers(p, b, l, k)
        ck = C.count_kmer_batch(kb)
        return C.spectrum_histogram(ck, 16)

    dt1 = best_seconds(single, jnp.asarray(packed_h), jnp.asarray(bad_h),
                       jnp.asarray(len_h))
    out = {"devices": ndev, "reads": n_reads,
           "single_reads_per_s": n_reads / dt1}
    if ndev > 1:
        mesh = make_mesh()
        dp = NamedSharding(mesh, P("data"))
        bucket_cap = 2 * (n_reads // ndev) * (read_len - k + 1) // ndev + 64
        args = (jax.device_put(jnp.asarray(packed_h), dp),
                jax.device_put(jnp.asarray(bad_h), dp),
                jax.device_put(jnp.asarray(len_h), dp))

        def sharded(p, b, l):
            hist, _of = PC.spectrum_hist_bucketed(mesh, p, b, l, k,
                                                  bucket_cap, 16)
            return hist

        dtn = best_seconds(sharded, *args)
        out["sharded_reads_per_s"] = n_reads / dtn
        out["scaling_efficiency"] = (dt1 / dtn) / 1.0  # same total work
    return out


def run_benchmark(what: str = "sw", n_pairs: int = 4096) -> Dict:
    if what == "sw":
        out = bench_sw(n_pairs=n_pairs)
    elif what == "myers":
        out = bench_myers(n_pairs=n_pairs)
    elif what == "count":
        out = bench_count()
    elif what == "correction":
        out = {eng: bench_correction(n_pairs=n_pairs, engine=eng)
               for eng in ("myers", "sw")}
    elif what == "pipeline":
        out = bench_pipeline()
    elif what == "scaling":
        out = bench_scaling()
    else:
        raise ValueError(what)
    return {**out, **device_info()}

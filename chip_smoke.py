#!/usr/bin/env python3
"""Hardware smoke test: run the assembler's main path on one CUDA card.

    python3 chip_smoke.py                    # one card, every phase below
    python3 chip_smoke.py --genome-mb 4.6    # the full E. coli-scale genome
    python3 chip_smoke.py --four-cards       # only the 4-card mesh phase

Phases (any failure raises and the script exits non-zero):

1. Device: the JAX backend must be the GPU (a CUDA plugin that fails to
   load leaves JAX on the CPU with only a warning); prints the card's name
   and power limit from nvidia-smi and where the compile cache lives.
2. Kernels: each Pallas Myers kernel, compiled for the card, against the
   plain XLA engine (ops/myers.py) at the pipeline's widths, bit-exact —
   the short-read gate, a W = 24 long segment, and the correction planes
   with the traceback votes they feed.  Times are printed beside XLA's.
3. Pipeline through the CLI: ``hga simulate --fastq`` (repeat-free 1 Mb
   genome by default — cut from 4.6 Mb to keep the whole script well inside
   its time limit on a cold compile cache — 30x 100 bp short reads at 1%
   error, 20x 8 kb long reads at 10% error),
   ``hga pipeline`` from the FASTQ/FASTA files, then ``hga eval`` against
   the simulated genome; asserts one contig at k-mer identity and genome
   fraction >= 0.999 and prints stage seconds and reads/s.
4. ``--four-cards`` (alone): one input (0.2 Mb by default) assembled in
   this one process over a 4-card data mesh and again on one card; the
   polished contigs must be identical.  Prints each card's peak memory.

The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

# the quality bar of phase 3
MIN_IDENTITY = 0.999
MIN_GENOME_FRACTION = 0.999
# the pipeline configuration of the judged-scale runs (exp/scale_run.py):
# k=15/w=5 seeding keeps ~21% of a 10%-error long read's k-mers exact
PIPELINE_CFG = dict(k=15, w=5, band=64, batch_reads=4096,
                    min_shared_minimizers=2, min_overlap_len=500,
                    min_identity=0.75, polish_passes=2,
                    corr_batch_pairs=4096, min_contig_len=2000)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device():
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: JAX backend is {backend!r}, not 'gpu' "
                         "(no CUDA card, or its plugin failed to load)")
    from hga_tpu.utils.compile_cache import enable_compile_cache

    devs = jax.devices()
    log(f"devices: {devs}")
    log(f"device_kind: {devs[0].device_kind} x{len(devs)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for line in smi.splitlines():
        log(f"nvidia-smi: {line}")
    log(f"compile cache: {enable_compile_cache()}")
    return devs


def _same(name, got, ref):
    import numpy as np

    got, ref = np.asarray(got), np.asarray(ref)
    if got.shape != ref.shape or not np.array_equal(got, ref):
        bad = int(np.sum(got != ref)) if got.shape == ref.shape else -1
        raise AssertionError(f"{name}: kernel != XLA ({bad} of {ref.size} "
                             f"values differ, shapes {got.shape} "
                             f"{ref.shape})")
    log(f"  bit-exact: {name} ({ref.size} values)")


def phase_kernels():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hga_tpu.ops import pileup as PU
    from hga_tpu.ops.myers import myers_batch, myers_batch_planes
    from hga_tpu.ops.myers_pallas import (myers_batch_pallas,
                                          myers_batch_planes_pallas)
    from hga_tpu.utils.benchmarks import best_seconds
    from hga_tpu.utils.sim import dp_pairs

    for name, (N, Lq, Lt) in (("gate", (8192, 112, 192)),
                              ("long segment", (4096, 744, 1024))):
        args = [jnp.asarray(x) for x in dp_pairs(N, Lq, Lt)]
        got, ref = myers_batch_pallas(*args), myers_batch(*args)
        log(f"{name}: N={N} Lq={Lq} Lt={Lt}")
        _same(f"{name}.dist", got.dist, ref.dist)
        _same(f"{name}.tend", got.tend, ref.tend)
        tk = best_seconds(myers_batch_pallas, *args)
        tx = best_seconds(myers_batch, *args)
        log(f"  time: pallas {tk * 1e3:.3f} ms, xla {tx * 1e3:.3f} ms "
            f"({N * Lq * Lt / tk / 1e9:.0f} vs {N * Lq * Lt / tx / 1e9:.0f}"
            " GCUPS)")

    N, Lq, Lt = 4096, 112, 184
    q, t, ql, tl = dp_pairs(N, Lq, Lt)
    args = [jnp.asarray(x) for x in (q, t, ql, tl)]
    log(f"planes: N={N} Lq={Lq} Lt={Lt}")
    (rk, pvk, mvk) = myers_batch_planes_pallas(*args)
    (rx, pvx, mvx) = myers_batch_planes(*args)
    _same("planes.dist", rk.dist, rx.dist)
    _same("planes.tend", rk.tend, rx.tend)
    _same("planes.Pv", pvk, pvx)
    _same("planes.Mv", mvk, mvx)
    rng = np.random.default_rng(11)
    nb, lpad, ins = 8, 4096, 3
    size_v = nb * lpad * PU.N_SYM
    size_all = size_v + nb * lpad * ins * 4
    gated = jnp.where(rk.dist <= (0.3 * args[2]).astype(jnp.int32),
                      args[2], 0)
    rest = (rk.dist, gated, rk.tend, args[0], args[1],
            jnp.asarray(rng.integers(0, nb, N).astype(np.int32)),
            jnp.asarray(rng.integers(0, lpad - Lt, N).astype(np.int32)),
            jnp.full((N,), lpad, jnp.int32))
    votes = [np.asarray(PU.accumulate_backbone_votes_myers(
        jnp.zeros((size_all,), jnp.int32), pv, mv, *rest, size_v=size_v,
        lpad=lpad, ins_slots=ins)) for pv, mv in ((pvk, mvk), (pvx, mvx))]
    if votes[1].sum() == 0:
        raise AssertionError("planes: the traceback cast no votes")
    _same("planes.traceback_votes", votes[0], votes[1])
    tk = best_seconds(myers_batch_planes_pallas, *args)
    tx = best_seconds(myers_batch_planes, *args)
    log(f"  time: pallas {tk * 1e3:.3f} ms, xla {tx * 1e3:.3f} ms")


def _cli(argv):
    """Run one `hga` subcommand in this process; returns its JSON output."""
    from hga_tpu import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"hga {argv[0]} exited {rc}")
    lines = [l for l in out.getvalue().splitlines() if l.startswith("{")]
    return json.loads(lines[-1])


def simulate(workdir: str, genome_mb: float) -> dict:
    G = int(genome_mb * 1_000_000)
    t0 = time.perf_counter()
    sim = _cli(["simulate", "-o", workdir, "--genome-len", str(G),
                "--short-cov", "30", "--long-cov", "20", "--short-err",
                "0.01", "--long-err", "0.10", "--seed", "42", "--fastq"])
    log(f"simulate: {sim} in {time.perf_counter() - t0:.1f}s")
    with open(os.path.join(workdir, "config.json"), "w") as fh:
        json.dump(PIPELINE_CFG, fh)
    return sim


def _pipeline_args(workdir: str, outdir: str):
    return ["pipeline", "--short", os.path.join(workdir, "short.fastq"),
            "--long", os.path.join(workdir, "long.fasta"), "--config",
            os.path.join(workdir, "config.json"), "-o", outdir]


def phase_pipeline(workdir: str, genome_mb: float, kind: str):
    sim = simulate(workdir, genome_mb)
    outdir = os.path.join(workdir, "asm")
    t0 = time.perf_counter()
    stats = _cli(_pipeline_args(workdir, outdir))
    wall = time.perf_counter() - t0
    ev = _cli(["eval", "--contigs", os.path.join(outdir, "polished.fasta"),
               "--reference", os.path.join(workdir, "genome.fasta")])
    n_reads = sim["short_reads"] + sim["long_reads"]
    log(f"pipeline on {kind}: genome {genome_mb} Mb, {n_reads} reads, "
        f"hga pipeline {wall:.1f}s wall ({n_reads / wall:.1f} reads/s, "
        "FASTQ parse and compiles included)")
    for name, st in stats.get("stages", {}).items():
        log(f"  stage {name}: {st['seconds']:.1f}s")
    for key in ("correction_detail", "overlaps", "polish_detail",
                "arbitrate_detail"):
        if key in stats:
            log(f"  {key}: {json.dumps(stats[key])}")
    log(f"eval: {json.dumps(ev)}")
    if not (ev["n_contigs"] == 1 and ev["identity"] >= MIN_IDENTITY
            and ev["genome_fraction"] >= MIN_GENOME_FRACTION):
        raise AssertionError(
            f"quality bar missed: want 1 contig, identity >= {MIN_IDENTITY}"
            f", genome fraction >= {MIN_GENOME_FRACTION}; got {ev}")


def phase_four_cards(workdir: str, genome_mb: float):
    import jax

    from hga_tpu.config import AssemblerConfig
    from hga_tpu.io.fastq import iter_records
    from hga_tpu.models.pipeline import load_reads, run_pipeline

    devs = jax.devices()
    if len(devs) != 4:
        raise AssertionError(f"--four-cards needs 4 cards, found {len(devs)}")
    simulate(workdir, genome_mb)
    out4 = os.path.join(workdir, "asm4")
    t0 = time.perf_counter()
    stats = _cli(_pipeline_args(workdir, out4))       # auto mesh: 4 cards
    log(f"4 cards: hga pipeline {time.perf_counter() - t0:.1f}s wall")
    for name, st in stats.get("stages", {}).items():
        log(f"  stage {name}: {st['seconds']:.1f}s")
    for d in devs:
        peak = (d.memory_stats() or {}).get("peak_bytes_in_use", 0)
        log(f"  {d}: peak {peak / 2**30:.2f} GiB")
    with open(os.path.join(workdir, "config.json")) as fh:
        cfg = AssemblerConfig.from_json(fh.read())
    pr_s, pr_l = load_reads([os.path.join(workdir, "short.fastq")],
                            [os.path.join(workdir, "long.fasta")])
    t0 = time.perf_counter()
    one = run_pipeline(pr_s, pr_l, cfg, os.path.join(workdir, "asm1"),
                       mesh=None)
    log(f"1 card: run_pipeline {time.perf_counter() - t0:.1f}s wall")
    four = [(r.name, r.seq) for r in
            iter_records(os.path.join(out4, "polished.fasta"))]
    if [s for _, s in four] != [s for _, s in one.polished]:
        raise AssertionError(
            f"4-card contigs differ from 1-card contigs: "
            f"{[len(s) for _, s in four]} vs "
            f"{[len(s) for _, s in one.polished]}")
    log(f"4-card == 1-card: {len(four)} identical polished contigs "
        f"({sum(len(s) for _, s in four)} bp)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genome-mb", type=float, default=None,
                    help="simulated genome size (default 1.0, or 0.2 with "
                         "--four-cards)")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh phase")
    ap.add_argument("--workdir", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".chip_smoke"),
        help="where the simulated reads and assemblies go")
    args = ap.parse_args(argv)
    if not args.four_cards:
        # one card: expose only the first, so the CLI's automatic mesh
        # over every local card stays the single-device path
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    devs = phase_device()
    os.makedirs(args.workdir, exist_ok=True)
    if args.four_cards:
        phase_four_cards(args.workdir, args.genome_mb or 0.2)
    else:
        phase_kernels()
        phase_pipeline(args.workdir, args.genome_mb or 1.0,
                       devs[0].device_kind)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Re-run overlap + assembly (+ optional polish) from a saved corrected.npz
with the current engine, then evaluate vs the simulated genome.

Usage: python -m exp.reoverlap [rundir] [outdir] [genome_mb] [seed] [--polish]
"""

import json
import logging
import os
import sys
import time

import numpy as np


def main():
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    rundir = args[0] if len(args) > 0 else ".chip_smoke/scale_4.6mb"
    outdir = args[1] if len(args) > 1 else ".chip_smoke/reoverlap"
    gmb = float(args[2]) if len(args) > 2 else 4.6
    seed = int(args[3]) if len(args) > 3 else 42
    do_polish = "--polish" in sys.argv
    os.makedirs(outdir, exist_ok=True)

    from hga_tpu.config import AssemblerConfig
    from hga_tpu.io.encode import PackedReads
    from hga_tpu.models.assembly import assemble
    from hga_tpu.models.overlap_long import compute_overlaps_long
    from hga_tpu.utils import sim
    from hga_tpu.utils.compile_cache import enable_compile_cache
    from hga_tpu.utils.evalx import evaluate_contigs

    enable_compile_cache()
    pr = PackedReads.load(f"{rundir}/corrected.npz")
    genome = sim.random_genome(int(gmb * 1e6), seed=seed)
    cfg = AssemblerConfig(k=15, w=5, band=64, batch_reads=4096,
                          min_shared_minimizers=2, min_overlap_len=500,
                          min_identity=0.75, corr_depth_cap=20,
                          corr_batch_pairs=4096, min_contig_len=2000)

    t0 = time.perf_counter()
    ov = compute_overlaps_long(pr, cfg)
    t_ov = time.perf_counter() - t0
    ov.save(f"{outdir}/overlaps.npz")
    print(f"overlaps: {ov.n} in {t_ov:.0f}s", flush=True)

    t0 = time.perf_counter()
    res = assemble(pr, ov, cfg)
    t_asm = time.perf_counter() - t0
    ev = evaluate_contigs(res.contigs, genome, k=21)
    out = dict(overlap_seconds=round(t_ov, 1), assembly_seconds=round(t_asm, 1),
               n_overlaps=ov.n, **ev)
    print(json.dumps(out, indent=2), flush=True)

    if do_polish:
        from hga_tpu.io.fastq import write_fasta
        from hga_tpu.models.correction import polish_contigs
        from hga_tpu.io.encode import pack_reads

        write_fasta(f"{outdir}/contigs.fasta", res.contigs)
    with open(f"{outdir}/reoverlap_metrics.json", "w") as fh:
        json.dump(out, fh, indent=2)


if __name__ == "__main__":
    main()

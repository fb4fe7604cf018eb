"""Re-polish saved contigs with N passes and evaluate (chip job).

Usage: python -m exp.polish_retry [rundir] [passes] [genome_mb] [seed]
"""

import json
import logging
import sys
import time

import numpy as np


def main():
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    rundir = sys.argv[1] if len(sys.argv) > 1 else ".chip_smoke/scale4_r4"
    passes = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    gmb = float(sys.argv[3]) if len(sys.argv) > 3 else 4.6
    seed = int(sys.argv[4]) if len(sys.argv) > 4 else 42

    from hga_tpu.config import AssemblerConfig
    from hga_tpu.io.encode import pack_reads
    from hga_tpu.io.fastq import iter_records, write_fasta
    from hga_tpu.models.correction import polish_contigs
    from hga_tpu.utils import sim
    from hga_tpu.utils.compile_cache import enable_compile_cache
    from hga_tpu.utils.evalx import evaluate_contigs

    enable_compile_cache()
    genome = sim.random_genome(int(gmb * 1e6), seed=seed)
    ss, sn = sim.simulate_short_reads(genome, coverage=30.0, read_len=100,
                                      error_rate=0.01, seed=seed + 1)
    pr_s = pack_reads(ss, names=sn, pad_len=112)
    del ss
    contigs = [(r.name, r.seq) for r in iter_records(f"{rundir}/contigs.fasta")]
    cfg = AssemblerConfig(k=15, w=5, band=64, batch_reads=4096,
                          min_shared_minimizers=2, min_overlap_len=500,
                          min_identity=0.75, corr_batch_pairs=4096,
                          min_contig_len=2000)
    out = {}
    polished = contigs
    for p in range(passes):
        t0 = time.perf_counter()
        polished = polish_contigs(polished, pr_s, cfg)
        dt = time.perf_counter() - t0
        ev = evaluate_contigs(polished, genome, k=21)
        out[f"pass{p + 1}"] = dict(seconds=round(dt, 1), **ev)
        print(json.dumps(out[f"pass{p + 1}"]), flush=True)
    write_fasta(f"{rundir}/polished.fasta", polished)
    with open(f"{rundir}/polish_retry.json", "w") as fh:
        json.dump(out, fh, indent=2)


if __name__ == "__main__":
    main()

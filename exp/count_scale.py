"""Judged config 1 STANDALONE at scale: k=21 counting + spectrum over the
E. coli-scale Illumina read set (SURVEY.md §7.2 config 1; BASELINE.json
configuration), timed on its own (round-3 verdict item 4).

Usage: python -m exp.count_scale [genome_mb] [out_json]
"""

import json
import os
import sys
import time

import numpy as np


def main():
    gmb = float(sys.argv[1]) if len(sys.argv) > 1 else 4.6
    out_path = (sys.argv[2] if len(sys.argv) > 2
                else ".chip_smoke/count21_metrics.json")
    G = int(gmb * 1_000_000)

    from hga_tpu.config import AssemblerConfig
    from hga_tpu.io.encode import pack_reads
    from hga_tpu.models.spectrum import count_reads
    from hga_tpu.utils import sim
    from hga_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    genome = sim.random_genome(G, seed=42)
    ss, sn = sim.simulate_short_reads(genome, coverage=30.0, read_len=100,
                                      error_rate=0.01, seed=43)
    pr = pack_reads(ss, names=sn, pad_len=112)
    del ss
    cfg = AssemblerConfig(k=21, batch_reads=4096)   # the judged k

    # warm pass loads compiled executables; the timed pass is the number
    t0 = time.perf_counter()
    spec = count_reads(pr, cfg)
    t_warmup = time.perf_counter() - t0
    t0 = time.perf_counter()
    spec = count_reads(pr, cfg)
    t = time.perf_counter() - t0

    out = dict(
        config="judged-1 k-mer count + spectrum",
        k=21, n_reads=pr.n_reads, genome_mb=gmb,
        seconds_warm=round(t, 1), seconds_first=round(t_warmup, 1),
        reads_per_s=round(pr.n_reads / t, 1),
        kmers_per_s=round(pr.n_reads * (100 - 21 + 1) / t, 1),
        distinct_kmers=int(spec.n_distinct),
        solid_threshold=int(spec.threshold),
        genome_kmers_expected=G - 20,
    )
    print(json.dumps(out, indent=2), flush=True)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(out, fh, indent=2)


if __name__ == "__main__":
    main()

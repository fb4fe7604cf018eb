"""Assembly-stage parameter sweep from saved stage artifacts.

Drives ONLY config 4 (graph + unitigs) from a pipeline run's corrected.npz
+ overlaps.npz — the DP stages are not redone — and evaluates each variant
against the known simulated genome, without paying a whole pipeline
re-run per parameter setting.

Usage: python -m exp.asm_sweep [rundir] [genome_mb] [genome_seed]
"""

import json
import sys
import time

import numpy as np


def main():
    rundir = sys.argv[1] if len(sys.argv) > 1 else ".chip_smoke/scale_4.6mb"
    gmb = float(sys.argv[2]) if len(sys.argv) > 2 else 4.6
    seed = int(sys.argv[3]) if len(sys.argv) > 3 else 42

    from hga_tpu.config import AssemblerConfig
    from hga_tpu.io.encode import PackedReads
    from hga_tpu.models.assembly import assemble
    from hga_tpu.models.overlap import OverlapRecords
    from hga_tpu.utils import sim
    from hga_tpu.utils.compile_cache import enable_compile_cache
    from hga_tpu.utils.evalx import evaluate_contigs

    enable_compile_cache()
    pr = PackedReads.load(f"{rundir}/corrected.npz")
    ov = OverlapRecords.load(f"{rundir}/overlaps.npz")
    genome = sim.random_genome(int(gmb * 1e6), seed=seed)
    print(f"{pr.n_reads} reads, {ov.n} overlaps", flush=True)

    # the scale-run base config (exp/scale_run.py)
    base = AssemblerConfig(k=15, w=5, band=64, batch_reads=4096,
                           min_shared_minimizers=2, min_overlap_len=500,
                           min_identity=0.75, corr_depth_cap=20,
                           corr_batch_pairs=4096, min_contig_len=2000)

    variants = [
        ("base", {}),
        ("score0", dict(min_overlap_score=0)),
        ("hang5", dict(hang_frac=0.05)),
        ("hang10", dict(hang_frac=0.10)),
        ("fuzz400", dict(fuzz=400)),
        ("deg32", dict(max_out_degree=32)),
        ("tip6", dict(tip_max_len=6)),
        ("hang10+fuzz400", dict(hang_frac=0.10, fuzz=400)),
        ("hang10+tip6+deg32", dict(hang_frac=0.10, tip_max_len=6,
                                   max_out_degree=32)),
    ]
    for name, kw in variants:
        cfg = base.replace(**kw)
        t0 = time.perf_counter()
        try:
            res = assemble(pr, ov, cfg)
        except Exception as e:
            print(f"{name}: FAILED {e}", flush=True)
            continue
        dt = time.perf_counter() - t0
        ev = evaluate_contigs(res.contigs, genome, k=21)
        print(json.dumps({"variant": name, "seconds": round(dt, 1), **ev}),
              flush=True)


if __name__ == "__main__":
    main()

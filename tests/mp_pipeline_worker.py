"""Worker for the 2-process FULL-PIPELINE partitioning test.

Launched as: python mp_pipeline_worker.py <coordinator> <n_procs> <rank> <outdir>

Each process owns one CPU device; together they form a 2-device global
mesh.  Each runs the production `run_pipeline` on the SAME simulated hybrid
dataset — the host-partitioned paths (parallel/hostpart) must split the
candidate/correction/overlap host work ~half-half per process while the
gathered results (and therefore the contigs) stay identical to a
single-process run (round-2 verdict item 5).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    coordinator, n_procs, rank, outdir = sys.argv[1:5]
    n_procs, rank = int(n_procs), int(rank)

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator, n_procs, rank)
    assert jax.process_count() == n_procs

    from hga_tpu.config import AssemblerConfig
    from hga_tpu.io.encode import pack_reads
    from hga_tpu.models.pipeline import run_pipeline
    from hga_tpu.parallel import hostpart as HP
    from hga_tpu.parallel.mesh import make_mesh
    from hga_tpu.utils import sim

    ds = sim.make_dataset(genome_len=3000, short_cov=25, long_cov=12, seed=5,
                          short_err=0.005, long_err=0.08)
    pr_s = pack_reads(ds.short_seqs, names=ds.short_names, pad_len=128)
    pad = ((max(len(s) for s in ds.long_seqs) + 15) // 16) * 16
    pr_l = pack_reads(ds.long_seqs, names=ds.long_names,
                      category=[1] * len(ds.long_seqs), pad_len=pad)
    cfg = AssemblerConfig(k=15, w=5, band=32, batch_reads=512,
                          min_shared_minimizers=2, min_overlap_len=30)

    mesh = make_mesh()  # global 2-device mesh, one chip per process
    res = run_pipeline(pr_s, pr_l, cfg,
                       os.path.join(outdir, f"run{rank}"), mesh=mesh)

    with open(os.path.join(outdir, f"pipe_rank{rank}.json"), "w") as fh:
        json.dump({"polished": res.polished, "contigs": res.contigs,
                   "work": HP.WORK}, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Worker for the multi-process jax.distributed smoke test.

Launched as: python mp_worker.py <coordinator> <n_procs> <rank> <outdir>
Each process owns one CPU device; together they form a 2-device global mesh.
Computes the sharded global k-mer count of a fixed dataset and writes the
histogram; rank 0 also writes the single-device reference histogram.
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

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hga_tpu.ops import count as C
    from hga_tpu.ops import kmer as K
    from hga_tpu.parallel import collectives as PC
    from hga_tpu.parallel.mesh import make_mesh

    assert jax.device_count() == n_procs, jax.devices()
    k = 15
    rng = np.random.default_rng(7)
    R, W = 64, 4
    packed = rng.integers(0, 2**32, (R, W), dtype=np.uint64).astype(np.uint32)
    bad = np.zeros((R, 2), np.uint32)
    length = np.full(R, 64, np.int32)

    mesh = make_mesh()
    dp = NamedSharding(mesh, P("data"))
    # build the global sharded array from per-process local shards
    shard = slice(rank * R // n_procs, (rank + 1) * R // n_procs)
    g_packed = jax.make_array_from_process_local_data(dp, packed[shard])
    g_bad = jax.make_array_from_process_local_data(dp, bad[shard])
    g_len = jax.make_array_from_process_local_data(dp, length[shard])

    ck = PC.count_kmers_sharded(mesh, g_packed, g_bad, g_len, k,
                                shard_cap=R * 50 // n_procs)
    hist = np.asarray(C.spectrum_histogram(ck, 8)).tolist()

    # --- data-parallel overlap engines over the SAME global mesh ---
    # (the production dispatch path: Myers gate + scored SW per shard)
    from hga_tpu.config import AssemblerConfig
    from hga_tpu.models.overlap import default_edit, default_sw
    from hga_tpu.ops.align import banded_sw_batch
    from hga_tpu.ops.myers import myers_batch

    cfg = AssemblerConfig()
    N, Lq, Lt = 32, 40, 64
    q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (N, Lt)).astype(np.int32)
    ql = np.full(N, Lq, np.int32)
    tl = np.full(N, Lt, np.int32)
    sh = slice(rank * N // n_procs, (rank + 1) * N // n_procs)
    g_q = jax.make_array_from_process_local_data(dp, q[sh])
    g_t = jax.make_array_from_process_local_data(dp, t[sh])
    g_ql = jax.make_array_from_process_local_data(dp, ql[sh])
    g_tl = jax.make_array_from_process_local_data(dp, tl[sh])

    edit = default_edit(cfg, mesh)
    r_e = edit(g_q, g_t, g_ql, g_tl)
    ref_e = myers_batch(jnp.asarray(q), jnp.asarray(t), jnp.asarray(ql),
                        jnp.asarray(tl))
    my_dist = np.concatenate([np.asarray(s.data).ravel()
                              for s in r_e.dist.addressable_shards])
    edit_ok = bool((my_dist == np.asarray(ref_e.dist)[sh]).all())

    sw = default_sw(cfg, mesh)
    r_s = sw(g_q, g_t, g_ql, g_tl, 16)
    ref_s = banded_sw_batch(jnp.asarray(q), jnp.asarray(t), jnp.asarray(ql),
                            jnp.asarray(tl), band=16)
    my_sc = np.concatenate([np.asarray(s.data).ravel()
                            for s in r_s.score.addressable_shards])
    sw_ok = bool((my_sc == np.asarray(ref_s.score)[sh]).all())

    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as fh:
        json.dump({"edit_ok": edit_ok, "sw_ok": sw_ok}, fh)
    if rank == 0:
        kb = K.extract_kmers(jnp.asarray(packed), jnp.asarray(bad),
                             jnp.asarray(length), k)
        ref = np.asarray(
            C.spectrum_histogram(C.count_kmer_batch(kb), 8)).tolist()
        with open(os.path.join(outdir, "result.json"), "w") as fh:
            json.dump({"sharded": hist, "single": ref}, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())

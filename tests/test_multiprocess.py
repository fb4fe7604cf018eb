"""SURVEY.md §5 item 4: jax.distributed multi-process test on localhost.

Two OS processes, one CPU device each, one global mesh: the sharded global
k-mer count must equal the single-process result exactly.  This exercises
the same `jax.distributed.initialize` + global-array path a real multi-host
pod run uses (the reference has no distributed mode at all).
"""

import json
import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_pipeline_partitioned(tmp_path):
    """Round-2 verdict item 5: a 2-process pipeline run must produce contigs
    identical to single-process, with each process doing ~half the host work
    (candidate generation / correction backbones partitioned by ownership)."""
    worker = os.path.join(os.path.dirname(__file__), "mp_pipeline_worker.py")
    coord = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": ""}
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, "2", str(r), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=500)
        outs.append(out.decode(errors="replace"))
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]

    # single-process reference (this test process: virtual 8-dev CPU mesh is
    # irrelevant here — mesh=None forces the plain single-device path)
    from hga_tpu.config import AssemblerConfig
    from hga_tpu.io.encode import pack_reads
    from hga_tpu.models.pipeline import run_pipeline
    from hga_tpu.utils import sim

    ds = sim.make_dataset(genome_len=3000, short_cov=25, long_cov=12, seed=5,
                          short_err=0.005, long_err=0.08)
    pr_s = pack_reads(ds.short_seqs, names=ds.short_names, pad_len=128)
    pad = ((max(len(s) for s in ds.long_seqs) + 15) // 16) * 16
    pr_l = pack_reads(ds.long_seqs, names=ds.long_names,
                      category=[1] * len(ds.long_seqs), pad_len=pad)
    cfg = AssemblerConfig(k=15, w=5, band=32, batch_reads=512,
                          min_shared_minimizers=2, min_overlap_len=30)
    ref = run_pipeline(pr_s, pr_l, cfg, str(tmp_path / "single"), mesh=None)

    ranks = []
    for r in range(2):
        with open(tmp_path / f"pipe_rank{r}.json") as fh:
            ranks.append(json.load(fh))
    ref_polished = [list(t) for t in ref.polished]
    for r in range(2):
        assert ranks[r]["polished"] == ref_polished, (
            r, ranks[r]["polished"][:1], ref_polished[:1])
    # host work split ~half-half: every partitioned counter must sum to the
    # total and neither process may have done more than ~70% of it
    w0, w1 = ranks[0]["work"], ranks[1]["work"]
    assert w0 and w1
    for key in ("corr_backbones", "long_query_reads"):
        tot = w0.get(key, 0) + w1.get(key, 0)
        assert tot > 0, (key, w0, w1)
        assert max(w0.get(key, 0), w1.get(key, 0)) <= 0.7 * tot + 1, (
            key, w0, w1)


def test_two_process_sharded_count(tmp_path):
    worker = os.path.join(os.path.dirname(__file__), "mp_worker.py")
    coord = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": ""}  # one device per process
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, "2", str(r), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=220)
        outs.append(out.decode(errors="replace"))
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-2000:]
    with open(tmp_path / "result.json") as fh:
        res = json.load(fh)
    assert res["sharded"] == res["single"]
    # data-parallel overlap engines (Myers gate + scored SW) must match the
    # single-device kernels shard-for-shard on every process
    for r in range(2):
        with open(tmp_path / f"rank{r}.json") as fh:
            rr = json.load(fh)
        assert rr["edit_ok"] and rr["sw_ok"], (r, rr)

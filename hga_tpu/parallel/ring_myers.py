"""L6 — ring sequence-parallel Myers DP: an ultra-long target split across
devices, with the DP column state handed neighbor-to-neighbor (ppermute).

This is the SP/CP + ring component of SURVEY.md §3.1/§6 ("ultra-long
sequences split across chips with halo exchange ... ring-style neighbor
permute").  The reference processes its longest sequence serially
in one address space; here a target too long (or a pileup backbone too
wide) for one chip's memory is column-sharded over the 'data' axis and the
bit-parallel Myers recurrence streams through the ring:

* The WHOLE inter-chunk dependency of semi-global edit distance is the
  per-query column state (Pv, Mv, score, best, bj) — a few words per query.
  That tuple is the halo; `lax.ppermute` moves it to the next chip after
  each chunk.
* The query batch is cut into blocks_per_dev * n_dev blocks and
  software-pipelined: at ring step s, chip d runs block b = s - d against
  ITS resident target chunk, so after the n_dev-step fill every chip
  computes every step (classic wavefront pipeline, B + n_dev - 1 steps for
  B blocks).  More blocks per device shrink the fill/drain bubble: pipeline
  efficiency is B / (B + n_dev - 1) — 50% at B = n_dev, 67% at 2*n_dev,
  ~89% at 8*n_dev — at the cost of smaller per-step batches.
* Chip n_dev-1 finalizes each block as it drains; a psum replicates the
  (dist, tend) results (all other chips contribute zeros).

Bit-exact vs ops.myers.myers_batch on the unsplit target (tested on the
virtual CPU mesh, SURVEY.md §5.4).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from hga_tpu.parallel.compat import shard_map

from hga_tpu.ops.myers import (I32, MyersResult, myers_cols,
                               myers_init_state, n_words, query_planes)


def myers_ring(mesh: Mesh, q: jax.Array, t: jax.Array, qlen: jax.Array,
               tlen: jax.Array, blocks_per_dev: int = 2) -> MyersResult:
    """Semi-global edit distance with the TARGET column-sharded over the
    mesh's 'data' axis.

    q: int32 (N, Lq); t: int32 (N, Lt) OR (1, Lt) — a single-row target is
    SHARED by every query (the long-context case: thousands of segments
    swept against one megabase-scale sequence whose columns live
    chip-sharded; per-chip HBM is Lt/n_dev instead of N*Lt).  Lt must
    divide n_dev; N must divide blocks_per_dev * n_dev (callers pad queries
    with qlen=0 rows and targets with sentinel columns).  Results
    replicated on every chip.  blocks_per_dev trades fill/drain bubble
    against per-step batch size (see module docstring).
    """
    ndev = mesh.devices.size
    q, t = q.astype(I32), t.astype(I32)     # callers may ship int8 codes
    N, Lq = q.shape
    Nt, Lt = t.shape
    shared_t = Nt == 1
    if not shared_t and Nt != N:
        raise ValueError(f"t rows {Nt} must be 1 (shared) or N={N}")
    B = blocks_per_dev * ndev               # pipeline blocks
    if N % B or Lt % ndev:
        raise ValueError(f"N={N} must divide blocks B={B} and Lt={Lt} "
                         f"must divide n_dev={ndev}")
    NB = N // B             # query block size
    C = Lt // ndev          # target chunk per chip
    W = n_words(Lq)
    q0, q1, vq, mend = query_planes(q, qlen, W)     # (N, W), replicated
    ql = qlen.astype(I32)
    tl = tlen.astype(I32)

    perm = [(i, (i + 1) % ndev) for i in range(ndev)]

    def f(q0, q1, vq, mend, ql, tl, t_sh):
        d = jax.lax.axis_index("data")
        j0 = d * C                                   # my global column base

        def blk(x, b):
            """Rows of query block b (traced), clamped for inactive steps.

            A shared target (one row) is every block's target."""
            if x.shape[0] == 1:
                return x
            start = jnp.clip(b, 0, B - 1) * NB
            return jax.lax.dynamic_slice_in_dim(x, start, NB, axis=0)

        state = myers_init_state(jnp.zeros((NB,), I32), W)
        res_d = jnp.zeros((B, NB), I32)
        res_e = jnp.zeros((B, NB), I32)
        for s in range(B + ndev - 1):
            b = s - d                                # my block this step
            if s < B:
                # chip 0 admits a fresh block into the pipeline
                fresh = myers_init_state(blk(ql, jnp.asarray(s, I32)), W)
                admit = d == 0
                state = tuple(jnp.where(admit, fw, st)
                              for fw, st in zip(fresh, state))
            new_state = myers_cols(blk(q0, b), blk(q1, b), blk(vq, b),
                                   blk(mend, b), blk(t_sh, b), blk(tl, b),
                                   state, j0=j0)
            active = (b >= 0) & (b < B)
            state = tuple(jnp.where(active, ns, st)
                          for ns, st in zip(new_state, state))
            # last chip drains finished blocks into the result buffer
            drain = active & (d == ndev - 1)
            _, _, _, best, bj = state
            qlb = blk(ql, b)
            dist_b = jnp.where(drain & (qlb > 0), best, 0)
            tend_b = jnp.where(drain & (qlb > 0), bj, 0)
            bi = jnp.clip(b, 0, B - 1)
            res_d = jax.lax.dynamic_update_slice_in_dim(
                res_d, jnp.maximum(
                    jax.lax.dynamic_slice_in_dim(res_d, bi, 1, 0),
                    dist_b[None, :] * drain.astype(I32)), bi, axis=0)
            res_e = jax.lax.dynamic_update_slice_in_dim(
                res_e, jnp.maximum(
                    jax.lax.dynamic_slice_in_dim(res_e, bi, 1, 0),
                    tend_b[None, :] * drain.astype(I32)), bi, axis=0)
            state = tuple(jax.lax.ppermute(x, "data", perm) for x in state)
        # only the last chip wrote non-zero rows; psum replicates them
        return (jax.lax.psum(res_d, "data"), jax.lax.psum(res_e, "data"))

    fn = jax.jit(shard_map(
        f, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P(None, "data")),
        out_specs=(P(), P()),
        check_rep=False,
    ))
    rd, re = fn(q0, q1, vq, mend, ql, tl, t.astype(I32))
    return MyersResult(dist=rd.reshape(N), tend=re.reshape(N))

"""L4 device ops — CSR overlap graph + transitive reduction as segment ops.

Device replacement for the reference's pointer-based overlap graph
(SURVEY.md C10, BASELINE.json: "pointer-based overlap graph" becomes "CSR
edge tensors with segment-ops traversal").  Nodes are oriented reads, edges
live in sorted flat tensors; adjacency is (row_ptr, sorted edge list);
transitive reduction is a batched sorted-join: for every edge u->w, the
bounded out-neighborhood of u is cross-checked against the edge set with one
big two-key lookup instead of per-node pointer chasing.

All shapes are static: edge arrays carry a validity mask; invalid edges use
u = n_nodes so they sort to the tail.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

I32 = jnp.int32
IMIN = -(2**31 - 1)


def lookup_sorted(
    set_a: jax.Array, set_b: jax.Array, set_val: jax.Array,
    q_a: jax.Array, q_b: jax.Array,
) -> Tuple[jax.Array, jax.Array]:
    """For each query key (q_a, q_b), find it in the set and return its value.

    Set keys must be unique (callers dedupe).  Returns (found bool, val);
    val is set_val of the match or 0.  Implemented as a tagged sorted merge
    (same pattern as ops.count.member_sorted) — a sort + segment-propagate
    does the join of a two-key binary search.
    """
    S = set_a.shape[0]
    Q = q_a.shape[0]
    a = jnp.concatenate([set_a.astype(I32), q_a.astype(I32)])
    b = jnp.concatenate([set_b.astype(I32), q_b.astype(I32)])
    tag = jnp.concatenate([jnp.zeros((S,), I32), jnp.ones((Q,), I32)])
    val = jnp.concatenate([set_val.astype(I32), jnp.zeros((Q,), I32)])
    orig = jnp.arange(S + Q, dtype=I32)
    a_s, b_s, tag_s, val_s, orig_s = jax.lax.sort(
        (a, b, tag, val, orig), num_keys=3)
    first = jnp.ones((1,), bool)
    diff = (a_s[1:] != a_s[:-1]) | (b_s[1:] != b_s[:-1])
    is_new = jnp.concatenate([first, diff])
    run_id = jnp.cumsum(is_new.astype(I32)) - 1
    # propagate the set element's value through each run
    carrier = jnp.where(tag_s == 0, val_s, IMIN)
    run_val = jnp.full((S + Q,), IMIN, I32).at[run_id].max(carrier)
    has_set = run_val[run_id] != IMIN
    found_sorted = has_set & (tag_s == 1)
    val_sorted = jnp.where(found_sorted, run_val[run_id], 0)
    found = jnp.zeros((S + Q,), bool).at[orig_s].set(found_sorted)
    vals = jnp.zeros((S + Q,), I32).at[orig_s].set(val_sorted)
    return found[S:], vals[S:]


class CSR(NamedTuple):
    """Sorted edge list + row pointers. Invalid edges sit at the tail with
    u == n_nodes."""

    u: jax.Array        # int32 (E,) sorted by (u, length)
    v: jax.Array        # int32 (E,)
    length: jax.Array   # int32 (E,) extension length of the edge
    score: jax.Array    # int32 (E,) overlap score (for tie-breaks/cleaning)
    row_ptr: jax.Array  # int32 (n_nodes+1,)
    deg: jax.Array      # int32 (n_nodes,)
    n_edges: jax.Array  # int32 scalar


@functools.partial(jax.jit, static_argnames=("n_nodes",))
def build_csr(u, v, length, score, valid, n_nodes: int) -> CSR:
    """Sort edges by (u, length, v) and build row pointers via scatter+cumsum."""
    E = u.shape[0]
    u = jnp.where(valid, u.astype(I32), jnp.int32(n_nodes))
    u_s, len_s, v_s, sc_s = jax.lax.sort(
        (u, length.astype(I32), v.astype(I32), score.astype(I32)), num_keys=3)
    deg = jnp.zeros((n_nodes,), I32).at[u_s].add(
        jnp.where(u_s < n_nodes, 1, 0), mode="drop")
    row_ptr = jnp.concatenate([jnp.zeros((1,), I32), jnp.cumsum(deg)])
    return CSR(u=u_s, v=v_s, length=len_s, score=sc_s, row_ptr=row_ptr,
               deg=deg, n_edges=jnp.sum(valid.astype(I32)))


@functools.partial(jax.jit, static_argnames=("n_nodes", "max_out", "fuzz"))
def transitive_reduction(
    csr: CSR, n_nodes: int, max_out: int = 16, fuzz: int = 10
) -> jax.Array:
    """Myers-style reduction mask over a CSR graph (True = keep the edge).

    Edge u->w is reducible iff some 2-path u->v->w satisfies
    len(u->v) + len(v->w) <= len(u->w) + fuzz.  Each edge checks at most
    max_out out-neighbors of u (CSR is length-sorted, so these are the
    shortest — exactly the ones that can satisfy the inequality as long as
    max_out covers the true out-degree; spectra beyond max_out are kept
    conservatively).  One fused two-key lookup per neighbor rank.
    Oracle: utils/oracle.transitive_reduction.
    """
    E = csr.u.shape[0]
    valid = csr.u < n_nodes
    # the edge set for lookups: key (u, v) -> value length (unique per key:
    # callers pre-dedupe parallel edges keeping the shortest)
    reducible = jnp.zeros((E,), bool)
    safe_u = jnp.where(valid, csr.u, 0)
    for r in range(max_out):
        slot = jnp.clip(csr.row_ptr[safe_u] + r, 0, E - 1)
        vr = csr.v[slot]                  # r-th shortest out-neighbor of u
        l_uv = csr.length[slot]
        in_deg = r < csr.deg[safe_u]
        q_a = jnp.where(valid & in_deg, vr, jnp.int32(n_nodes))
        found, l_vw = lookup_sorted(
            jnp.where(valid, csr.u, n_nodes + 1), csr.v, csr.length,
            q_a, csr.v)
        hit = (
            valid & in_deg & found
            & (vr != csr.v)                       # v == w is the edge itself
            & (slot != jnp.arange(E, dtype=I32))  # skip u->w as its own via
            & (l_uv + l_vw <= csr.length + fuzz)
        )
        reducible = reducible | hit
    return valid & ~reducible

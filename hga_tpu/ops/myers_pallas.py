"""L3 — bit-parallel Myers overlap DP as a Pallas kernel for the GPU.

Same semantics as ops.myers.myers_batch (the plain reference, itself
bit-exact vs utils.oracle.edit_distance_hw), laid out for a CUDA card and
lowered through Pallas' Triton route:

* One PAIR per thread: a program owns a 1-D block of ``block`` independent
  pairs.  The Myers recurrence is pure elementwise bitwise/add work, so no
  thread ever talks to another.
* The W query words are unrolled in Python as block-shaped values, and the
  column loop runs inside the kernel (``lax.fori_loop``): Pv/Mv for all W
  words stay in registers for the whole target, where the XLA version pays
  a chain of small (N, W) ops per column.
* The target is stored column-major (Lt, N) as int8, so column j of a block
  is one coalesced load of ``block`` bytes.
* For W > ``RELOAD_WORDS`` the four query planes are re-read from memory
  (L1-resident) every column instead of held in registers: at W = 24 the
  held form needs 144 live words per thread.
* The planes variant stores each column's Pv/Mv words straight to device
  memory in the consumer's (Lt, N, W) layout.

Dispatch (``gpu_kernel_takes``) is by backend and shape alone; on the CPU,
which is only for tests, the XLA engine runs and the kernel is exercised in
interpret mode.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from hga_tpu.ops.myers import M31, MyersResult, n_words, query_planes

I32 = jnp.int32

# W query words are unrolled into the kernel body; cap compile size.
# Queries longer than MAX_WORDS*31 bases run on the XLA engine.
MAX_WORDS = 24
MAX_QUERY_LEN = MAX_WORDS * 31
# Launch settings, chosen by timing every (block, warps, reload) setting on
# an H100 (exp/myers_tune.py; PERF.md): 128-pair blocks won at every shape,
# 4 warps (one pair per thread) for the gate, 2 for the store-bound planes
# variant, and re-reading the query planes won from W = 14 up.
BLOCK = 128          # pairs per program (a power of two)
GATE_WARPS = 4
PLANES_WARPS = 2
RELOAD_WORDS = 8     # above this many words, re-read the query planes


def gpu_kernel_takes(Lq: int, n_target_rows: int, n_pairs: int) -> bool:
    """True iff the edit/planes DP runs on the Pallas kernel.

    The rule: the default backend is the GPU, the query fits MAX_WORDS
    words, and every pair has its own target row.  A shared 1-row target
    (segment-identity sweeps) and longer queries run on ops/myers.py.
    """
    return (jax.default_backend() == "gpu" and n_words(Lq) <= MAX_WORDS
            and n_target_rows == n_pairs)


def _myers_kernel(qlen_ref, tlen_ref, q0_ref, q1_ref, vq_ref, mend_ref,
                  t_ref, dist_ref, tend_ref, *plane_refs, W: int, Lt: int,
                  reload: bool):
    ql = qlen_ref[...]                     # (B,)
    tl = tlen_ref[...]
    zero = ql * 0
    m31 = zero + M31

    def planes_at(w):
        return q0_ref[w, :], q1_ref[w, :], vq_ref[w, :], mend_ref[w, :]

    held = None if reload else [planes_at(w) for w in range(W)]

    def col(j, carry):
        pv = list(carry[0:W])
        mv = list(carry[W:2 * W])
        score, best, bj = carry[2 * W:]
        tc = t_ref[j, :].astype(I32)       # (B,) — one coalesced load
        t0 = -(tc & 1)
        t1 = -((tc >> 1) & 1)
        # full validity compare: any code outside 0..3 never matches
        tvm = -(((tc >= 0) & (tc < 4)).astype(I32))
        cin = zero          # adder carry chain (bit 31 of the block sum)
        cp = zero           # cross-word shift carry for Ph (bit 30)
        cm = zero           # cross-word shift carry for Mh
        pb = zero
        mb = zero
        for w in range(W):
            q0, q1, vq, mend = held[w] if held is not None else planes_at(w)
            eq = (vq & ~((q0 ^ t0) | (q1 ^ t1))) & tvm
            xv = eq | mv[w]
            sw = (eq & pv[w]) + pv[w] + cin
            cin = jax.lax.shift_right_logical(sw, 31) & 1
            xh = ((sw & m31) ^ pv[w]) | eq
            ph = mv[w] | ~(xh | pv[w])
            mh = pv[w] & xh
            pb = pb | (ph & mend)
            mb = mb | (mh & mend)
            ncp = jax.lax.shift_right_logical(ph, 30) & 1
            ncm = jax.lax.shift_right_logical(mh, 30) & 1
            ph = ((ph << 1) & m31) | cp
            mh = ((mh << 1) & m31) | cm
            cp, cm = ncp, ncm
            pv[w] = (mh | ~(xv | ph)) & m31
            mv[w] = ph & xv
            if plane_refs:
                plane_refs[0][j, :, w] = pv[w]
                plane_refs[1][j, :, w] = mv[w]
        score = score + (pb != 0).astype(I32) - (mb != 0).astype(I32)
        take = (score < best) & (j < tl)
        bj = jnp.where(take, j + 1, bj)
        best = jnp.where(take, score, best)
        return tuple(pv) + tuple(mv) + (score, best, bj)

    init = tuple([m31] * W) + tuple([zero] * W) + (ql, ql, zero)
    out = jax.lax.fori_loop(0, Lt, col, init)
    best, bj = out[2 * W + 1], out[2 * W + 2]
    isz = ql == 0
    dist_ref[...] = jnp.where(isz, zero, best)
    tend_ref[...] = jnp.where(isz, zero, bj)


def _block_for(N: int, block: int) -> int:
    return min(block, max(16, 1 << (max(N, 1) - 1).bit_length()))


def _call(q, t, qlen, tlen, *, planes: bool, block: int, num_warps: int,
          reload, interpret: bool):
    N, Lq = q.shape
    Lt = t.shape[1]
    W = n_words(Lq)
    if W > MAX_WORDS:
        raise ValueError(f"Lq={Lq} needs {W} words > {MAX_WORDS}; "
                         "use ops.myers.myers_batch")
    if t.shape[0] != N:
        raise ValueError("the kernel takes one target row per pair")
    B = _block_for(N, block)
    Np = -(-N // B) * B
    pad = Np - N
    q0, q1, vq, mend = query_planes(q, qlen, W)              # (N, W)
    cols = lambda x: jnp.pad(x.T, ((0, 0), (0, pad)))       # (W, Np)
    # int8 column-major target; every invalid code folds to 4 first so the
    # narrowing cannot alias an invalid code onto a base
    tt = t.astype(I32)
    t8 = jnp.where((tt >= 0) & (tt < 4), tt, 4).astype(jnp.int8)
    tT = jnp.pad(t8.T, ((0, 0), (0, pad)), constant_values=4)
    vec = lambda x: jnp.pad(x.astype(I32), (0, pad))

    b1 = pl.BlockSpec((B,), lambda g: (g,))
    bw = pl.BlockSpec((W, B), lambda g: (0, g))
    bt = pl.BlockSpec((Lt, B), lambda g: (0, g))
    out_specs = [b1, b1]
    out_shape = [jax.ShapeDtypeStruct((Np,), I32)] * 2
    if planes:
        out_specs += [pl.BlockSpec((Lt, B, W), lambda g: (0, g, 0))] * 2
        out_shape += [jax.ShapeDtypeStruct((Lt, Np, W), I32)] * 2
    if reload is None:
        reload = W > RELOAD_WORDS
    outs = pl.pallas_call(
        functools.partial(_myers_kernel, W=W, Lt=Lt, reload=bool(reload)),
        grid=(Np // B,),
        in_specs=[b1, b1, bw, bw, bw, bw, bt],
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        # the column loop carries its state in registers: nothing for
        # Triton to software-pipeline, so one stage
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="myers_planes" if planes else "myers_gate",
    )(vec(qlen), vec(tlen), cols(q0), cols(q1), cols(vq), cols(mend), tT)
    res = MyersResult(dist=outs[0][:N], tend=outs[1][:N])
    if not planes:
        return res
    pvp, mvp = outs[2], outs[3]
    if pad:
        pvp, mvp = pvp[:, :N], mvp[:, :N]
    return res, pvp, mvp


_STATIC = ("block", "num_warps", "reload", "interpret")


@functools.partial(jax.jit, static_argnames=_STATIC)
def myers_batch_pallas(q: jax.Array, t: jax.Array, qlen: jax.Array,
                       tlen: jax.Array, block: int = BLOCK,
                       num_warps: int = GATE_WARPS, reload=None,
                       interpret: bool = False) -> MyersResult:
    """Batched bit-parallel semi-global edit distance on the GPU.

    q, t: integer base codes (N, Lq), (N, Lt); codes outside 0..3 never
    match.  N is padded to the block internally.  Bit-exact vs
    ops.myers.myers_batch / oracle.edit_distance_hw.
    """
    return _call(q, t, qlen, tlen, planes=False, block=block,
                 num_warps=num_warps, reload=reload,
                 interpret=interpret)


@functools.partial(jax.jit, static_argnames=_STATIC)
def myers_batch_planes_pallas(q: jax.Array, t: jax.Array, qlen: jax.Array,
                              tlen: jax.Array, block: int = BLOCK,
                              num_warps: int = PLANES_WARPS, reload=None,
                              interpret: bool = False):
    """myers_batch_pallas that also emits per-column Pv/Mv planes.

    Returns (MyersResult, pv_planes, mv_planes) with planes int32
    (Lt, N, W) — bit-exact vs ops.myers.myers_batch_planes.
    """
    return _call(q, t, qlen, tlen, planes=True, block=block,
                 num_warps=num_warps, reload=reload,
                 interpret=interpret)

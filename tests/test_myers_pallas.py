"""Pallas (Triton-route) Myers kernel vs the XLA engine and the numpy oracle.

Interpret mode runs the kernel body on the CPU: same block program, same
padding and layout code as the GPU build, so every bit the kernel computes
is checked here; only what the GPU compiler makes of it is left to
chip_smoke.py on the card.
"""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from hga_tpu.ops import pileup as PU
from hga_tpu.ops.myers import myers_batch, myers_batch_planes, n_words
from hga_tpu.ops.myers_pallas import (MAX_QUERY_LEN, MAX_WORDS,
                                      myers_batch_pallas,
                                      myers_batch_planes_pallas)
from hga_tpu.utils import oracle


def _pairs(rng, N, Lq, Lt, plant=True):
    q = rng.integers(0, 4, (N, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (N, Lt)).astype(np.int32)
    if plant:                           # real overlaps in half the rows
        for n in range(0, N, 2):
            off = int(rng.integers(0, max(1, Lt - Lq)))
            seg = q[n, :Lt - off]
            t[n, off:off + seg.size] = seg
            for _ in range(int(rng.integers(0, 5))):
                p = int(rng.integers(0, min(Lq, Lt - off)))
                t[n, off + p] = (t[n, off + p] + 1) % 4
    ql = rng.integers(0, Lq + 1, N).astype(np.int32)
    tl = rng.integers(1, Lt + 1, N).astype(np.int32)
    return q, t, ql, tl


def _gate(q, t, ql, tl, **kw):
    args = [jnp.asarray(x) for x in (q, t, ql, tl)]
    got = myers_batch_pallas(*args, interpret=True, **kw)
    ref = myers_batch(*args)
    np.testing.assert_array_equal(np.asarray(got.dist), np.asarray(ref.dist))
    np.testing.assert_array_equal(np.asarray(got.tend), np.asarray(ref.tend))
    return got


def _planes(q, t, ql, tl, **kw):
    args = [jnp.asarray(x) for x in (q, t, ql, tl)]
    got = myers_batch_planes_pallas(*args, interpret=True, **kw)
    ref = myers_batch_planes(*args)
    for g, r, name in zip((got[0].dist, got[0].tend, got[1], got[2]),
                          (ref[0].dist, ref[0].tend, ref[1], ref[2]),
                          ("dist", "tend", "Pv", "Mv")):
        assert g.shape == r.shape, name
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r), name)
    return got


def test_gate_matches_xla_and_oracle_multiword():
    rng = np.random.default_rng(0)
    N, Lq, Lt = 64, 100, 160            # W = 4 words
    q, t, ql, tl = _pairs(rng, N, Lq, Lt)
    ql[:5] = [Lq, Lq - 1, 31, 62, 0]    # word-boundary and empty queries
    got = _gate(q, t, ql, tl, block=16)
    for n in (0, 1, 2, 3, 4, 17):
        d, e = oracle.edit_distance_hw(q[n, :ql[n]], t[n, :tl[n]])
        if ql[n] == 0:
            d, e = 0, 0
        assert (int(got.dist[n]), int(got.tend[n])) == (d, e), n


def test_gate_sentinels_never_match():
    rng = np.random.default_rng(1)
    N, Lq, Lt = 32, 40, 64
    q, t, ql, tl = _pairs(rng, N, Lq, Lt)
    t[:, :6] = 4                        # window sentinels
    t[3, 10:20] = 9                     # codes >= 8 must also never match
    t[4, 12:18] = -1                    # negative pads never match
    t[5, 0:40] = 256 + q[5, :40]        # would alias a base if narrowed
    q[6, 5:9] = 4                       # query-side sentinels
    _gate(q, t, ql, tl, block=16)


@pytest.mark.parametrize("N,block", [(1, 16), (40, 16), (300, 128)])
def test_gate_pads_n_to_the_block(N, block):
    """N that is not a multiple of the block: padded pairs are dropped."""
    rng = np.random.default_rng(N)
    q, t, ql, tl = _pairs(rng, N, 62, 96)
    got = _gate(q, t, ql, tl, block=block)
    assert got.dist.shape == (N,)


def test_gate_at_the_word_cap():
    rng = np.random.default_rng(3)
    Lq = MAX_QUERY_LEN                  # W = MAX_WORDS = 24
    assert n_words(Lq) == MAX_WORDS
    q, t, ql, tl = _pairs(rng, 16, Lq, 48, plant=False)
    ql[:3] = [Lq, 31 * 23 + 1, 5]
    _gate(q, t, ql, tl, block=16)


@pytest.mark.parametrize("reload", [False, True])
def test_query_plane_reload_is_exact(reload):
    """Holding the query planes in registers or re-reading them per column
    computes the same bits."""
    rng = np.random.default_rng(4)
    q, t, ql, tl = _pairs(rng, 24, 300, 80)     # W = 10
    _gate(q, t, ql, tl, block=16, reload=reload)


@pytest.mark.parametrize("N,Lq,Lt", [(20, 31, 40), (48, 90, 150),
                                     (16, 744, 24)])
def test_planes_match_xla(N, Lq, Lt):
    rng = np.random.default_rng(Lq)
    q, t, ql, tl = _pairs(rng, N, Lq, Lt)
    t[1, Lt // 3:] = 4
    ql[0] = 0
    _planes(q, t, ql, tl, block=16)


def test_kernel_planes_give_identical_votes():
    """The traceback fed by the kernel's planes casts exactly the votes the
    XLA planes give (the correction hot path end to end)."""
    rng = np.random.default_rng(5)
    N, Lq, Lt = 40, 62, 96
    q, t, ql, tl = _pairs(rng, N, Lq, Lt)
    res, pvp, mvp = _planes(q, t, ql, tl, block=16)
    _, pvx, mvx = myers_batch_planes(*[jnp.asarray(x)
                                       for x in (q, t, ql, tl)])
    nb, lpad, ins = 4, 256, 3
    size_v = nb * lpad * PU.N_SYM
    size_all = size_v + nb * lpad * ins * 4
    args = (res.dist, jnp.asarray(ql), res.tend, jnp.asarray(q),
            jnp.asarray(t),
            jnp.asarray(rng.integers(0, nb, N).astype(np.int32)),
            jnp.asarray(rng.integers(0, lpad - Lt, N).astype(np.int32)),
            jnp.full((N,), lpad, jnp.int32))
    vk = PU.accumulate_backbone_votes_myers(
        jnp.zeros((size_all,), jnp.int32), pvp, mvp, *args, size_v=size_v,
        lpad=lpad, ins_slots=ins)
    vx = PU.accumulate_backbone_votes_myers(
        jnp.zeros((size_all,), jnp.int32), pvx, mvx, *args, size_v=size_v,
        lpad=lpad, ins_slots=ins)
    assert int(np.asarray(vk).sum()) > 0
    np.testing.assert_array_equal(np.asarray(vk), np.asarray(vx))


def test_rejects_queries_past_the_word_cap():
    z = jnp.zeros((4, MAX_QUERY_LEN + 1), jnp.int32)
    l = jnp.ones((4,), jnp.int32)
    with pytest.raises(ValueError, match="words"):
        myers_batch_pallas(z, z, l, l, interpret=True)


def test_rejects_a_shared_target():
    q = jnp.zeros((4, 31), jnp.int32)
    t = jnp.zeros((1, 40), jnp.int32)
    l = jnp.ones((4,), jnp.int32)
    with pytest.raises(ValueError, match="target row per pair"):
        myers_batch_pallas(q, t, l, l, interpret=True)

"""Engine choice by backend and shape, the long-read mode threshold, and the
exact integer query planes the Myers engines share."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from hga_tpu.models import correction as CR
from hga_tpu.models import overlap as OV
from hga_tpu.models.pipeline import LONG_MODE_MIN_PAD, is_long_mode
from hga_tpu.ops import myers_pallas as MP
from hga_tpu.ops.myers import myers_batch, myers_batch_planes, query_planes
from hga_tpu.utils import oracle


@pytest.mark.parametrize("backend,Lq,rows,N,takes", [
    ("gpu", 112, 4096, 4096, True),        # short-read gate / correction
    ("gpu", MP.MAX_QUERY_LEN, 64, 64, True),       # W = 24, the cap
    ("gpu", MP.MAX_QUERY_LEN + 1, 64, 64, False),  # W = 25 -> XLA
    ("gpu", 112, 1, 4096, False),          # shared 1-row target -> XLA
    ("cpu", 112, 4096, 4096, False),       # tests run the XLA engine
    ("rocm", 112, 4096, 4096, False),      # any other backend -> XLA
])
def test_gpu_kernel_takes(monkeypatch, backend, Lq, rows, N, takes):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert MP.gpu_kernel_takes(Lq, rows, N) is takes


def _spy(monkeypatch, name):
    """Replace a kernel entry point by a recorder (nothing compiles)."""
    calls = []

    def fake(q, t, ql, tl):
        calls.append(q.shape)
        return "kernel"

    monkeypatch.setattr(MP, name, fake)
    return calls


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_edit_dispatch_picks_engine_by_backend(monkeypatch, backend):
    calls = _spy(monkeypatch, "myers_batch_pallas")
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    q = jnp.zeros((8, 40), jnp.int8)
    t = jnp.zeros((8, 60), jnp.int8)
    l = jnp.full((8,), 40, jnp.int32)
    out = OV._edit_inner()(q, t, l, l)
    if backend == "gpu":
        assert out == "kernel" and calls == [(8, 40)]
    else:
        assert calls == []
        ref = myers_batch(q.astype(jnp.int32), t.astype(jnp.int32), l, l)
        np.testing.assert_array_equal(np.asarray(out.dist),
                                      np.asarray(ref.dist))


def test_edit_dispatch_keeps_shared_targets_on_xla(monkeypatch):
    calls = _spy(monkeypatch, "myers_batch_pallas")
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    q = jnp.zeros((8, 40), jnp.int32)
    t = jnp.zeros((1, 60), jnp.int32)
    l = jnp.full((8,), 40, jnp.int32)
    OV._edit_inner()(q, t, l, l)
    assert calls == []


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_planes_dispatch_picks_engine_by_backend(monkeypatch, backend):
    calls = _spy(monkeypatch, "myers_batch_planes_pallas")
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    q = jnp.zeros((8, 40), jnp.int32)
    t = jnp.zeros((8, 60), jnp.int32)
    l = jnp.full((8,), 40, jnp.int32)
    out = CR._planes_inner()(q, t, l, l)
    if backend == "gpu":
        assert out == "kernel" and calls == [(8, 40)]
    else:
        assert calls == []
        ref = myers_batch_planes(q, t, l, l)
        np.testing.assert_array_equal(np.asarray(out[1]), np.asarray(ref[1]))


@pytest.mark.parametrize("pad,long_mode", [
    (112, False), (LONG_MODE_MIN_PAD, False), (LONG_MODE_MIN_PAD + 1, True),
    (8192, True)])
def test_long_mode_threshold(pad, long_mode):
    assert LONG_MODE_MIN_PAD == 1024
    assert is_long_mode(pad) is long_mode


def _check_planes(q, ql):
    N, Lq = q.shape
    W = max(1, -(-Lq // 31))
    got = [np.asarray(x) for x in query_planes(jnp.asarray(q),
                                               jnp.asarray(ql), W)]
    for n in range(N):
        ref = oracle.myers_query_planes(q[n], int(ql[n]), W)
        for name, g, r in zip(("q0", "q1", "vq", "mend"), got, ref):
            assert [int(x) for x in g[n]] == r, (name, n)


def test_query_planes_match_oracle_random():
    rng = np.random.default_rng(0)
    q = rng.integers(0, 7, (24, 100)).astype(np.int32)
    ql = rng.integers(0, 101, 24).astype(np.int32)
    _check_planes(q, ql)


@pytest.mark.parametrize("fill,Lq", [(3, 744), (0, 62), (4, 31)])
def test_query_planes_match_oracle_adversarial(fill, Lq):
    """All-ones words (every payload bit set, the sum's largest value),
    all-zero codes, and all-sentinel queries, at word-boundary lengths."""
    q = np.full((5, Lq), fill, np.int32)
    ql = np.array([Lq, Lq - 1, 31, 1, 0], np.int32)
    _check_planes(q, ql)

"""L6: sharded counting + all_to_all routing on the 8-device CPU mesh.

SURVEY.md §5 item 4 — multi-host semantics without a cluster: assert the
sharded merges equal the single-device result exactly.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from hga_tpu.io import pack_reads
from hga_tpu.io.encode import encode_bases
from hga_tpu.ops import count as C
from hga_tpu.ops import kmer as K
from hga_tpu.parallel import collectives as PC
from hga_tpu.parallel.mesh import make_mesh
from hga_tpu.utils import oracle
from hga_tpu.utils.sim import make_dataset

K_ = 21


@pytest.fixture(scope="module")
def dataset():
    ds = make_dataset(genome_len=3000, short_cov=8, long_cov=0, seed=4)
    seqs = ds.short_seqs[: len(ds.short_seqs) // 8 * 8]
    return pack_reads(seqs, pad_len=112), seqs


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_count_kmers_sharded_exact(dataset):
    pr, seqs = dataset
    mesh = make_mesh()
    ck = PC.count_kmers_sharded(
        mesh, jnp.asarray(pr.packed), jnp.asarray(pr.bad),
        jnp.asarray(pr.length), K_, shard_cap=8192)
    n = int(ck.n)
    got = {
        int(oracle.join_hi_lo(h, l)): int(c)
        for h, l, c in zip(np.asarray(ck.hi)[:n], np.asarray(ck.lo)[:n],
                           np.asarray(ck.count)[:n])
    }
    reads = [(encode_bases(s)[0], encode_bases(s)[1], len(s)) for s in seqs]
    assert got == oracle.count_kmers(reads, K_)


def test_route_by_bucket_exact(dataset):
    pr, _ = dataset
    mesh = make_mesh()
    kb = K.extract_kmers(jnp.asarray(pr.packed), jnp.asarray(pr.bad),
                         jnp.asarray(pr.length), K_)
    hi = jnp.where(kb.valid, kb.hi, C.SENTINEL).ravel()
    lo = jnp.where(kb.valid, kb.lo, C.SENTINEL).ravel()
    hi = jax.device_put(hi, NamedSharding(mesh, P("data")))
    lo = jax.device_put(lo, NamedSharding(mesh, P("data")))
    rh, rl, ovf = PC.route_by_bucket(mesh, hi, lo, bucket_cap=2048)
    assert int(ovf) == 0
    rhn, rln = np.asarray(rh), np.asarray(rl)
    SENT = np.uint64(2**64 - 1)
    vin = oracle.join_hi_lo(np.asarray(hi), np.asarray(lo))
    vin = vin[vin != SENT]
    vout = oracle.join_hi_lo(rhn, rln)
    vout = vout[vout != SENT]
    assert sorted(vin.tolist()) == sorted(vout.tolist())
    # owner invariant: shard d only receives k-mers with hash % D == d
    D = 8
    per_hi = rhn.reshape(D, -1)
    per_lo = rln.reshape(D, -1)
    for d in range(D):
        m = ~((per_hi[d] == 0xFFFFFFFF) & (per_lo[d] == 0xFFFFFFFF))
        h32 = oracle.kmer_hash32(oracle.join_hi_lo(per_hi[d][m], per_lo[d][m]))
        assert (h32 % np.uint32(D) == d).all()


def test_route_overflow_detected(dataset):
    pr, _ = dataset
    mesh = make_mesh()
    kb = K.extract_kmers(jnp.asarray(pr.packed), jnp.asarray(pr.bad),
                         jnp.asarray(pr.length), K_)
    hi = jnp.where(kb.valid, kb.hi, C.SENTINEL).ravel()
    lo = jnp.where(kb.valid, kb.lo, C.SENTINEL).ravel()
    hi = jax.device_put(hi, NamedSharding(mesh, P("data")))
    lo = jax.device_put(lo, NamedSharding(mesh, P("data")))
    _, _, ovf = PC.route_by_bucket(mesh, hi, lo, bucket_cap=8)
    assert int(ovf) > 0


def test_bucketed_spectrum_matches_single():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hga_tpu.ops import count as C
    from hga_tpu.ops import kmer as K
    from hga_tpu.parallel import collectives as PC
    from hga_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(devices=jax.devices()[:8])
    rng = np.random.default_rng(31)
    R, W, k = 64, 4, 15
    packed = jnp.asarray(
        rng.integers(0, 2**32, (R, W), dtype=np.uint64).astype(np.uint32))
    bad = jnp.zeros((R, 2), jnp.uint32)
    length = jnp.full((R,), 64, jnp.int32)
    hist, overflow = PC.spectrum_hist_bucketed(
        mesh, packed, bad, length, k, bucket_cap=R * 50 // 8, max_count=8)
    assert int(overflow) == 0
    kb = K.extract_kmers(packed, bad, length, k)
    ref = C.spectrum_histogram(C.count_kmer_batch(kb), 8)
    np.testing.assert_array_equal(np.asarray(hist), np.asarray(ref))

"""L1 device ops — unpack 2-bit reads and extract canonical k-mers.

Device replacement for the reference's rolling C++ `KmerIterator`
(SURVEY.md C2/C3).  Instead of a sequential rolling update per read, the
whole (reads x positions) plane is computed at once from k statically-shifted
views — pure vector ops that XLA fuses into a handful of passes, with no
data-dependent shapes.

A k<=32-mer is carried as a (hi, lo) pair of uint32 (JAX runs without
64-bit integers by default) with lexicographic order equal to uint64
order (oracle: hga_tpu/utils/oracle.py kmer_values / split_hi_lo).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

BASES_PER_WORD = 16
MASK_BITS_PER_WORD = 32

U32 = jnp.uint32


class KmerBatch(NamedTuple):
    """Canonical k-mers of a read batch; all arrays shaped (R, m)."""

    hi: jax.Array      # uint32 — bits 32.. of the canonical k-mer value
    lo: jax.Array      # uint32 — bits 0..31
    strand: jax.Array  # uint8  — 0: forward orientation won, 1: revcomp won
    valid: jax.Array   # bool   — in-range and no ambiguous base in window


def unpack_bases(packed: jax.Array) -> jax.Array:
    """uint32[..., W] -> uint32[..., W*16] 2-bit base codes (LSB-first)."""
    shifts = (2 * jnp.arange(BASES_PER_WORD, dtype=U32))
    out = (packed[..., None] >> shifts) & U32(3)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * BASES_PER_WORD)


def unpack_badmask(bad: jax.Array) -> jax.Array:
    """uint32[..., W] -> int32[..., W*32] ambiguous-base flags (0/1)."""
    shifts = jnp.arange(MASK_BITS_PER_WORD, dtype=U32)
    out = (bad[..., None] >> shifts) & U32(1)
    return out.reshape(*bad.shape[:-1], bad.shape[-1] * MASK_BITS_PER_WORD).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k",))
def extract_kmers(
    packed: jax.Array,   # uint32 (R, W)
    bad: jax.Array,      # uint32 (R, ceil(16W/32))
    length: jax.Array,   # int32 (R,)
    k: int,
) -> KmerBatch:
    """Canonical (hi, lo) k-mers at every position of every read.

    Output arrays have static shape (R, m) with m = 16*W - k + 1; `valid`
    masks positions that run past the true read length or cover an ambiguous
    base.  Matches oracle.kmer_values bit-for-bit.
    """
    if not (1 <= k <= 32):
        raise ValueError("k must be in [1, 32]")
    bases = unpack_bases(packed)          # (R, L) uint32
    R, L = bases.shape
    m = L - k + 1
    if m <= 0:
        raise ValueError(f"pad length {L} shorter than k={k}")

    lo_bits = min(k, 16)                  # bases carried in `lo`

    fwd_hi = jnp.zeros((R, m), U32)
    fwd_lo = jnp.zeros((R, m), U32)
    rc_hi = jnp.zeros((R, m), U32)
    rc_lo = jnp.zeros((R, m), U32)
    for t in range(k):
        b = jax.lax.dynamic_slice_in_dim(bases, t, m, axis=1)
        sh = 2 * (k - 1 - t)              # shift of base t in the fwd value
        if sh >= 32:
            fwd_hi = fwd_hi | (b << U32(sh - 32))
        else:
            fwd_lo = fwd_lo | (b << U32(sh))
        c = U32(3) - b
        shr = 2 * t                       # shift of base t in the rc value
        if shr >= 32:
            rc_hi = rc_hi | (c << U32(shr - 32))
        else:
            rc_lo = rc_lo | (c << U32(shr))

    fwd_le = (fwd_hi < rc_hi) | ((fwd_hi == rc_hi) & (fwd_lo <= rc_lo))
    hi = jnp.where(fwd_le, fwd_hi, rc_hi)
    lo = jnp.where(fwd_le, fwd_lo, rc_lo)
    strand = (~fwd_le).astype(jnp.uint8)

    # validity: window inside the read and free of ambiguous bases
    pos = jnp.arange(m, dtype=jnp.int32)[None, :]
    in_range = pos + k <= length[:, None]
    badbits = unpack_badmask(bad)[:, :L]
    badcum = jnp.cumsum(badbits, axis=1)
    zero = jnp.zeros((R, 1), jnp.int32)
    badcum = jnp.concatenate([zero, badcum], axis=1)  # (R, L+1)
    window_bad = jax.lax.dynamic_slice_in_dim(badcum, k, m, axis=1) - badcum[:, :m]
    valid = in_range & (window_bad == 0)

    return KmerBatch(hi=hi, lo=lo, strand=strand, valid=valid)


def kmer_hash32(hi: jax.Array, lo: jax.Array) -> jax.Array:
    """murmur3 fmix32 of (lo ^ hi*golden) — oracle.kmer_hash32."""
    x = lo ^ (hi * U32(0x9E3779B1))
    x = x ^ (x >> U32(16))
    x = x * U32(0x85EBCA6B)
    x = x ^ (x >> U32(13))
    x = x * U32(0xC2B2AE35)
    x = x ^ (x >> U32(16))
    return x

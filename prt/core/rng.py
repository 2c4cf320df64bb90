"""Counter-based, order-invariant random & quasi-random number generation.

Replaces the reference's single global Mersenne Twister
(/root/reference/core/util.cpp:318-380), whose output depends on call order —
useless on a parallel machine. Here every random decision is a pure function
of integer coordinates (pixel id, sample index, bounce, dimension, stream),
so renders are deterministic, shard-invariant, and resumable.

Two generators:
  * a cheap avalanche hash (PCG-style) for per-lane uniforms — elementwise-friendly
    integer ops, no cross-lane state;
  * the reference's quasi-Monte Carlo point sets: radical inverse, folded
    radical inverse, Van der Corput / Sobol' (0,2)-sequences with Cranley-
    Patterson style scrambling (semantics of core/sampling.h:83-174).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_U32 = jnp.uint32
ONE_MINUS_EPS = jnp.float32(0.9999999403953552)  # largest float < 1


def _mix(x):
    """xxhash/PCG-style 32-bit avalanche; x: uint32 array."""
    x = x.astype(_U32)
    x = x ^ (x >> 16)
    x = x * _U32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * _U32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hash_u32(*counters):
    """Combine integer counters into one well-mixed uint32 per lane."""
    h = _U32(0x9E3779B9)
    for c in counters:
        h = _mix(jnp.asarray(c).astype(_U32) + h)
    return h


def uniform(*counters):
    """f32 uniform in [0,1) keyed purely on the given integer counters."""
    bits = hash_u32(*counters)
    # Take the top 24 bits for an exactly-representable float.
    return jnp.minimum((bits >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24)),
                       ONE_MINUS_EPS)


def uniform2(*counters):
    """Two decorrelated uniforms from one counter set."""
    return uniform(*counters, 0x55AA55AA), uniform(*counters, 0x33CC33CC)


# ---------------------------------------------------------------------------
# Quasi-Monte Carlo point sets (reference core/sampling.h:83-174).
# ---------------------------------------------------------------------------

def radical_inverse(n, base):
    """RadicalInverse(n, base) (core/sampling.h:83-94). n: int array, base: int."""
    n = jnp.asarray(n, jnp.int32)
    inv_base = jnp.float32(1.0 / base)
    val = jnp.zeros(n.shape, jnp.float32)
    inv_bi = jnp.full(n.shape, inv_base)
    # 32/log2(base) digits suffice; unrolled statically.
    ndigits = int(np.ceil(32 / np.log2(base)))
    for _ in range(ndigits):
        d = n % base
        val = val + d.astype(jnp.float32) * inv_bi
        n = n // base
        inv_bi = inv_bi * inv_base
    return val


def _reverse_bits32(n):
    n = n.astype(_U32)
    n = (n << 16) | (n >> 16)
    n = ((n & _U32(0x00FF00FF)) << 8) | ((n & _U32(0xFF00FF00)) >> 8)
    n = ((n & _U32(0x0F0F0F0F)) << 4) | ((n & _U32(0xF0F0F0F0)) >> 4)
    n = ((n & _U32(0x33333333)) << 2) | ((n & _U32(0xCCCCCCCC)) >> 2)
    n = ((n & _U32(0x55555555)) << 1) | ((n & _U32(0xAAAAAAAA)) >> 1)
    return n


def van_der_corput(n, scramble=0):
    """Base-2 radical inverse with bit-XOR scramble (core/sampling.h:131-141)."""
    bits = _reverse_bits32(jnp.asarray(n)) ^ jnp.asarray(scramble).astype(_U32)
    return jnp.minimum(bits.astype(jnp.float32) * jnp.float32(2.3283064365386963e-10),
                       ONE_MINUS_EPS)


def sobol2(n, scramble=0):
    """Second dimension of the Sobol' (0,2)-sequence (core/sampling.h:142-152).

    Implemented via precomputed direction numbers so the whole computation is
    a handful of vector ops instead of a 32-step bit loop per lane.
    """
    n = jnp.asarray(n).astype(_U32)
    v = _SOBOL2_DIRS  # u32[32]
    bit_set = ((n[..., None] >> _BIT_IDX) & _U32(1)).astype(jnp.bool_)
    acc = jnp.where(bit_set, v, _U32(0))
    # XOR-reduce along the last axis.
    out = acc[..., 0]
    for i in range(1, 32):
        out = out ^ acc[..., i]
    out = out ^ jnp.asarray(scramble).astype(_U32)
    return jnp.minimum(out.astype(jnp.float32) * jnp.float32(2.3283064365386963e-10),
                       ONE_MINUS_EPS)


def _make_sobol2_dirs():
    dirs = np.zeros(32, np.uint32)
    v = np.uint32(1 << 31)
    for i in range(32):
        dirs[i] = v
        v ^= v >> 1
    return dirs


_SOBOL2_DIRS = jnp.asarray(_make_sobol2_dirs())
_BIT_IDX = jnp.arange(32, dtype=jnp.uint32)


def sample02(n, scramble_x=0, scramble_y=0):
    """(0,2)-sequence sample: VdC x Sobol' (core/sampling.h:109-117)."""
    return van_der_corput(n, scramble_x), sobol2(n, scramble_y)


def ld_shuffled_1d(sample_idx, pixel_hash, dim):
    """LDShuffleScrambled1D semantics: per-(pixel,dim) scrambled VdC."""
    scr = hash_u32(pixel_hash, dim, 0x1D1D1D1D)
    return van_der_corput(sample_idx, scr)


def ld_shuffled_2d(sample_idx, pixel_hash, dim):
    """LDShuffleScrambled2D semantics: per-(pixel,dim) scrambled (0,2)-seq."""
    sx = hash_u32(pixel_hash, dim, 0x2D2D2D2D)
    sy = hash_u32(pixel_hash, dim, 0x3D3D3D3D)
    return sample02(sample_idx, sx, sy)


# Primes for QMC light/photon sampling (reference integrators/photonmap.cpp
# uses radical-inverse bases 2,3,5,7,11).
PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53)

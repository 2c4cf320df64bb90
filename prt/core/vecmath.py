"""Vector math over stacked ``f32[..., 3]`` arrays.

Replacement for the reference's ``core/geometry.h`` (Vector/Point/
Normal/Ray/BBox classes, /root/reference/core/geometry.h:30-409). Instead of
distinct scalar classes we operate on SoA arrays with a trailing xyz axis, so
every op vectorizes over an arbitrary wavefront of rays/points. Semantics
(dot/cross/normalize, coordinate frames, spherical directions, quadratic
solver) mirror the reference; normals get their inverse-transpose transform in
:mod:`prt.core.transform`.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

# Matches RAY_EPSILON (reference core/pbrt.h:204-212).
RAY_EPSILON = 1e-3
INF = jnp.float32(jnp.inf)


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def absdot(a, b):
    return jnp.abs(dot(a, b))


def cross(a, b):
    return jnp.cross(a, b)


def length_sq(v):
    return jnp.sum(v * v, axis=-1)


def length(v):
    return jnp.sqrt(length_sq(v))


def normalize(v, eps=1e-20):
    """Safe normalize: zero vectors stay zero instead of producing NaN."""
    n2 = jnp.sum(v * v, axis=-1, keepdims=True)
    return v * lax.rsqrt(jnp.maximum(n2, eps))


def distance(a, b):
    return length(a - b)


def distance_sq(a, b):
    return length_sq(a - b)


def lerp(t, a, b):
    return (1.0 - t) * a + t * b


def face_forward(n, v):
    """Flip n so it lies in the same hemisphere as v (core/geometry.h)."""
    s = jnp.where(dot(n, v) < 0.0, -1.0, 1.0)
    return n * s[..., None]


def coordinate_system(v1):
    """Build an orthonormal frame (v1, v2, v3) from a unit vector.

    Mirrors CoordinateSystem (reference core/geometry.h:32-49): branch on the
    larger of |x|,|y| done branchlessly with where.
    """
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    cond = (jnp.abs(x) > jnp.abs(y))[..., None]
    inv_a = lax.rsqrt(jnp.maximum(x * x + z * z, 1e-20))
    inv_b = lax.rsqrt(jnp.maximum(y * y + z * z, 1e-20))
    v2a = jnp.stack([-z * inv_a, jnp.zeros_like(x), x * inv_a], axis=-1)
    v2b = jnp.stack([jnp.zeros_like(x), z * inv_b, -y * inv_b], axis=-1)
    v2 = jnp.where(cond, v2a, v2b)
    v3 = cross(v1, v2)
    return v1, v2, v3


def spherical_direction(sintheta, costheta, phi):
    """SphericalDirection (reference core/geometry.h:370-380)."""
    return jnp.stack(
        [sintheta * jnp.cos(phi), sintheta * jnp.sin(phi), costheta], axis=-1
    )


def spherical_direction_frame(sintheta, costheta, phi, x, y, z):
    """SphericalDirection w.r.t. an explicit frame (core/geometry.h:376-380)."""
    return (
        (sintheta * jnp.cos(phi))[..., None] * x
        + (sintheta * jnp.sin(phi))[..., None] * y
        + costheta[..., None] * z
    )


def spherical_theta(v):
    """SphericalTheta (reference core/geometry.h:381-390)."""
    return jnp.arccos(jnp.clip(v[..., 2], -1.0 + 1e-7, 1.0 - 1e-7))


def spherical_phi(v):
    """SphericalPhi: atan2 remapped to [0, 2pi)."""
    p = jnp.arctan2(v[..., 1], v[..., 0])
    return jnp.where(p < 0.0, p + 2.0 * jnp.pi, p)


def quadratic(a, b, c):
    """Solve a t^2 + b t + c = 0 branchlessly.

    Returns (has_solution, t0, t1) with t0 <= t1. Mirrors the numerically
    stable form of Quadratic (reference core/pbrt.h:622-644).
    """
    disc = b * b - 4.0 * a * c
    ok = disc > 0.0
    # Guarded sqrt: sqrt(0) has a NaN-producing VJP (0 * inf) even on lanes
    # masked by `ok`, which poisons gradients of unrelated parameters.
    root = jnp.sqrt(jnp.where(ok, disc, 1.0))
    q = jnp.where(b < 0.0, -0.5 * (b - root), -0.5 * (b + root))
    # Guard divisions; invalid lanes are masked by `ok` downstream.
    safe = lambda n, d: n / jnp.where(jnp.abs(d) < 1e-30, 1e-30, d)
    t0 = safe(q, a)
    t1 = safe(c, q)
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    return ok, lo, hi


def clamp(x, lo, hi):
    return jnp.clip(x, lo, hi)


def smoothstep(lo, hi, x):
    """SmoothStep (reference core/pbrt.h:660-667)."""
    t = jnp.clip((x - lo) / jnp.where(hi == lo, 1.0, hi - lo), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


# ---------------------------------------------------------------------------
# Axis-aligned bounding boxes: represented as (lo f32[...,3], hi f32[...,3]).
# ---------------------------------------------------------------------------

def bbox_empty():
    return jnp.full((3,), jnp.inf, jnp.float32), jnp.full((3,), -jnp.inf, jnp.float32)


def bbox_union(lo1, hi1, lo2, hi2):
    return jnp.minimum(lo1, lo2), jnp.maximum(hi1, hi2)


def bbox_union_point(lo, hi, p):
    return jnp.minimum(lo, p), jnp.maximum(hi, p)


def bbox_intersect_p(lo, hi, o, d, mint, maxt):
    """Slab test (reference core/geometry.cpp BBox::IntersectP), branchless.

    Returns (hit, t0, t1). Handles d==0 via inf semantics of IEEE division.
    """
    inv = 1.0 / jnp.where(jnp.abs(d) < 1e-30, jnp.where(d < 0, -1e-30, 1e-30), d)
    tnear = (lo - o) * inv
    tfar = (hi - o) * inv
    tmin = jnp.minimum(tnear, tfar)
    tmax = jnp.maximum(tnear, tfar)
    t0 = jnp.maximum(jnp.max(tmin, axis=-1), mint)
    t1 = jnp.minimum(jnp.min(tmax, axis=-1), maxt)
    return t0 <= t1, t0, t1

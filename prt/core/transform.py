"""4x4 transforms as plain ``f32[..., 4, 4]`` arrays.

Replacement for the reference's Transform/Matrix4x4
(/root/reference/core/transform.{h,cpp}, core/pbrt.h:499-539). Instead of an
object caching its inverse, we pass (m, m_inv) pairs or compute inverses at
scene-build time on the host. Factory functions mirror Translate/Scale/
Rotate*/LookAt/Orthographic/Perspective (core/transform.cpp:32-193). Normals
transform by the inverse transpose; handedness flips are detected with the
3x3 determinant (core/transform.cpp SwapsHandedness).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def identity():
    return jnp.eye(4, dtype=jnp.float32)


def compose(a, b):
    """Apply b first, then a (matrix product a @ b)."""
    return a @ b


def inverse(m):
    return jnp.linalg.inv(m)


# The factory functions below return host numpy arrays on purpose: they run
# during scene construction (parser CTM stack), where every tiny device
# op would be a dispatch of its own. Device code receives the finished
# matrices via SceneData jnp tables.
def translate(delta):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(delta, np.float32)
    return m


def scale(sx, sy, sz):
    return np.diag(np.array([sx, sy, sz, 1.0], np.float32))


def rotate_x(deg):
    s, c = np.sin(np.radians(deg)), np.cos(np.radians(deg))
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def rotate_y(deg):
    s, c = np.sin(np.radians(deg)), np.cos(np.radians(deg))
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def rotate_z(deg):
    s, c = np.sin(np.radians(deg)), np.cos(np.radians(deg))
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def rotate(deg, axis):
    """Rodrigues rotation about an arbitrary axis (core/transform.cpp:80-112)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    s, c = np.sin(np.radians(deg)), np.cos(np.radians(deg))
    m = np.eye(4)
    m[0, 0] = a[0] * a[0] + (1.0 - a[0] * a[0]) * c
    m[0, 1] = a[0] * a[1] * (1.0 - c) - a[2] * s
    m[0, 2] = a[0] * a[2] * (1.0 - c) + a[1] * s
    m[1, 0] = a[0] * a[1] * (1.0 - c) + a[2] * s
    m[1, 1] = a[1] * a[1] + (1.0 - a[1] * a[1]) * c
    m[1, 2] = a[1] * a[2] * (1.0 - c) - a[0] * s
    m[2, 0] = a[0] * a[2] * (1.0 - c) - a[1] * s
    m[2, 1] = a[1] * a[2] * (1.0 - c) + a[0] * s
    m[2, 2] = a[2] * a[2] + (1.0 - a[2] * a[2]) * c
    return m.astype(np.float32)


def look_at(pos, look, up):
    """World-from-camera matrix (core/transform.cpp:113-140)."""
    pos = np.asarray(pos, np.float64)
    look = np.asarray(look, np.float64)
    up = np.asarray(up, np.float64)
    d = look - pos
    d = d / np.linalg.norm(d)
    # right = Cross(dir, up) — pbrt-v1's (left-handed-feeling) convention
    # (core/transform.cpp:121-123); v2 flipped it. Matching v1 matters for
    # golden-image parity: the other choice mirrors the image in x.
    right = np.cross(d, up)
    nr = np.linalg.norm(right)
    if nr < 1e-10:
        # Degenerate up ~ dir: pick an arbitrary right.
        right = np.cross(d, np.array([0.0, 1.0, 0.0001]))
        nr = np.linalg.norm(right)
    right = right / nr
    new_up = np.cross(right, d)
    m = np.eye(4)
    m[:3, 0] = right
    m[:3, 1] = new_up
    m[:3, 2] = d
    m[:3, 3] = pos
    return m.astype(np.float32)


def orthographic(znear, zfar):
    """Camera-to-screen orthographic projection (core/transform.cpp:177-181)."""
    m = np.eye(4, dtype=np.float32)
    m[2, 2] = 1.0 / (zfar - znear)
    m[2, 3] = -znear / (zfar - znear)
    return m


def perspective(fov_deg, n, f):
    """Camera-to-screen perspective projection (core/transform.cpp:182-193)."""
    inv_tan = 1.0 / np.tan(np.radians(fov_deg) / 2.0)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = inv_tan
    m[1, 1] = inv_tan
    m[2, 2] = f / (f - n)
    m[2, 3] = -f * n / (f - n)
    m[3, 2] = 1.0
    return m


# ---------------------------------------------------------------------------
# Application. m: f32[..., 4, 4]; p/v/n: f32[..., 3]. Broadcasting works so a
# single matrix can transform a whole wavefront of points.
#
# IMPORTANT: written as explicit component math, NOT einsum/matmul. A
# matrix unit may run a tiny einsum at reduced precision (TF32 on an H100
# unless precision is "highest"; prt/__init__.py) — enough to push ray-hit
# points inside surfaces and cause spurious shadow self-occlusion.
# Componentwise mul/add stays in full float32.
# ---------------------------------------------------------------------------

def apply_point(m, p):
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    rx = m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2] * z + m[..., 0, 3]
    ry = m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2] * z + m[..., 1, 3]
    rz = m[..., 2, 0] * x + m[..., 2, 1] * y + m[..., 2, 2] * z + m[..., 2, 3]
    w = m[..., 3, 0] * x + m[..., 3, 1] * y + m[..., 3, 2] * z + m[..., 3, 3]
    r = jnp.stack([rx, ry, rz], axis=-1)
    return r / jnp.where(jnp.abs(w[..., None]) < 1e-30, 1.0, w[..., None])


def apply_vector(m, v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack([
        m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2] * z,
        m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2] * z,
        m[..., 2, 0] * x + m[..., 2, 1] * y + m[..., 2, 2] * z,
    ], axis=-1)


def apply_normal(m_inv, n):
    """Normals use the inverse transpose: n' = (M^-1)^T n. Pass the INVERSE."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    return jnp.stack([
        m_inv[..., 0, 0] * x + m_inv[..., 1, 0] * y + m_inv[..., 2, 0] * z,
        m_inv[..., 0, 1] * x + m_inv[..., 1, 1] * y + m_inv[..., 2, 1] * z,
        m_inv[..., 0, 2] * x + m_inv[..., 1, 2] * y + m_inv[..., 2, 2] * z,
    ], axis=-1)


def apply_ray(m, o, d):
    return apply_point(m, o), apply_vector(m, d)


# ---------------------------------------------------------------------------
# Per-lane gathered transforms, SoA. Rather than `table[idx]` producing
# f32[N,4,4] and reading m[..., i, j] out of it, materialize the 16 matrix
# components as separate f32[N] arrays: for small tables (the common case —
# scenes have a handful of object transforms) select each scalar over the
# table; for big tables gather one flat [N,16] row and slice columns.
# ---------------------------------------------------------------------------

_SELECT_LIMIT = 16


def row_components(table, idx, limit=_SELECT_LIMIT):
    """table f32[Q,4,4], idx i32[N] -> nested list c[i][j] of f32[N]."""
    q_count = table.shape[0]
    if q_count <= limit:
        comps = []
        for i in range(4):
            row = []
            for j in range(4):
                c = jnp.broadcast_to(table[0, i, j], idx.shape)
                for q in range(1, q_count):
                    c = jnp.where(idx == q, table[q, i, j], c)
                row.append(c)
            comps.append(row)
        return comps
    flat = table.reshape(q_count, 16)[idx]          # [N, 16] single gather
    return [[flat[:, 4 * i + j] for j in range(4)] for i in range(4)]


def rows_apply_point(c, p):
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    rx = c[0][0] * x + c[0][1] * y + c[0][2] * z + c[0][3]
    ry = c[1][0] * x + c[1][1] * y + c[1][2] * z + c[1][3]
    rz = c[2][0] * x + c[2][1] * y + c[2][2] * z + c[2][3]
    w = c[3][0] * x + c[3][1] * y + c[3][2] * z + c[3][3]
    r = jnp.stack([rx, ry, rz], axis=-1)
    return r / jnp.where(jnp.abs(w[..., None]) < 1e-30, 1.0, w[..., None])


def rows_apply_vector(c, v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return jnp.stack([
        c[0][0] * x + c[0][1] * y + c[0][2] * z,
        c[1][0] * x + c[1][1] * y + c[1][2] * z,
        c[2][0] * x + c[2][1] * y + c[2][2] * z,
    ], axis=-1)


def rows_apply_normal(c_inv, n):
    """Normals use the inverse transpose: pass the INVERSE's components."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    return jnp.stack([
        c_inv[0][0] * x + c_inv[1][0] * y + c_inv[2][0] * z,
        c_inv[0][1] * x + c_inv[1][1] * y + c_inv[2][1] * z,
        c_inv[0][2] * x + c_inv[1][2] * y + c_inv[2][2] * z,
    ], axis=-1)


def swaps_handedness(m) -> bool:
    """det of upper-left 3x3 < 0 (core/transform.cpp SwapsHandedness)."""
    return bool(np.linalg.det(np.asarray(m)[:3, :3]) < 0.0)


def has_scale(m) -> bool:
    mm = np.asarray(m)
    for axis in np.eye(3, dtype=np.float32):
        n = np.linalg.norm(mm[:3, :3] @ axis)
        if n < 0.999 or n > 1.001:
            return True
    return False

"""Batched ray-triangle intersection and triangle differential geometry.

Replacement for Triangle::Intersect / GetShadingGeometry
(/root/reference/shapes/trianglemesh.cpp:213-278, :71-133). The edge-cross
("Moller-Trumbore style") test is evaluated for (ray, triangle) pairs as pure
elementwise math; the winning hit's uv-parameterized dpdu/dpdv and barycentric-
interpolated shading normals/tangents match the reference's formulas.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core import vecmath as vm
from ..scene.data import TriangleTable

_BIG = jnp.float32(1e30)


def gather_verts(tri: TriangleTable, tid):
    i = tri.idx[tid]  # [..., 3]
    p0 = tri.verts[i[..., 0]]
    p1 = tri.verts[i[..., 1]]
    p2 = tri.verts[i[..., 2]]
    return p0, p1, p2


def intersect_pairs(p0, p1, p2, o, d, mint, maxt):
    """Core edge test for broadcast-compatible point/ray stacks.

    p0/p1/p2: f32[...,3]; o/d: f32[...,3]; returns (t, b1, b2, valid).
    Mirrors shapes/trianglemesh.cpp:213-278.
    """
    e1 = p1 - p0
    e2 = p2 - p0
    s1 = vm.cross(d, e2)
    div = vm.dot(s1, e1)
    ok = jnp.abs(div) > 1e-12
    inv = 1.0 / jnp.where(ok, div, 1.0)
    s = o - p0
    b1 = vm.dot(s, s1) * inv
    s2 = vm.cross(s, e1)
    b2 = vm.dot(d, s2) * inv
    t = vm.dot(e2, s2) * inv
    valid = ok & (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0) & \
        (t > mint) & (t < maxt)
    return t, b1, b2, valid


def intersect(tri: TriangleTable, o, d, mint, maxt):
    """All-pairs test: o,d f32[N,3] vs T triangles -> (t[N,T], valid[N,T])."""
    p0, p1, p2 = gather_verts(tri, jnp.arange(tri.count))
    t, b1, b2, valid = intersect_pairs(
        p0[None], p1[None], p2[None],
        o[:, None], d[:, None], mint[:, None], maxt[:, None])
    return jnp.where(valid, t, _BIG), valid


def differential_geometry(tri: TriangleTable, tid, o, d, t):
    """Geometric DifferentialGeometry + shading geometry for winning hits.

    Recomputes barycentrics for the selected triangle (cheaper than carrying
    [N,T] intermediates), then builds uv-gradient dpdu/dpdv
    (shapes/trianglemesh.cpp:243-266) and interpolated shading frame
    (shapes/trianglemesh.cpp:71-133).
    """
    p0, p1, p2 = gather_verts(tri, tid)
    _, b1, b2, _ = intersect_pairs(p0, p1, p2, o, d,
                                   jnp.full(t.shape, -_BIG), jnp.full(t.shape, _BIG))
    b0 = 1.0 - b1 - b2
    i = tri.idx[tid]
    uv0 = tri.uv[i[..., 0]]
    uv1 = tri.uv[i[..., 1]]
    uv2 = tri.uv[i[..., 2]]

    p = o + t[..., None] * d
    u = b0 * uv0[..., 0] + b1 * uv1[..., 0] + b2 * uv2[..., 0]
    v = b0 * uv0[..., 1] + b1 * uv1[..., 1] + b2 * uv2[..., 1]

    # Partial derivatives from the uv deltas (2x2 solve).
    du1 = uv0[..., 0] - uv2[..., 0]
    du2 = uv1[..., 0] - uv2[..., 0]
    dv1 = uv0[..., 1] - uv2[..., 1]
    dv2 = uv1[..., 1] - uv2[..., 1]
    dp1 = p0 - p2
    dp2 = p1 - p2
    det = du1 * dv2 - dv1 * du2
    degen = jnp.abs(det) < 1e-12
    invdet = 1.0 / jnp.where(degen, 1.0, det)
    dpdu = (dv2[..., None] * dp1 - dv1[..., None] * dp2) * invdet[..., None]
    dpdv = (-du2[..., None] * dp1 + du1[..., None] * dp2) * invdet[..., None]
    # Degenerate uvs: arbitrary frame around the geometric normal
    # (shapes/trianglemesh.cpp:252-257).
    ng_raw = vm.cross(p1 - p0, p2 - p0)
    _, fu, fv = vm.coordinate_system(vm.normalize(ng_raw))
    dpdu = jnp.where(degen[..., None], fu, dpdu)
    dpdv = jnp.where(degen[..., None], fv, dpdv)

    flip = tri.flip_normal[tid]
    nn = vm.normalize(vm.cross(dpdu, dpdv)) * flip[..., None]

    # Shading geometry: interpolate per-vertex normals/tangents when present.
    has_n = tri.has_normals[tid]
    n0 = tri.normals[i[..., 0]]
    n1 = tri.normals[i[..., 1]]
    n2 = tri.normals[i[..., 2]]
    ns = vm.normalize(b0[..., None] * n0 + b1[..., None] * n1 + b2[..., None] * n2)
    ns = ns * flip[..., None]
    # Keep shading normal in the same hemisphere convention as pbrt: the
    # interpolated normal replaces nn; tangent from ss x ns.
    ns = jnp.where(has_n[..., None], ns, nn)

    has_t = tri.has_tangents[tid]
    t0 = tri.tangents[i[..., 0]]
    t1 = tri.tangents[i[..., 1]]
    t2 = tri.tangents[i[..., 2]]
    ss_interp = vm.normalize(b0[..., None] * t0 + b1[..., None] * t1 + b2[..., None] * t2)
    ss_dflt = vm.normalize(dpdu)
    ss = jnp.where(has_t[..., None], ss_interp, ss_dflt)
    ts = vm.cross(ss, ns)
    ts_len = vm.length(ts)
    ok_ts = ts_len > 1e-6
    ts = jnp.where(ok_ts[..., None], ts / jnp.maximum(ts_len, 1e-12)[..., None],
                   vm.coordinate_system(ns)[1])
    ss = vm.cross(ts, ns)

    # dndu/dndv for shading normals from uv deltas (trianglemesh.cpp:104-123).
    dn1 = n0 - n2
    dn2 = n1 - n2
    dndu = (dv2[..., None] * dn1 - dv1[..., None] * dn2) * invdet[..., None]
    dndv = (-du2[..., None] * dn1 + du1[..., None] * dn2) * invdet[..., None]
    zero = jnp.zeros_like(dndu)
    dndu = jnp.where((degen | ~has_n)[..., None], zero, dndu)
    dndv = jnp.where((degen | ~has_n)[..., None], zero, dndv)

    return dict(p=p, nn=nn, u=u, v=v, dpdu=dpdu, dpdv=dpdv,
                dndu=dndu, dndv=dndv, sn=ns, ss=ss, ts=ts)


def triangle_area(p0, p1, p2):
    return 0.5 * vm.length(vm.cross(p1 - p0, p2 - p0))


def sample_uniform(tri: TriangleTable, tid, u1, u2):
    """Area sampling of a given triangle (shapes/trianglemesh.cpp:336-349)."""
    from ..core import mc
    p0, p1, p2 = gather_verts(tri, tid)
    b0, b1 = mc.uniform_sample_triangle(u1, u2)
    p = b0[..., None] * p0 + b1[..., None] * p1 + (1.0 - b0 - b1)[..., None] * p2
    n = vm.normalize(vm.cross(p1 - p0, p2 - p0)) * tri.flip_normal[tid][..., None]
    return p, n

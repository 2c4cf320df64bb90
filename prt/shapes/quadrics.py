"""Branchless batched ray-quadric intersection.

Replacement for the six quadric Shape plugins
(/root/reference/shapes/{sphere,cylinder,disk,cone,paraboloid,
hyperboloid}.cpp). Instead of one virtual Intersect per object, every quadric
kind reduces to the same pipeline over SoA tables:

    object-space ray -> per-kind (A,B,C) coefficients -> ONE quadratic solve
    -> per-kind z/phi clip masks on both roots -> winning t
    -> per-kind parametric derivatives -> generic Weingarten dndu/dndv.

The disk is the lone linear case and is folded in by masking. All math
follows the reference's object-space formulations (e.g. sphere
shapes/sphere.cpp:102-202) so u/v/dpdu/dpdv/dndu/dndv match exactly.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core import vecmath as vm
from ..core import transform as tf
from ..scene.data import (
    QUADRIC_SPHERE, QUADRIC_CYLINDER, QUADRIC_DISK, QUADRIC_CONE,
    QUADRIC_PARABOLOID, QUADRIC_HYPERBOLOID, QuadricTable,
)

_BIG = jnp.float32(1e30)


def _phi_of(x, y, phimax):
    phi = jnp.arctan2(y, x)
    phi = jnp.where(phi < 0.0, phi + 2.0 * jnp.pi, phi)
    return phi


ALL_QUADRIC_KINDS = (0, 1, 2, 3, 4, 5)


def _coeffs(kind, p, o, d, kinds_present=ALL_QUADRIC_KINDS):
    """Quadratic coefficients (A,B,C) per quadric kind, all computed then
    selected by mask (each is a handful of flops)."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]

    radius = p[..., 0]
    # sphere (shapes/sphere.cpp:96-101)
    A_s = dx * dx + dy * dy + dz * dz
    B_s = 2.0 * (dx * ox + dy * oy + dz * oz)
    C_s = ox * ox + oy * oy + oz * oz - radius * radius
    # cylinder (shapes/cylinder.cpp:68-73)
    A_c = dx * dx + dy * dy
    B_c = 2.0 * (dx * ox + dy * oy)
    C_c = ox * ox + oy * oy - radius * radius
    # disk: linear (h - oz)/dz, encode as A=0,B=dz,C=oz-h
    h_d = p[..., 0]
    A_d = jnp.zeros_like(A_s)
    B_d = dz
    C_d = oz - h_d
    # cone (shapes/cone.cpp:64-73): k=(r/h)^2
    r_co, h_co = p[..., 0], p[..., 1]
    k_co = (r_co / jnp.where(h_co == 0, 1.0, h_co)) ** 2
    A_co = dx * dx + dy * dy - k_co * dz * dz
    B_co = 2.0 * (dx * ox + dy * oy - k_co * dz * (oz - h_co))
    C_co = ox * ox + oy * oy - k_co * (oz - h_co) * (oz - h_co)
    # paraboloid (shapes/paraboloid.cpp:64-72): k = zmax/r^2
    r_pa, zmax_pa = p[..., 0], p[..., 2]
    k_pa = zmax_pa / jnp.where(r_pa == 0, 1.0, r_pa * r_pa)
    A_pa = k_pa * (dx * dx + dy * dy)
    B_pa = 2.0 * k_pa * (dx * ox + dy * oy) - dz
    C_pa = k_pa * (ox * ox + oy * oy) - oz
    # hyperboloid (shapes/hyperboloid.cpp:93-101): implicit a(x^2+y^2)-c z^2=1
    a_h, c_h = p[..., 0], p[..., 1]
    A_h = a_h * (dx * dx + dy * dy) - c_h * dz * dz
    B_h = 2.0 * (a_h * (dx * ox + dy * oy) - c_h * dz * oz)
    C_h = a_h * (ox * ox + oy * oy) - c_h * oz * oz - 1.0

    def sel(vs, vc, vd, vco, vpa, vh):
        table = [(QUADRIC_SPHERE, vs), (QUADRIC_CYLINDER, vc),
                 (QUADRIC_DISK, vd), (QUADRIC_CONE, vco),
                 (QUADRIC_PARABOLOID, vpa), (QUADRIC_HYPERBOLOID, vh)]
        present = [(kt, v) for kt, v in table if kt in kinds_present]
        out = present[0][1]
        for kt, v in present[1:]:
            out = jnp.where(kind == kt, v, out)
        return out

    A = sel(A_s, A_c, A_d, A_co, A_pa, A_h)
    B = sel(B_s, B_c, B_d, B_co, B_pa, B_h)
    C = sel(C_s, C_c, C_d, C_co, C_pa, C_h)
    return A, B, C


def _clip_ok(kind, p, o, d, t, kinds_present=ALL_QUADRIC_KINDS):
    """Per-kind z/phi/radius clip tests of the hit point at parameter t."""
    hit = o + t[..., None] * d
    x, y, z = hit[..., 0], hit[..., 1], hit[..., 2]
    phimax = jnp.where(kind == QUADRIC_DISK, p[..., 3],
              jnp.where(kind == QUADRIC_CONE, p[..., 2],
               jnp.where(kind == QUADRIC_HYPERBOLOID, p[..., 6], p[..., 3])))
    phi = _phi_of(x, y, phimax)
    ok_phi = phi <= phimax + 1e-6

    zmin = p[..., 1]
    zmax = p[..., 2]
    r_disk, ir_disk = p[..., 1], p[..., 2]
    d2 = x * x + y * y
    table = [
        (QUADRIC_SPHERE, (z >= zmin) & (z <= zmax)),
        (QUADRIC_CYLINDER, (z >= zmin) & (z <= zmax)),
        (QUADRIC_DISK, (d2 <= r_disk * r_disk) & (d2 >= ir_disk * ir_disk)),
        (QUADRIC_CONE, (z >= 0.0) & (z <= p[..., 1])),
        (QUADRIC_PARABOLOID, (z >= jnp.minimum(p[..., 1], p[..., 2]))
         & (z <= jnp.maximum(p[..., 1], p[..., 2]))),
        # hyperboloid: z between p1z..p2z stored at 2,5
        (QUADRIC_HYPERBOLOID, (z >= jnp.minimum(p[..., 2], p[..., 5]))
         & (z <= jnp.maximum(p[..., 2], p[..., 5]))),
    ]
    present = [(kt, v) for kt, v in table if kt in kinds_present]
    ok = present[0][1]
    for kt, v in present[1:]:
        ok = jnp.where(kind == kt, v, ok)
    return ok & ok_phi


def intersect(quad: QuadricTable, o, d, mint, maxt):
    """Test a ray wavefront against every quadric.

    o, d: f32[N,3] world-space; mint, maxt: f32[N].
    Returns (t f32[N,Q], valid bool[N,Q]) — per-pair nearest valid hit.
    """
    # Object-space rays: [N,Q,3].
    oo = tf.apply_point(quad.w2o[None, :], o[:, None, :])
    od = tf.apply_vector(quad.w2o[None, :], d[:, None, :])
    kind = quad.kind[None, :]
    p = quad.params[None, :]

    kp = quad.kinds_present or ALL_QUADRIC_KINDS
    A, B, C = _coeffs(kind, p, oo, od, kp)
    is_linear = kind == QUADRIC_DISK
    okq, t0, t1 = vm.quadratic(A, B, C)
    # Disk: single root -C/B, degenerate if |B| ~ 0 (ray parallel to plane).
    t_lin = -C / jnp.where(jnp.abs(B) < 1e-12, 1e-12, B)
    ok_lin = jnp.abs(B) >= 1e-7
    t0 = jnp.where(is_linear, t_lin, t0)
    t1 = jnp.where(is_linear, _BIG, t1)
    okq = jnp.where(is_linear, ok_lin, okq)

    mint_b = mint[:, None]
    maxt_b = maxt[:, None]
    in0 = okq & (t0 > mint_b) & (t0 < maxt_b) & _clip_ok(kind, p, oo, od, t0, kp)
    in1 = okq & (t1 > mint_b) & (t1 < maxt_b) & _clip_ok(kind, p, oo, od, t1, kp)
    t = jnp.where(in0, t0, jnp.where(in1, t1, _BIG))
    valid = in0 | in1
    return t, valid


def intersect_gathered(quad: QuadricTable, qid, o, d, mint, maxt,
                       kinds_present=ALL_QUADRIC_KINDS):
    """Per-lane single-quadric test.

    qid i32[N] row indices; o/d world rays f32[N,3].
    Returns (t f32[N], valid bool[N]) — used by accelerator traversal where
    each lane tests one candidate prim per step. Matrices go through the
    SoA row-component path (transform.py), not gathered [N,4,4] arrays.
    """
    kind = quad.kind[qid]
    params = quad.params[qid]
    w2o_c = tf.row_components(quad.w2o, qid)
    oo = tf.rows_apply_point(w2o_c, o)
    od = tf.rows_apply_vector(w2o_c, d)
    A, B, C = _coeffs(kind, params, oo, od, kinds_present)
    is_linear = kind == QUADRIC_DISK
    okq, t0, t1 = vm.quadratic(A, B, C)
    t_lin = -C / jnp.where(jnp.abs(B) < 1e-12, 1e-12, B)
    ok_lin = jnp.abs(B) >= 1e-7
    t0 = jnp.where(is_linear, t_lin, t0)
    t1 = jnp.where(is_linear, _BIG, t1)
    okq = jnp.where(is_linear, ok_lin, okq)
    in0 = okq & (t0 > mint) & (t0 < maxt) & \
        _clip_ok(kind, params, oo, od, t0, kinds_present)
    in1 = okq & (t1 > mint) & (t1 < maxt) & \
        _clip_ok(kind, params, oo, od, t1, kinds_present)
    t = jnp.where(in0, t0, jnp.where(in1, t1, _BIG))
    return t, in0 | in1


def differential_geometry(quad: QuadricTable, qid, o, d, t):
    """Full DifferentialGeometry for the winning quadric per ray.

    qid: i32[N] (clamped valid index), o/d world-space, t: f32[N].
    Returns dict with p, nn(geometric, flip applied), u, v, dpdu, dpdv,
    dndu, dndv — all world space. Mirrors the per-shape Intersect bodies
    (e.g. shapes/sphere.cpp:145-202) plus the orientation flip
    (core/shape.cpp:49-50).
    """
    g = lambda a: a[qid]
    w2o_c = tf.row_components(quad.w2o, qid)
    o2w_c = tf.row_components(quad.o2w, qid)
    kind = g(quad.kind)
    p = g(quad.params)

    oo = tf.rows_apply_point(w2o_c, o)
    od = tf.rows_apply_vector(w2o_c, d)
    ph = oo + t[..., None] * od  # object-space hit
    x, y, z = ph[..., 0], ph[..., 1], ph[..., 2]

    phimax = jnp.where(kind == QUADRIC_DISK, p[..., 3],
              jnp.where(kind == QUADRIC_CONE, p[..., 2],
               jnp.where(kind == QUADRIC_HYPERBOLOID, p[..., 6], p[..., 3])))
    phi = _phi_of(x, y, phimax)
    u = phi / jnp.where(phimax == 0, 1.0, phimax)

    zeros = jnp.zeros_like(x)
    ones = jnp.ones_like(x)
    kp = quad.kinds_present or ALL_QUADRIC_KINDS
    per_kind = {}  # kind -> (v, dpdu, dpdv, d2pduu, d2pduv, d2pdvv)
    zero3 = jnp.zeros_like(ph)

    if QUADRIC_SPHERE in kp:
        # --- sphere (shapes/sphere.cpp:145-202) ---
        radius = p[..., 0]
        thetamin = p[..., 4]
        thetamax = p[..., 5]
        theta = jnp.arccos(jnp.clip(z / jnp.where(radius == 0, 1.0, radius), -1 + 1e-7, 1 - 1e-7))
        v_sph = (theta - thetamin) / jnp.where(thetamax == thetamin, 1.0, thetamax - thetamin)
        zr = jnp.sqrt(jnp.maximum(x * x + y * y, 1e-12))
        inv_zr = 1.0 / zr
        cphi, sphi = x * inv_zr, y * inv_zr
        dpdu_s = jnp.stack([-phimax * y, phimax * x, zeros], -1)
        dpdv_s = (thetamax - thetamin)[..., None] * jnp.stack(
            [z * cphi, z * sphi, -radius * jnp.sin(theta)], -1)
        d2pduu_s = (-phimax * phimax)[..., None] * jnp.stack([x, y, zeros], -1)
        d2pduv_s = ((thetamax - thetamin) * z * phimax)[..., None] * jnp.stack(
            [-sphi, cphi, zeros], -1)
        d2pdvv_s = (-(thetamax - thetamin) ** 2)[..., None] * ph
        per_kind[QUADRIC_SPHERE] = (v_sph, dpdu_s, dpdv_s, d2pduu_s,
                                    d2pduv_s, d2pdvv_s)

    if QUADRIC_CYLINDER in kp:
        # --- cylinder (shapes/cylinder.cpp:106-136) ---
        zmin, zmax = p[..., 1], p[..., 2]
        v_cyl = (z - zmin) / jnp.where(zmax == zmin, 1.0, zmax - zmin)
        dpdu_c = jnp.stack([-phimax * y, phimax * x, zeros], -1)
        dpdv_c = jnp.stack([zeros, zeros, zmax - zmin], -1)
        d2pduu_c = (-phimax * phimax)[..., None] * jnp.stack([x, y, zeros], -1)
        per_kind[QUADRIC_CYLINDER] = (v_cyl, dpdu_c, dpdv_c, d2pduu_c,
                                      zero3, zero3)

    if QUADRIC_DISK in kp:
        # --- disk (shapes/disk.cpp:92-112): v from radius ---
        r_disk, ir_disk = p[..., 1], p[..., 2]
        dist = jnp.sqrt(jnp.maximum(x * x + y * y, 1e-12))
        v_dsk = 1.0 - (dist - ir_disk) / jnp.where(r_disk == ir_disk, 1.0, r_disk - ir_disk)
        dpdu_d = jnp.stack([-phimax * y, phimax * x, zeros], -1)
        one_m_v = jnp.where(v_dsk >= 1.0, 1.0, 1.0 - v_dsk)
        dpdv_d = jnp.stack([-x / one_m_v, -y / one_m_v, zeros], -1) * \
            ((r_disk - ir_disk) / jnp.where(r_disk == 0, 1.0, r_disk))[..., None]
        per_kind[QUADRIC_DISK] = (v_dsk, dpdu_d, dpdv_d, zero3, zero3, zero3)

    if QUADRIC_CONE in kp:
        # --- cone (shapes/cone.cpp:107-133) ---
        h_co = p[..., 1]
        v_con = z / jnp.where(h_co == 0, 1.0, h_co)
        dpdu_co = jnp.stack([-phimax * y, phimax * x, zeros], -1)
        dpdv_co = jnp.stack([-x / jnp.maximum(1.0 - v_con, 1e-6),
                             -y / jnp.maximum(1.0 - v_con, 1e-6), h_co], -1)
        d2pduu_co = (-phimax * phimax)[..., None] * jnp.stack([x, y, zeros], -1)
        d2pduv_co = (phimax / jnp.maximum(1.0 - v_con, 1e-6))[..., None] * \
            jnp.stack([y, -x, zeros], -1)
        per_kind[QUADRIC_CONE] = (v_con, dpdu_co, dpdv_co, d2pduu_co,
                                  d2pduv_co, zero3)

    if QUADRIC_PARABOLOID in kp:
        # --- paraboloid (shapes/paraboloid.cpp:107-137) ---
        zmin_pa, zmax_pa = p[..., 1], p[..., 2]
        v_par = (z - zmin_pa) / jnp.where(zmax_pa == zmin_pa, 1.0, zmax_pa - zmin_pa)
        dpdu_pa = jnp.stack([-phimax * y, phimax * x, zeros], -1)
        z_safe = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
        dpdv_pa = (zmax_pa - zmin_pa)[..., None] * jnp.stack(
            [x / (2.0 * z_safe), y / (2.0 * z_safe), ones], -1)
        d2pduu_pa = (-phimax * phimax)[..., None] * jnp.stack([x, y, zeros], -1)
        d2pduv_pa = ((zmax_pa - zmin_pa) * phimax)[..., None] * jnp.stack(
            [-y / (2.0 * z_safe), x / (2.0 * z_safe), zeros], -1)
        d2pdvv_pa = (-(zmax_pa - zmin_pa) ** 2 / (4.0 * z_safe * z_safe))[..., None] * \
            jnp.stack([x, y, zeros], -1)
        per_kind[QUADRIC_PARABOLOID] = (v_par, dpdu_pa, dpdv_pa, d2pduu_pa,
                                        d2pduv_pa, d2pdvv_pa)

    if QUADRIC_HYPERBOLOID in kp:
        # --- hyperboloid (shapes/hyperboloid.cpp:128-167) ---
        # params: [a, c, p1z, p1x, p1y, p2z, phimax, _] — builder packing.
        p1z = p[..., 2]
        p2z = p[..., 5]
        v_hyp = (z - p1z) / jnp.where(p2z == p1z, 1.0, p2z - p1z)
        dpdu_h = jnp.stack([-phimax * y, phimax * x, zeros], -1)
        # dpdv as the surface tangent orthogonal to dpdu from the implicit
        # gradient of F = a(x^2+y^2) - c z^2 - 1 (exact surface tangent).
        a_h, c_h = p[..., 0], p[..., 1]
        grad = jnp.stack([2 * a_h * x, 2 * a_h * y, -2 * c_h * z], -1)
        dpdv_h = vm.cross(grad, dpdu_h)
        dpdv_h = vm.normalize(dpdv_h) * jnp.where(
            p2z == p1z, 1.0, jnp.abs(p2z - p1z))[..., None]
        d2pduu_h = (-phimax * phimax)[..., None] * jnp.stack([x, y, zeros], -1)
        per_kind[QUADRIC_HYPERBOLOID] = (v_hyp, dpdu_h, dpdv_h, d2pduu_h,
                                         zero3, zero3)

    items = [(kt, per_kind[kt]) for kt in kp if kt in per_kind]
    v, dpdu, dpdv, d2pduu, d2pduv, d2pdvv = items[0][1]
    for kt, vals in items[1:]:
        m1 = kind == kt
        m3 = m1[..., None]
        v = jnp.where(m1, vals[0], v)
        dpdu = jnp.where(m3, vals[1], dpdu)
        dpdv = jnp.where(m3, vals[2], dpdv)
        d2pduu = jnp.where(m3, vals[3], d2pduu)
        d2pduv = jnp.where(m3, vals[4], d2pduv)
        d2pdvv = jnp.where(m3, vals[5], d2pdvv)

    # Weingarten equations -> dndu/dndv (shapes/sphere.cpp:168-189).
    E = vm.dot(dpdu, dpdu)
    F = vm.dot(dpdu, dpdv)
    G = vm.dot(dpdv, dpdv)
    n_obj = vm.normalize(vm.cross(dpdu, dpdv))
    e = vm.dot(n_obj, d2pduu)
    f = vm.dot(n_obj, d2pduv)
    gg = vm.dot(n_obj, d2pdvv)
    inv_egf2 = 1.0 / jnp.maximum(E * G - F * F, 1e-12)
    dndu = ((f * F - e * G) * inv_egf2)[..., None] * dpdu + \
           ((e * F - f * E) * inv_egf2)[..., None] * dpdv
    dndv = ((gg * F - f * G) * inv_egf2)[..., None] * dpdu + \
           ((f * F - gg * E) * inv_egf2)[..., None] * dpdv

    # To world space; normal via inverse transpose (core/shape.cpp:49-50 flip).
    pw = tf.rows_apply_point(o2w_c, ph)
    dpdu_w = tf.rows_apply_vector(o2w_c, dpdu)
    dpdv_w = tf.rows_apply_vector(o2w_c, dpdv)
    dndu_w = tf.rows_apply_normal(w2o_c, dndu)
    dndv_w = tf.rows_apply_normal(w2o_c, dndv)
    nn = vm.normalize(vm.cross(dpdu_w, dpdv_w))
    flip = g(quad.flip_normal)
    nn = nn * flip[..., None]

    return dict(p=pw, nn=nn, u=u, v=v, dpdu=dpdu_w, dpdv=dpdv_w,
                dndu=dndu_w, dndv=dndv_w)


# ---------------------------------------------------------------------------
# Per-prim unrolled test (small-scene brute-force fast path)
# ---------------------------------------------------------------------------

def intersect_one(quad: QuadricTable, i: int, kind: int, phi_full: bool,
                  z_full: bool, o, d, mint, maxt):
    """Test one STATICALLY-known quadric row against a ray wavefront.

    Unlike `intersect` (which materializes [N,Q] intermediates), this
    traces only row i's kind with
    every array shaped [N] — the fast path `accel/intersect.py` unrolls over
    for small scenes. phi_full / z_full are build-time facts (phimax covers
    2*pi / the z-range clips nothing) that skip the atan2 / z tests.

    Returns (t f32[N], valid bool[N]).
    """
    m = quad.w2o[i]
    oo = tf.apply_point(m, o)
    od = tf.apply_vector(m, d)
    ox, oy, oz = oo[..., 0], oo[..., 1], oo[..., 2]
    dx, dy, dz = od[..., 0], od[..., 1], od[..., 2]
    p = quad.params[i]

    if kind == QUADRIC_DISK:
        # Linear: t = (h - oz) / dz (shapes/disk.cpp:57-80).
        h = p[0]
        ok = jnp.abs(dz) >= 1e-7
        t = (h - oz) / jnp.where(ok, dz, 1.0)
        valid = ok & (t > mint) & (t < maxt)
        x = ox + t * dx
        y = oy + t * dy
        d2 = x * x + y * y
        valid = valid & (d2 <= p[1] * p[1]) & (d2 >= p[2] * p[2])
        if not phi_full:
            phi = _phi_of(x, y, p[3])
            valid = valid & (phi <= p[3] + 1e-6)
        return jnp.where(valid, t, _BIG), valid

    if kind == QUADRIC_SPHERE:
        radius = p[0]
        A = dx * dx + dy * dy + dz * dz
        B = 2.0 * (dx * ox + dy * oy + dz * oz)
        C = ox * ox + oy * oy + oz * oz - radius * radius
    elif kind == QUADRIC_CYLINDER:
        radius = p[0]
        A = dx * dx + dy * dy
        B = 2.0 * (dx * ox + dy * oy)
        C = ox * ox + oy * oy - radius * radius
    elif kind == QUADRIC_CONE:
        r_co, h_co = p[0], p[1]
        k_co = (r_co / jnp.where(h_co == 0, 1.0, h_co)) ** 2
        A = dx * dx + dy * dy - k_co * dz * dz
        B = 2.0 * (dx * ox + dy * oy - k_co * dz * (oz - h_co))
        C = ox * ox + oy * oy - k_co * (oz - h_co) * (oz - h_co)
    elif kind == QUADRIC_PARABOLOID:
        r_pa, zmax_pa = p[0], p[2]
        k_pa = zmax_pa / jnp.where(r_pa == 0, 1.0, r_pa * r_pa)
        A = k_pa * (dx * dx + dy * dy)
        B = 2.0 * k_pa * (dx * ox + dy * oy) - dz
        C = k_pa * (ox * ox + oy * oy) - oz
    else:  # QUADRIC_HYPERBOLOID
        a_h, c_h = p[0], p[1]
        A = a_h * (dx * dx + dy * dy) - c_h * dz * dz
        B = 2.0 * (a_h * (dx * ox + dy * oy) - c_h * dz * oz)
        C = a_h * (ox * ox + oy * oy) - c_h * oz * oz - 1.0

    okq, t0, t1 = vm.quadratic(A, B, C)

    def root_ok(t):
        ok = okq & (t > mint) & (t < maxt)
        if phi_full and z_full:
            return ok
        x = ox + t * dx
        y = oy + t * dy
        z = oz + t * dz
        if not z_full:
            if kind in (QUADRIC_SPHERE, QUADRIC_CYLINDER):
                ok = ok & (z >= p[1]) & (z <= p[2])
            elif kind == QUADRIC_CONE:
                ok = ok & (z >= 0.0) & (z <= p[1])
            elif kind == QUADRIC_PARABOLOID:
                ok = ok & (z >= jnp.minimum(p[1], p[2])) & \
                    (z <= jnp.maximum(p[1], p[2]))
            else:
                ok = ok & (z >= jnp.minimum(p[2], p[5])) & \
                    (z <= jnp.maximum(p[2], p[5]))
        if not phi_full:
            phimax = p[2] if kind == QUADRIC_CONE else \
                (p[6] if kind == QUADRIC_HYPERBOLOID else p[3])
            phi = _phi_of(x, y, phimax)
            ok = ok & (phi <= phimax + 1e-6)
        return ok

    in0 = root_ok(t0)
    in1 = root_ok(t1)
    t = jnp.where(in0, t0, jnp.where(in1, t1, _BIG))
    return t, in0 | in1

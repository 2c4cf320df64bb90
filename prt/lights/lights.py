"""Branchless batched light sampling.

Replacement for /root/reference/lights/*.cpp + the Light
interface (core/light.h). Per-lane light ids index the SoA LightTable; every
light kind's sample is computed masked and selected. Semantics preserved:

  * point I/r^2 (lights/point.cpp:55-77),
  * spot falloff ((cos-cw)/(cf-cw))^4 (lights/spot.cpp:67-78),
  * distant (lights/distant.cpp:61-75),
  * projection (perspective-projected map, lights/projection.cpp:100-113),
  * goniometric (direction map, lights/goniometric.cpp),
  * area lights: triangle-set CDF sampling (core/shape.h ShapeSet) and
    sphere cone sampling (shapes/sphere.cpp:45-79), solid-angle pdf
    dist^2/(|cos| area) (core/shape.h:96-107),
  * infinite: cosine-weighted about the normal with hemisphere flip and
    pdf |cos|/2pi (lights/infinite.cpp:96-120), env-map radiance by
    spherical direction.

`sample` returns the radiance, direction, pdf, and a visibility segment the
integrator must test (the reference's VisibilityTester, core/light.h:76-87).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core import mc, spectrum as spec, transform as tf, vecmath as vm
from ..core.vecmath import RAY_EPSILON
from ..scene.data import (
    AREA_GEOM_INST, AREA_GEOM_QUADRIC, AREA_GEOM_TRIS, LIGHT_AREA,
    LIGHT_DISTANT,
    LIGHT_GONIOMETRIC, LIGHT_INFINITE, LIGHT_POINT, LIGHT_PROJECTION,
    LIGHT_SPOT, SceneData,
)
from ..shapes import triangle as tri_mod
from ..textures.graph import mipmap_lookup_tri

_BIG = jnp.float32(1e30)


def is_delta(kind):
    return (kind == LIGHT_POINT) | (kind == LIGHT_SPOT) | \
           (kind == LIGHT_DISTANT) | (kind == LIGHT_PROJECTION) | \
           (kind == LIGHT_GONIOMETRIC)


def env_radiance(scene: SceneData, light_id, d_world):
    """Sum over static infinite lights matching light_id: Lbase * map."""
    L = jnp.zeros(d_world.shape[:-1] + (3,), jnp.float32)
    lights = scene.lights
    for (lid, img, _importance) in lights.infinite_meta:
        base = lights.spectrum[lid]
        wl = vm.normalize(tf.apply_vector(lights.w2l[lid], d_world))
        val = base
        if img >= 0:
            s = vm.spherical_phi(wl) * jnp.float32(0.5 / jnp.pi)
            t = vm.spherical_theta(wl) * jnp.float32(1.0 / jnp.pi)
            tex = mipmap_lookup_tri(scene.images[img].levels, s, t,
                                    jnp.zeros_like(s),
                                    scene.images[img].wrap)
            val = base * tex
        else:
            val = jnp.broadcast_to(base, L.shape)
        L = jnp.where((light_id == lid)[..., None], val, L)
    return L


def le_escaped(scene: SceneData, d_world):
    """Sum of Le over all infinite lights for escaped rays
    (core/light.h Le default + lights/infinite.cpp:83-95)."""
    L = jnp.zeros(d_world.shape[:-1] + (3,), jnp.float32)
    lights = scene.lights
    for (lid, img, _importance) in lights.infinite_meta:
        base = lights.spectrum[lid]
        wl = vm.normalize(tf.apply_vector(lights.w2l[lid], d_world))
        if img >= 0:
            s = vm.spherical_phi(wl) * jnp.float32(0.5 / jnp.pi)
            t = vm.spherical_theta(wl) * jnp.float32(1.0 / jnp.pi)
            tex = mipmap_lookup_tri(scene.images[img].levels, s, t,
                                    jnp.zeros_like(s),
                                    scene.images[img].wrap)
            L = L + base * tex
        else:
            L = L + base
    return L


def _projection_factor(scene: SceneData, light_id, w_world):
    """Projection/goniometric direction-dependent factor (masked, env maps
    unrolled over the static image list as needed)."""
    lights = scene.lights
    g = lambda a: a[light_id]
    kind = g(lights.kind)
    # SoA matrix components rather than a gathered [N,4,4].
    wl = tf.rows_apply_vector(tf.row_components(lights.w2l, light_id),
                              w_world)
    fac = jnp.ones(w_world.shape[:-1] + (3,), jnp.float32)

    # Spot falloff (lights/spot.cpp:67-78); params: [cosTotalWidth, cosFalloff]
    wln = vm.normalize(wl)
    costheta = wln[..., 2]
    cw = g(lights.params)[..., 0]
    cf = g(lights.params)[..., 1]
    delta = jnp.clip((costheta - cw) / jnp.maximum(cf - cw, 1e-8), 0.0, 1.0)
    fall = jnp.where(costheta < cw, 0.0,
                     jnp.where(costheta > cf, 1.0, delta ** 4))
    fac = jnp.where((kind == LIGHT_SPOT)[..., None], fall[..., None], fac)

    # Projection (lights/projection.cpp:100-113); params:
    # [p00, p11, p22, p23, x0, x1, y0, y1] of the projection matrix+screen.
    p = g(lights.params)
    zl = wln[..., 2]
    ok_z = zl >= RAY_EPSILON
    inv_z = 1.0 / jnp.where(ok_z, zl, 1.0)
    # Perspective projection: x' = p00*x/z, y' = p11*y/z.
    xs = p[..., 0] * wln[..., 0] * inv_z
    ys = p[..., 1] * wln[..., 1] * inv_z
    inside = ok_z & (xs >= p[..., 4]) & (xs <= p[..., 5]) & \
        (ys >= p[..., 6]) & (ys <= p[..., 7])
    proj = jnp.where(inside, 1.0, 0.0)
    fac = jnp.where((kind == LIGHT_PROJECTION)[..., None],
                    proj[..., None], fac)

    # Image maps for projection (s,t from screen coords) and goniometric
    # (spherical coords of wl), unrolled over the static dir_map_meta roster.
    for (lid, img) in lights.dir_map_meta:
        # Projection maps use screen coords; gonio uses spherical.
        s_p = (xs - p[..., 4]) / jnp.maximum(p[..., 5] - p[..., 4], 1e-8)
        t_p = (ys - p[..., 6]) / jnp.maximum(p[..., 7] - p[..., 6], 1e-8)
        s_g = vm.spherical_phi(wln) * jnp.float32(0.5 / jnp.pi)
        t_g = vm.spherical_theta(wln) * jnp.float32(1.0 / jnp.pi)
        is_proj = kind == LIGHT_PROJECTION
        s = jnp.where(is_proj, s_p, s_g)
        t = jnp.where(is_proj, t_p, t_g)
        tex = mipmap_lookup_tri(scene.images[img].levels, s, t,
                                jnp.zeros_like(s), scene.images[img].wrap)
        fac = jnp.where((light_id == lid)[..., None], fac * tex, fac)
    return fac


def _sample_area_tris(scene: SceneData, light_id, p, u1, u2, u3):
    """ShapeSet triangle pick by area CDF + uniform triangle sample."""
    lights = scene.lights
    g = lambda a: a[light_id]
    off = g(lights.cdf_offset)
    cnt = g(lights.area_count)
    # Binary search the packed CDF segment [off, off+cnt] for u3.
    lo = jnp.zeros_like(off)
    hi = jnp.maximum(cnt - 1, 0)
    import math
    steps = max(1, int(math.ceil(math.log2(max(scene.lights.max_area_count, 2)))) + 1)
    for _ in range(steps):
        mid = (lo + hi) // 2
        cdf_mid = scene.lights.area_cdf[off + mid + 1]
        go_right = u3 > cdf_mid
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
    tid = g(lights.area_first) + jnp.clip(lo, 0, jnp.maximum(cnt - 1, 0))
    ps, ns = tri_mod.sample_uniform(scene.triangles, tid, u1, u2)
    return ps, ns


def _sample_area_inst(scene: SceneData, light_id, u1, u2, u3):
    """ShapeSet sampling for AREA_GEOM_INST lights: CDF-pick a prototype
    triangle (object space, SHARED across instances), uniform-sample it,
    transform by the light's l2w — which IS the instance transform
    (similarity, so the object-space area CDF stays correct)."""
    import math
    from ..core import transform as tfm
    lights = scene.lights
    inst = scene.instances
    g = lambda a: a[light_id]
    off = g(lights.cdf_offset)
    cnt = g(lights.area_count)
    lo = jnp.zeros_like(off)
    hi = jnp.maximum(cnt - 1, 0)
    steps = max(1, int(math.ceil(math.log2(
        max(lights.max_area_count, 2)))) + 1)
    for _ in range(steps):
        mid = (lo + hi) // 2
        cdf_mid = lights.area_cdf[off + mid + 1]
        go_right = u3 > cdf_mid
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
    tid = g(lights.area_first) + jnp.clip(lo, 0, jnp.maximum(cnt - 1, 0))
    i3 = inst.idx[tid]
    p0 = inst.verts[i3[..., 0]]
    p1 = inst.verts[i3[..., 1]]
    p2 = inst.verts[i3[..., 2]]
    b0, b1 = mc.uniform_sample_triangle(u1, u2)
    ps_o = (b0[..., None] * p0 + b1[..., None] * p1 +
            (1.0 - b0 - b1)[..., None] * p2)
    ns_o = vm.normalize(vm.cross(p1 - p0, p2 - p0)) * \
        inst.flip_normal[tid][..., None]
    l2w_c = tfm.row_components(lights.l2w, light_id)
    w2l_c = tfm.row_components(lights.w2l, light_id)
    ps = tfm.rows_apply_point(l2w_c, ps_o)
    # params[5] = sign(det l2w): mirror instances swap orientation.
    sign = g(lights.params)[..., 5]
    ns = vm.normalize(tfm.rows_apply_normal(w2l_c, ns_o)) * sign[..., None]
    return ps, ns


def sample(scene: SceneData, light_id, p, n, u1, u2, u3):
    """Light::Sample_L(p, n, u1, u2, ...) for a wavefront.

    Returns dict(Li, wi, pdf, delta, vis_o, vis_d, vis_maxt) — visibility is
    a segment/ray the caller must test for occlusion.
    """
    lights = scene.lights
    g = lambda a: a[light_id]
    kind = g(lights.kind)
    I = g(lights.spectrum)
    light_pos = lights.l2w[:, :3, 3][light_id]  # [L,3] table gather
    kp = lights.kinds_present or (0, 1, 2, 3, 4, 5, 6)
    has_delta_pos = any(k in kp for k in (LIGHT_POINT, LIGHT_SPOT,
                                          LIGHT_PROJECTION,
                                          LIGHT_GONIOMETRIC))
    zeros3 = jnp.zeros(p.shape[:-1] + (3,), jnp.float32)
    zeros1 = jnp.zeros(p.shape[:-1], jnp.float32)

    # --- delta position lights: point/spot/projection/goniometric ---
    if has_delta_pos:
        to_l = light_pos - p
        d2 = jnp.maximum(vm.length_sq(to_l), 1e-12)
        wi_pt = to_l * jax_rsqrt(d2)[..., None]
        Li_pt = I / d2[..., None]
        if any(k in kp for k in (LIGHT_SPOT, LIGHT_PROJECTION,
                                 LIGHT_GONIOMETRIC)):
            # Direction-dependent factor for spot/projection/gonio.
            fac = _projection_factor(scene, light_id, -wi_pt)
            Li_pt = Li_pt * jnp.where(((kind == LIGHT_SPOT) |
                                       (kind == LIGHT_PROJECTION) |
                                       (kind == LIGHT_GONIOMETRIC))[..., None],
                                      fac, 1.0)
    else:
        wi_pt, Li_pt = zeros3, zeros3

    # --- distant: wi stored world dir in params[0:3] ---
    wi_dist = g(lights.params)[..., 0:3]
    Li_dist = I

    # --- area ---
    if LIGHT_AREA in kp:
        is_quad_geom = g(lights.area_geom_kind) == AREA_GEOM_QUADRIC
        if scene.quadrics.count > 0:
            # Sphere cone sampling (shapes/sphere.cpp:45-79).
            qid = jnp.clip(g(lights.area_first), 0, scene.quadrics.count - 1)
            center = scene.quadrics.o2w[:, :3, 3][qid]
            radius = scene.quadrics.params[qid][..., 0]
            to_c = center - p
            dc2 = jnp.maximum(vm.length_sq(to_c), 1e-12)
            inside = dc2 - radius * radius < 1e-4
            wc = to_c * jax_rsqrt(dc2)[..., None]
            _, wcx, wcy = vm.coordinate_system(wc)
            cos_max = jnp.sqrt(jnp.maximum(1e-12,
                                           1.0 - radius * radius / dc2))
            dir_cone = mc.uniform_sample_cone_frame(u1, u2, cos_max, wcx,
                                                    wcy, wc)
            # Project the cone ray onto the sphere (reference intersects;
            # closed form here).
            b = vm.dot(dir_cone, to_c)
            disc = b * b - (dc2 - radius * radius)
            thit = b - jnp.sqrt(jnp.maximum(disc, 0.0))
            thit = jnp.where(disc > 0, thit, vm.dot(to_c, dir_cone))
            ps_sph = p + thit[..., None] * dir_cone
            ns_sph = vm.normalize(ps_sph - center)
            # Inside: uniform over sphere (sphere.cpp:53-55).
            sph_dir = mc.uniform_sample_sphere(u1, u2)
            ps_in = center + radius[..., None] * sph_dir
            ns_in = sph_dir
            ps_q = jnp.where(inside[..., None], ps_in, ps_sph)
            ns_q = jnp.where(inside[..., None], ns_in, ns_sph)

            # Disk / cylinder: uniform over the surface in object space
            # (disk.cpp:36-44 concentric sample; Cylinder::Sample), then
            # to world; pdf via the generic area->solid-angle conversion.
            from ..core import transform as tfm
            qkind = scene.quadrics.kind[qid]
            pq = scene.quadrics.params[qid]
            # Disk params [height, radius, inner, phimax]: r = sqrt-lerp in
            # r^2 for uniform area over the annulus sector.
            d_h, d_r, d_ri, d_ph = (pq[..., 0], pq[..., 1], pq[..., 2],
                                    pq[..., 3])
            rr = jnp.sqrt(d_ri * d_ri + u1 * (d_r * d_r - d_ri * d_ri))
            phi_d = u2 * d_ph
            disk_ps = jnp.stack([rr * jnp.cos(phi_d), rr * jnp.sin(phi_d),
                                 d_h], -1)
            disk_ns = jnp.concatenate(
                [jnp.zeros(p.shape[:-1] + (2,)),
                 jnp.ones(p.shape[:-1] + (1,))], -1)
            # Cylinder params [radius, zmin, zmax, phimax].
            c_r, c_z0, c_z1, c_ph = (pq[..., 0], pq[..., 1], pq[..., 2],
                                     pq[..., 3])
            phi_c = u2 * c_ph
            zc = c_z0 + u1 * (c_z1 - c_z0)
            cyl_ps = jnp.stack([c_r * jnp.cos(phi_c), c_r * jnp.sin(phi_c),
                                zc], -1)
            cyl_ns = jnp.stack([jnp.cos(phi_c), jnp.sin(phi_c),
                                jnp.zeros_like(zc)], -1)
            from ..scene.data import QUADRIC_SPHERE, QUADRIC_DISK
            is_disk = (qkind == QUADRIC_DISK)[..., None]
            obj_ps = jnp.where(is_disk, disk_ps, cyl_ps)
            obj_ns = jnp.where(is_disk, disk_ns, cyl_ns)
            # Matrices via per-row select chains, NOT [N,4,4] gathers
            # (core/transform.py row_components).
            o2w_c = tfm.row_components(scene.quadrics.o2w, qid)
            w2o_c = tfm.row_components(scene.quadrics.w2o, qid)
            ps_flat = tfm.rows_apply_point(o2w_c, obj_ps)
            ns_flat = vm.normalize(tfm.rows_apply_normal(w2o_c, obj_ns))
            sphere_kind = (qkind == QUADRIC_SPHERE)[..., None]
            ps_q = jnp.where(sphere_kind, ps_q, ps_flat)
            ns_q = jnp.where(sphere_kind, ns_q, ns_flat)
            flipq = scene.quadrics.flip_normal[qid]
            ns_q = ns_q * flipq[..., None]
            # Solid-angle pdf only for the sphere cone; everything else
            # (disk/cylinder, and inside-sphere) is uniform-area and gets
            # converted by the generic path below.
            solid_angle_q = sphere_kind[..., 0] & ~inside
            pdf_q = mc.uniform_cone_pdf(cos_max)
        else:
            inside = jnp.zeros(p.shape[:-1], bool)
            solid_angle_q = jnp.zeros(p.shape[:-1], bool)
            ps_q = p
            ns_q = zeros3
            pdf_q = zeros1

        # Triangles.
        if scene.triangles.count > 0:
            ps_t, ns_t = _sample_area_tris(scene, light_id, p, u1, u2, u3)
        else:
            ps_t, ns_t = ps_q, ns_q
        # Instanced emitters (AREA_GEOM_INST; trace-time static flag).
        if lights.inst_area and scene.instances is not None and \
                scene.instances.count > 0:
            ps_i, ns_i = _sample_area_inst(scene, light_id, u1, u2, u3)
            use_i = (g(lights.area_geom_kind) == AREA_GEOM_INST)[..., None]
            ps_t = jnp.where(use_i, ps_i, ps_t)
            ns_t = jnp.where(use_i, ns_i, ns_t)
        ps_a = jnp.where(is_quad_geom[..., None], ps_q, ps_t)
        ns_a = jnp.where(is_quad_geom[..., None], ns_q, ns_t)
        to_s = ps_a - p
        ds2 = jnp.maximum(vm.length_sq(to_s), 1e-12)
        wi_area = to_s * jax_rsqrt(ds2)[..., None]
        cos_l = vm.absdot(ns_a, wi_area)
        # Solid-angle pdf (core/shape.h:96-107): dist^2/(|cos| * area).
        pdf_area_sa = ds2 / jnp.maximum(cos_l * g(lights.area_total_area),
                                        1e-12)
        pdf_area = jnp.where(is_quad_geom & solid_angle_q, pdf_q,
                             pdf_area_sa)
        # One-sided emission L(p,n,w) (core/light.h:88-116).
        emits = vm.dot(ns_a, -wi_area) > 0.0
        Li_area = jnp.where(emits[..., None], I, 0.0)
    else:
        wi_area = zeros3
        Li_area = zeros3
        pdf_area = zeros1
        ps_a = p

    # --- infinite: cosine about n, hemisphere flip by u3 ---
    if LIGHT_INFINITE in kp:
        x, y = mc.concentric_sample_disk(u1, u2)
        z = jnp.sqrt(jnp.maximum(1e-12, 1.0 - x * x - y * y))
        z = jnp.where(u3 < 0.5, -z, z)
        nf = vm.normalize(n)
        _, v1, v2 = vm.coordinate_system(nf)
        wi_inf = x[..., None] * v1 + y[..., None] * v2 + z[..., None] * nf
        pdf_inf = jnp.abs(z) * mc.INV_TWOPI
        Li_inf = env_radiance(scene, light_id, wi_inf)
        # infinitesample override: map-importance sampling
        # (lights/infinitesample.cpp:152-178) for lights with tables.
        for (lid, img, imp) in lights.infinite_meta:
            if imp < 0:
                continue
            wi_is, pdf_is, Li_is = _sample_env_importance(
                scene, lid, scene.env_importance[imp], img, u1, u2)
            sel = light_id == lid
            wi_inf = jnp.where(sel[..., None], wi_is, wi_inf)
            pdf_inf = jnp.where(sel, pdf_is, pdf_inf)
            Li_inf = jnp.where(sel[..., None], Li_is, Li_inf)
    else:
        wi_inf = zeros3
        Li_inf = zeros3
        pdf_inf = zeros1

    # --- select by kind ---
    delta = is_delta(kind)
    wi = jnp.where(delta[..., None], wi_pt, wi_inf)
    wi = jnp.where((kind == LIGHT_DISTANT)[..., None], wi_dist, wi)
    wi = jnp.where((kind == LIGHT_AREA)[..., None], wi_area, wi)
    Li = jnp.where(delta[..., None], Li_pt, Li_inf)
    Li = jnp.where((kind == LIGHT_DISTANT)[..., None], Li_dist, Li)
    Li = jnp.where((kind == LIGHT_AREA)[..., None], Li_area, Li)
    pdf = jnp.where(delta, 1.0, pdf_inf)
    pdf = jnp.where(kind == LIGHT_DISTANT, 1.0, pdf)
    pdf = jnp.where(kind == LIGHT_AREA, pdf_area, pdf)

    # Visibility: segment to light point (delta/area), ray to inf (dist/env).
    seg = delta | (kind == LIGHT_AREA)
    seg_target = jnp.where((kind == LIGHT_AREA)[..., None], ps_a, light_pos)
    dist = jnp.sqrt(jnp.maximum(vm.length_sq(seg_target - p), 1e-12))
    vis_maxt = jnp.where(seg, dist * (1.0 - 1e-3), _BIG)
    return dict(Li=Li, wi=wi, pdf=pdf, delta=delta, vis_maxt=vis_maxt)


def _cdf_offset(cdf_gather, n, u):
    """Largest index i in [0, n] with cdf[i] <= u, via branchless binary
    search (Distribution1D::Sample upper_bound,
    lights/infinitesample.cpp:42-51). cdf_gather(idx[B]) -> cdf values."""
    import math as _m
    lo = jnp.zeros_like(u, jnp.int32)
    hi = jnp.full_like(lo, n)
    for _ in range(int(_m.ceil(_m.log2(n + 1))) + 1):
        mid = (lo + hi + 1) // 2
        go = u >= cdf_gather(mid)
        lo = jnp.where(go, mid, lo)
        hi = jnp.where(go, hi, mid - 1)
    return jnp.clip(lo, 0, n - 1)


def _sample_env_importance(scene: SceneData, lid: int, dist, img: int,
                           u1, u2):
    """InfiniteAreaLightIS::Sample_L(p, u1, u2)
    (lights/infinitesample.cpp:152-178): sample the column marginal then the
    per-column conditional, map (fu, fv) -> (phi, theta), pdf with the
    sin(theta) Jacobian."""
    nu, nv = dist.nu, dist.nv
    o_u = _cdf_offset(lambda i: dist.cdf_u[i], nu, u1)
    seg_u = dist.cdf_u[o_u + 1] - dist.cdf_u[o_u]
    du = (u1 - dist.cdf_u[o_u]) / jnp.maximum(seg_u, 1e-20)
    fu = o_u.astype(jnp.float32) + jnp.clip(du, 0.0, 1.0)
    pdf_u = dist.func_u[o_u] / jnp.maximum(dist.int_u, 1e-20)

    o_v = _cdf_offset(lambda i: dist.cdf_v[o_u, i], nv, u2)
    c0 = dist.cdf_v[o_u, o_v]
    seg_v = dist.cdf_v[o_u, o_v + 1] - c0
    dv = (u2 - c0) / jnp.maximum(seg_v, 1e-20)
    fv = o_v.astype(jnp.float32) + jnp.clip(dv, 0.0, 1.0)
    pdf_v = dist.func_v[o_u, o_v] / jnp.maximum(dist.int_v[o_u], 1e-20)

    theta = fv * (jnp.pi / nv)
    phi = fu * (2.0 * jnp.pi / nu)
    sin_t = jnp.sin(theta)
    cos_t = jnp.cos(theta)
    wl = jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], -1)
    wi = tf.apply_vector(scene.lights.l2w[lid], wl)
    ok = sin_t > 1e-7
    pdf_val = jnp.where(ok, pdf_u * pdf_v /
                        (2.0 * jnp.pi * jnp.pi * jnp.maximum(sin_t, 1e-7)),
                        0.0)
    base = scene.lights.spectrum[lid]
    tex = mipmap_lookup_tri(scene.images[img].levels, fu / nu, fv / nv,
                            jnp.zeros_like(fu), scene.images[img].wrap)
    Li = jnp.where(ok[..., None], base * tex, 0.0)
    return wi, pdf_val, Li


def _pdf_env_importance(scene: SceneData, lid: int, dist, wi_world):
    """InfiniteAreaLightIS::Pdf (lights/infinitesample.cpp:179-191)."""
    nu, nv = dist.nu, dist.nv
    wl = vm.normalize(tf.apply_vector(scene.lights.w2l[lid], wi_world))
    theta = vm.spherical_theta(wl)
    phi = vm.spherical_phi(wl)
    u = jnp.clip((phi * (0.5 / jnp.pi) * nu).astype(jnp.int32), 0, nu - 1)
    v = jnp.clip((theta * (1.0 / jnp.pi) * nv).astype(jnp.int32), 0, nv - 1)
    sin_t = jnp.maximum(jnp.sin(theta), 1e-7)
    return (dist.func_u[u] * dist.func_v[u, v]) / \
        jnp.maximum(dist.int_u * dist.int_v[u], 1e-20) / \
        (2.0 * jnp.pi * jnp.pi * sin_t)


def pdf(scene: SceneData, light_id, p, n, wi):
    """light->Pdf(p, n, wi) for MIS BSDF-strategy weighting.

    Delta lights: 0. Infinite: |n.wi|/2pi (lights/infinite.cpp:117-120).
    Area: solid-angle pdf — the caller provides the actual hit on the light
    via pdf_area_from_hit when available; this version intersects only the
    area light's own sphere analytically (cone pdf).
    """
    lights = scene.lights
    g = lambda a: a[light_id]
    kind = g(lights.kind)
    out = jnp.zeros(p.shape[:-1], jnp.float32)
    # Infinite.
    out = jnp.where(kind == LIGHT_INFINITE,
                    vm.absdot(n, wi) * mc.INV_TWOPI, out)
    # infinitesample: map-importance pdf for lights with tables.
    for (lid, _img, imp) in lights.infinite_meta:
        if imp < 0:
            continue
        out = jnp.where(light_id == lid,
                        _pdf_env_importance(scene, lid,
                                            scene.env_importance[imp], wi),
                        out)
    # Area sphere: cone pdf (skipped when the scene has no quadrics — the
    # gather would index an empty table).
    if scene.quadrics.count > 0:
        from ..scene.data import QUADRIC_SPHERE
        qid = jnp.clip(g(lights.area_first), 0, scene.quadrics.count - 1)
        center = scene.quadrics.o2w[:, :3, 3][qid]
        radius = scene.quadrics.params[qid][..., 0]
        dc2 = jnp.maximum(vm.length_sq(center - p), 1e-12)
        cos_max = jnp.sqrt(jnp.maximum(1e-12, 1.0 - radius * radius / dc2))
        # Cone pdf is the sphere's solid-angle sampling density; disk and
        # cylinder area lights are uniform-area-sampled, so their pdf needs
        # the actual hit point — the MIS caller substitutes
        # pdf_area_from_hit for them (Shape::Pdf(p, wi) semantics).
        is_sphere = (kind == LIGHT_AREA) & \
            (g(lights.area_geom_kind) == AREA_GEOM_QUADRIC) & \
            (scene.quadrics.kind[qid] == QUADRIC_SPHERE)
        out = jnp.where(is_sphere, mc.uniform_cone_pdf(cos_max), out)
    return out


def pdf_area_from_hit(scene: SceneData, light_id, p, wi, hit_p, hit_nn):
    """Solid-angle pdf for a triangle-set area light given the actual hit
    point found by the scene intersection (Shape::Pdf(p,wi) semantics)."""
    lights = scene.lights
    g = lambda a: a[light_id]
    d2 = vm.length_sq(hit_p - p)
    cos_l = vm.absdot(hit_nn, wi)
    return d2 / jnp.maximum(cos_l * g(lights.area_total_area), 1e-12)


def area_emission(scene: SceneData, area_id, nn, w):
    """AreaLight::L(p, n, w): one-sided Lemit (core/light.h:97-101)."""
    aid = jnp.maximum(area_id, 0)
    L = scene.lights.spectrum[aid]
    emits = (vm.dot(nn, w) > 0.0) & (area_id >= 0)
    return jnp.where(emits[..., None], L, 0.0)


def power(scene: SceneData):
    """Light::Power approximations for light-selection CDFs."""
    lights = scene.lights
    lo, hi = scene.world_bound_lo, scene.world_bound_hi
    radius = 0.5 * vm.length(hi - lo)
    area_pow = lights.spectrum * (lights.area_total_area[..., None] * jnp.pi)
    point_pow = lights.spectrum * (4.0 * jnp.pi)
    spot_pow = lights.spectrum * (2.0 * jnp.pi * (
        1.0 - 0.5 * (lights.params[..., 1] + lights.params[..., 0])))[..., None]
    dist_pow = lights.spectrum * (jnp.pi * radius * radius)
    inf_pow = lights.spectrum * (jnp.pi * radius * radius)
    k = lights.kind
    out = jnp.where((k == LIGHT_POINT)[..., None], point_pow, inf_pow)
    out = jnp.where((k == LIGHT_SPOT)[..., None], spot_pow, out)
    out = jnp.where((k == LIGHT_PROJECTION)[..., None], spot_pow, out)
    out = jnp.where((k == LIGHT_GONIOMETRIC)[..., None], point_pow, out)
    out = jnp.where((k == LIGHT_DISTANT)[..., None], dist_pow, out)
    out = jnp.where((k == LIGHT_AREA)[..., None], area_pow, out)
    return out


def jax_rsqrt(x):
    from jax import lax
    return lax.rsqrt(x)

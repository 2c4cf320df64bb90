"""Scene-level intersection: the analogue of Scene::Intersect/IntersectP
(/root/reference/core/scene.h:40-49) plus the aggregate dispatch that the
reference does through Primitive virtuals (core/primitive.{h,cpp}).

A "primitive id" is a single integer: quadric q -> q, triangle t -> NQ + t.
`intersect` returns nearest-hit SoA records; `occluded` is the any-hit
predicate used for shadow rays. When the scene has a grid accelerator the
DDA traversal (accel/grid.py) is used; otherwise all-pairs brute force —
the small-scene fast path.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..scene.data import SceneData
from ..shapes import quadrics, triangle

_BIG = jnp.float32(1e30)
PRIM_QUADRIC = 0
PRIM_TRIANGLE = 1

# Prim-count ceiling for the unrolled per-prim brute force below. Scenes
# above the accel auto-threshold (64) build a grid/kd-tree anyway; this only
# needs to cover the no-accelerator small-scene regime.
BRUTE_UNROLL_MAX = 128


def _brute_force_unrolled(scene: SceneData, o, d, mint, maxt,
                          any_hit=False):
    """Per-prim unrolled nearest-hit (or any-hit) over all prims.

    The batched [N, nprims] formulation materializes [N, nprims]
    intermediates and funnels through argmin + take_along_axis gathers;
    unrolling the (static, small) prim loop keeps every array [N]-shaped
    with a running min — elementwise code XLA fuses.
    """
    best_t = jnp.full(o.shape[:-1], _BIG)
    best_id = jnp.full(o.shape[:-1], -1, jnp.int32)
    hit = jnp.zeros(o.shape[:-1], bool)
    nq = scene.quadrics.count
    for i, (kind, phi_full, z_full) in enumerate(
            scene.quadrics.static_rows or ()):
        ti, vi = quadrics.intersect_one(scene.quadrics, i, kind, phi_full,
                                        z_full, o, d, mint, maxt)
        if any_hit:
            hit = hit | vi
        else:
            upd = vi & (ti < best_t)
            best_t = jnp.where(upd, ti, best_t)
            best_id = jnp.where(upd, jnp.int32(i), best_id)
    tri = scene.triangles
    for i in range(tri.count):
        p0 = tri.verts[tri.idx[i, 0]]
        p1 = tri.verts[tri.idx[i, 1]]
        p2 = tri.verts[tri.idx[i, 2]]
        ti, _, _, vi = triangle.intersect_pairs(p0, p1, p2, o, d, mint, maxt)
        if any_hit:
            hit = hit | vi
        else:
            upd = vi & (ti < best_t)
            best_t = jnp.where(upd, ti, best_t)
            best_id = jnp.where(upd, jnp.int32(nq + i), best_id)
    if any_hit:
        return jnp.where(hit, 0.0, _BIG), jnp.where(hit, 0, -1), hit
    return best_t, best_id, best_id >= 0


def _brute_force(scene: SceneData, o, d, mint, maxt, any_hit=False):
    """Nearest hit over all prims. Returns (t[N], prim_id[N], hit[N])."""
    n = o.shape[0]
    nq = scene.quadrics.count
    nt = scene.triangles.count
    if 0 < nq + nt <= BRUTE_UNROLL_MAX and \
            scene.quadrics.static_rows is not None:
        return _brute_force_unrolled(scene, o, d, mint, maxt,
                                     any_hit=any_hit)
    best_t = jnp.full((n,), _BIG)
    best_id = jnp.full((n,), -1, jnp.int32)
    if nq:
        tq, vq = quadrics.intersect(scene.quadrics, o, d, mint, maxt)
        tq = jnp.where(vq, tq, _BIG)
        qi = jnp.argmin(tq, axis=1)
        qt = jnp.take_along_axis(tq, qi[:, None], axis=1)[:, 0]
        upd = qt < best_t
        best_t = jnp.where(upd, qt, best_t)
        best_id = jnp.where(upd, qi.astype(jnp.int32), best_id)
    if nt:
        tt, vt = triangle.intersect(scene.triangles, o, d, mint, maxt)
        tt = jnp.where(vt, tt, _BIG)
        ti = jnp.argmin(tt, axis=1).astype(jnp.int32)
        t_best = jnp.take_along_axis(tt, ti[:, None], axis=1)[:, 0]
        upd = t_best < best_t
        best_t = jnp.where(upd, t_best, best_t)
        best_id = jnp.where(upd, ti.astype(jnp.int32) + nq, best_id)
    hit = best_id >= 0
    return best_t, best_id, hit


def _has_instances(scene: SceneData) -> bool:
    return scene.instances is not None and scene.instances.count > 0


def _main_intersect(scene: SceneData, o, d, mint, maxt):
    if scene.accel is not None:
        from ..scene.data import BvhAccel, KdTreeAccel
        if isinstance(scene.accel, BvhAccel):
            from . import bvh as bvh_mod
            return bvh_mod.intersect(scene, o, d, mint, maxt)
        if isinstance(scene.accel, KdTreeAccel):
            from . import kdtree as kd_mod
            return kd_mod.intersect(scene, o, d, mint, maxt)
        from . import grid as grid_mod
        return grid_mod.intersect(scene, o, d, mint, maxt)
    return _brute_force(scene, o, d, mint, maxt)


def intersect_ids(scene: SceneData, o, d, mint, maxt):
    """Nearest-hit (t, prim_id, hit) without differential geometry.
    Instanced geometry (scene.instances) is a second aggregate: its hits
    are min-combined with the main one; instanced winners get global ids
    NQ + NT + inst * n_proto_tris + proto_tri."""
    t, pid, hit = _main_intersect(scene, o, d, mint, maxt)
    if _has_instances(scene):
        from . import instances as inst_mod
        ti, code, hi_ = inst_mod.intersect(scene.instances, o, d, mint,
                                           maxt)
        # Differentiable recompute of the instanced winner's t (same
        # detached-traversal estimator as the main aggregates).
        t_id, valid_i = inst_mod.recompute_t(scene.instances, code, o, d,
                                             mint, hi_)
        ti = jnp.where(hi_ & valid_i, t_id, jnp.where(hi_, ti, _BIG))
        t_main = jnp.where(hit, t, _BIG)
        choose = hi_ & (ti < t_main)
        base = scene.quadrics.count + scene.triangles.count
        t = jnp.where(choose, ti, t_main)
        pid = jnp.where(choose, base + code, pid)
        hit = hit | hi_
    return t, pid, hit


def occluded(scene: SceneData, o, d, mint, maxt):
    """Any-hit shadow-ray predicate (Scene::IntersectP)."""
    if scene.accel is not None:
        from ..scene.data import BvhAccel, KdTreeAccel
        if isinstance(scene.accel, BvhAccel):
            from . import bvh as bvh_mod
            _, _, hit = bvh_mod.intersect(scene, o, d, mint, maxt,
                                          any_hit=True)
        elif isinstance(scene.accel, KdTreeAccel):
            from . import kdtree as kd_mod
            _, _, hit = kd_mod.intersect(scene, o, d, mint, maxt,
                                         any_hit=True)
        else:
            _, _, hit = _main_intersect(scene, o, d, mint, maxt)
    else:
        _, _, hit = _brute_force(scene, o, d, mint, maxt, any_hit=True)
    if _has_instances(scene):
        from . import instances as inst_mod
        _, _, hi_ = inst_mod.intersect(scene.instances, o, d, mint, maxt,
                                       any_hit=True)
        hit = hit | hi_
    return hit


def hit_geometry(scene: SceneData, prim_id, o, d, t):
    """DifferentialGeometry + material/area-light ids for winning prims.

    prim_id may be -1 (miss); outputs are garbage there and must be masked
    by the caller's `hit` flag (standard wavefront discipline).
    """
    nq = scene.quadrics.count
    nt = scene.triangles.count
    base = nq + nt
    is_inst = None
    if scene.instances is not None and scene.instances.count > 0:
        from . import instances as inst_mod
        is_inst = jnp.maximum(prim_id, 0) >= base
        dg_i = inst_mod.hit_geometry(
            scene.instances, jnp.maximum(prim_id - base, 0), o, d, t)
        prim_id = jnp.where(is_inst, 0, prim_id)   # main branch clamps
        if base == 0:
            dg_i["material"] = jnp.where(is_inst, dg_i["material"], 0)
            return dg_i
    pid = jnp.maximum(prim_id, 0)

    if nq and nt:
        is_tri = pid >= nq
        qid = jnp.clip(pid, 0, nq - 1)
        tid = jnp.clip(pid - nq, 0, nt - 1)
        dgq = quadrics.differential_geometry(scene.quadrics, qid, o, d, t)
        dgt = triangle.differential_geometry(scene.triangles, tid, o, d, t)
        m = is_tri[..., None]
        dg = {}
        for k in ("p", "nn", "dpdu", "dpdv", "dndu", "dndv"):
            dg[k] = jnp.where(m, dgt[k], dgq[k])
        for k in ("u", "v"):
            dg[k] = jnp.where(is_tri, dgt[k], dgq[k])
        dg["sn"] = jnp.where(m, dgt["sn"], dgq["nn"])
        dg["ss"] = jnp.where(m, dgt["ss"], _norm(dgq["dpdu"]))
        dg["ts"] = jnp.where(m, dgt["ts"], _cross_n(dgq))
        material = jnp.where(is_tri, scene.triangles.material[tid],
                             scene.quadrics.material[qid])
        area_light = jnp.where(is_tri, scene.triangles.area_light[tid],
                               scene.quadrics.area_light[qid])
    elif nt:
        tid = jnp.clip(pid - nq, 0, nt - 1)
        dg = triangle.differential_geometry(scene.triangles, tid, o, d, t)
        material = scene.triangles.material[tid]
        area_light = scene.triangles.area_light[tid]
    else:
        qid = jnp.clip(pid, 0, max(nq - 1, 0))
        dgq = quadrics.differential_geometry(scene.quadrics, qid, o, d, t)
        dg = dict(dgq)
        dg["sn"] = dgq["nn"]
        dg["ss"] = _norm(dgq["dpdu"])
        dg["ts"] = _cross_n(dgq)
        material = scene.quadrics.material[qid]
        area_light = scene.quadrics.area_light[qid]

    dg["material"] = material
    dg["area_light"] = area_light
    if is_inst is not None:
        m = is_inst[..., None]
        for k in ("p", "nn", "sn", "ss", "ts", "dpdu", "dpdv", "dndu",
                  "dndv"):
            dg[k] = jnp.where(m, dg_i[k], dg[k])
        for k in ("u", "v"):
            dg[k] = jnp.where(is_inst, dg_i[k], dg[k])
        dg["material"] = jnp.where(is_inst, dg_i["material"],
                                   dg["material"])
        dg["area_light"] = jnp.where(is_inst, dg_i["area_light"],
                                     dg["area_light"])
    return dg


def compute_differentials(dg, rx_o, rx_d, ry_o, ry_d, active):
    """DifferentialGeometry::ComputeDifferentials
    (/root/reference/core/shape.cpp:52-106): intersect the +x/+y auxiliary
    camera rays with the tangent plane at the hit, then solve the 2x2
    plane-projection system for (dudx, dvdx) / (dudy, dvdy). Adds the
    dpdx/dpdy/dudx/dvdx/dudy/dvdy keys to dg (zeros on inactive lanes).
    Branchless: the projection axes are selected per lane by gather."""
    from ..core import vecmath as vm
    nn, p, dpdu, dpdv = dg["nn"], dg["p"], dg["dpdu"], dg["dpdv"]
    dplane = -vm.dot(nn, p)

    def aux(o_a, d_a):
        denom = vm.dot(nn, d_a)
        ok = jnp.abs(denom) > 1e-12
        tx = -(vm.dot(nn, o_a) + dplane) / jnp.where(ok, denom, 1.0)
        return o_a + tx[..., None] * d_a, ok

    px, okx = aux(rx_o, rx_d)
    py, oky = aux(ry_o, ry_d)
    live = active & okx & oky
    dpdx = jnp.where(live[..., None], px - p, 0.0)
    dpdy = jnp.where(live[..., None], py - p, 0.0)

    # Projection plane: drop the dominant normal axis (shape.cpp:69-78).
    an = jnp.abs(nn)
    dom = jnp.argmax(an, axis=-1)
    ax0 = jnp.where(dom == 0, 1, 0)
    ax1 = jnp.where(dom == 2, 1, 2)

    def comp(v, ax):
        # One-hot select instead of take_along_axis: three selects fuse
        # into the surrounding elementwise code (not measured on the
        # H100 against the gather; ROADMAP C3).
        return jnp.where(ax == 0, v[..., 0],
                         jnp.where(ax == 1, v[..., 1], v[..., 2]))

    a00 = comp(dpdu, ax0)
    a01 = comp(dpdv, ax0)
    a10 = comp(dpdu, ax1)
    a11 = comp(dpdv, ax1)
    det = a00 * a11 - a01 * a10
    solvable = jnp.abs(det) >= 1e-5          # SolveLinearSystem2x2 guard
    inv_det = 1.0 / jnp.where(solvable, det, 1.0)

    def solve(b, fallback):
        b0 = comp(b, ax0)
        b1 = comp(b, ax1)
        du = jnp.where(solvable, (a11 * b0 - a01 * b1) * inv_det, fallback[0])
        dv = jnp.where(solvable, (a00 * b1 - a10 * b0) * inv_det, fallback[1])
        return du, dv

    dudx, dvdx = solve(dpdx, (1.0, 0.0))
    dudy, dvdy = solve(dpdy, (0.0, 1.0))
    out = dict(dg)
    out["dpdx"] = dpdx
    out["dpdy"] = dpdy
    z = jnp.zeros_like(dudx)
    out["dudx"] = jnp.where(live, dudx, z)
    out["dvdx"] = jnp.where(live, dvdx, z)
    out["dudy"] = jnp.where(live, dudy, z)
    out["dvdy"] = jnp.where(live, dvdy, z)
    return out


def hit_geometry_light(scene: SceneData, prim_id, o, d, t):
    """Cheap hit record for light-identification rays: p, nn (geometric,
    flip applied), area_light, material. Skips u/v, tangents and all
    derivative terms — EstimateDirect's BSDF-strategy ray
    (core/transport.cpp:166-188) only needs emission geometry, and the full
    DifferentialGeometry costs ~6x more (transcendentals + extra gathers).
    """
    from ..core import vecmath as vm
    from ..core import transform as tf
    from ..scene.data import (QUADRIC_SPHERE, QUADRIC_CYLINDER, QUADRIC_DISK,
                              QUADRIC_CONE, QUADRIC_PARABOLOID)
    nq = scene.quadrics.count
    nt = scene.triangles.count
    base = nq + nt
    is_inst = None
    if scene.instances is not None and scene.instances.count > 0:
        # Instanced hits carry no area light (parser falls back to
        # duplication for emissive objects): geometric normal + material
        # suffice for the strategy-2 identification contract.
        from . import instances as inst_mod
        is_inst = jnp.maximum(prim_id, 0) >= base
        dg_i = inst_mod.hit_geometry(
            scene.instances, jnp.maximum(prim_id - base, 0), o, d, t)
        prim_id = jnp.where(is_inst, 0, prim_id)
        if base == 0:
            return dict(p=dg_i["p"], nn=dg_i["nn"],
                        area_light=dg_i["area_light"],
                        material=dg_i["material"])
    pid = jnp.maximum(prim_id, 0)
    p = o + t[..., None] * d

    def tri_nn(tid):
        p0, p1, p2 = triangle.gather_verts(scene.triangles, tid)
        nn = vm.normalize(vm.cross(p1 - p0, p2 - p0))
        return nn * scene.triangles.flip_normal[tid][..., None]

    def quad_nn(qid):
        # Normal from the implicit-surface gradient at the object-space hit
        # (no trig, unlike the full parametric DG).
        q = scene.quadrics
        w2o_c = tf.row_components(q.w2o, qid)
        kindq = q.kind[qid]
        prm = q.params[qid]
        ph = tf.rows_apply_point(w2o_c, p)
        x, y, z = ph[..., 0], ph[..., 1], ph[..., 2]
        zeros = jnp.zeros_like(x)
        kp = q.kinds_present or quadrics.ALL_QUADRIC_KINDS
        grad = jnp.stack([x, y, z], -1)  # sphere default
        if QUADRIC_CYLINDER in kp:
            grad = jnp.where((kindq == QUADRIC_CYLINDER)[..., None],
                             jnp.stack([x, y, zeros], -1), grad)
        if QUADRIC_DISK in kp:
            grad = jnp.where((kindq == QUADRIC_DISK)[..., None],
                             jnp.stack([zeros, zeros, jnp.ones_like(x)], -1),
                             grad)
        if QUADRIC_CONE in kp:
            r_co, h_co = prm[..., 0], prm[..., 1]
            k_co = (r_co / jnp.where(h_co == 0, 1.0, h_co)) ** 2
            grad = jnp.where((kindq == QUADRIC_CONE)[..., None],
                             jnp.stack([x, y, -k_co * (z - h_co)], -1), grad)
        if QUADRIC_PARABOLOID in kp:
            r_pa, zmax_pa = prm[..., 0], prm[..., 2]
            k_pa = zmax_pa / jnp.where(r_pa == 0, 1.0, r_pa * r_pa)
            grad = jnp.where((kindq == QUADRIC_PARABOLOID)[..., None],
                             jnp.stack([2 * k_pa * x, 2 * k_pa * y,
                                        -jnp.ones_like(x)], -1), grad)
        if 5 in kp:  # hyperboloid
            a_h, c_h = prm[..., 0], prm[..., 1]
            grad = jnp.where((kindq == 5)[..., None],
                             jnp.stack([a_h * x, a_h * y, -c_h * z], -1),
                             grad)
        nn = vm.normalize(tf.rows_apply_normal(w2o_c, grad))
        return nn * q.flip_normal[qid][..., None]

    if nq and nt:
        is_tri = pid >= nq
        qid = jnp.clip(pid, 0, nq - 1)
        tid = jnp.clip(pid - nq, 0, nt - 1)
        nn = jnp.where(is_tri[..., None], tri_nn(tid), quad_nn(qid))
        area_light = jnp.where(is_tri, scene.triangles.area_light[tid],
                               scene.quadrics.area_light[qid])
        material = jnp.where(is_tri, scene.triangles.material[tid],
                             scene.quadrics.material[qid])
    elif nt:
        tid = jnp.clip(pid - nq, 0, nt - 1)
        nn = tri_nn(tid)
        area_light = scene.triangles.area_light[tid]
        material = scene.triangles.material[tid]
    else:
        qid = jnp.clip(pid, 0, max(nq - 1, 0))
        nn = quad_nn(qid)
        area_light = scene.quadrics.area_light[qid]
        material = scene.quadrics.material[qid]
    if is_inst is not None:
        nn = jnp.where(is_inst[..., None], dg_i["nn"], nn)
        area_light = jnp.where(is_inst, dg_i["area_light"], area_light)
        material = jnp.where(is_inst, dg_i["material"], material)
    return dict(p=p, nn=nn, area_light=area_light, material=material)


def _norm(v):
    from ..core import vecmath as vm
    return vm.normalize(v)


def _cross_n(dgq):
    from ..core import vecmath as vm
    return vm.normalize(vm.cross(dgq["nn"], vm.normalize(dgq["dpdu"])))

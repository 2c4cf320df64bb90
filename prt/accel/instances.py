"""Ray-transform instancing: build + intersection + shading geometry.

The reference's InstancePrimitive (/root/reference/core/primitive.cpp:66-85,
api.cpp ObjectInstance): prototype triangle meshes are stored ONCE in
object space, each with its own SAH BLAS (accel/bvh_build.build_rows);
instances carry only 4x4 transforms. Traversal (ops/bvh_walk) loops over
the instances, moves the rays that enter an instance's world bbox into
its object space and walks the prototype's node range; the unnormalized
transformed direction keeps the world-t parameterization so hits from
instances and the main aggregate compare directly.

Global prim-id encoding for instanced hits (so integrator signatures are
unchanged): pid = NQ + NT + inst * n_proto_tris + proto_tri.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core import transform as tf, vecmath as vm
from ..ops import bvh_walk
from ..scene.data import InstanceTable

_BIG = jnp.float32(1e30)


def build_instances(protos, instances) -> InstanceTable:
    """protos: list of dicts with keys verts f32[V,3], idx i32[T,3],
    uv f32[V,2]|None, normals f32[V,3]|None, material i32[T] (global
    material ids), flip float. instances: list of (proto_id, o2w 4x4)."""
    from .bvh_build import build_rows

    v_ofs = 0
    t_ofs = 0
    all_v, all_i, all_uv, all_n, all_hn, all_m, all_f = \
        [], [], [], [], [], [], []
    node_rows = []
    proto_range = []        # per proto: (first row, node count)
    proto_bbox = []         # per proto: object-space root bbox lo3, hi3
    row_ofs = 0
    for pr in protos:
        verts = np.asarray(pr["verts"], np.float32)
        idx = np.asarray(pr["idx"], np.int32)
        T = len(idx)
        tri9 = np.concatenate([verts[idx[:, 0]], verts[idx[:, 1]],
                               verts[idx[:, 2]]], axis=1).astype(np.float32)
        lo = tri9.reshape(T, 3, 3).min(1)
        hi = tri9.reshape(T, 3, 3).max(1)
        rows, _pids, nn = build_rows(lo, hi, 0, tri9)
        # Leaf prim ids -> global proto-tri ids (cols 80..87; only leaf
        # rows read them, guarded by j < nprims).
        rows = rows.copy()
        rows[:, 80:88] += float(t_ofs)
        node_rows.append(rows)
        proto_range.append((row_ofs, nn))
        proto_bbox.append(rows[0, 0:6])
        row_ofs += nn

        all_v.append(verts)
        all_i.append(idx + v_ofs)
        uv = pr.get("uv")
        all_uv.append(np.asarray(uv, np.float32) if uv is not None
                      else np.zeros((len(verts), 2), np.float32))
        nrm = pr.get("normals")
        all_n.append(np.asarray(nrm, np.float32) if nrm is not None
                     else np.zeros((len(verts), 3), np.float32))
        all_hn.append(np.full(T, nrm is not None, bool))
        all_m.append(np.asarray(pr["material"], np.int32) * np.ones(T, np.int32))
        all_f.append(np.full(T, float(pr.get("flip", 1.0)), np.float32))
        v_ofs += len(verts)
        t_ofs += T

    assert t_ofs < (1 << 24), "prototype tris exceed the f32-id row format"
    nodes = np.concatenate(node_rows) if node_rows else \
        np.zeros((1, 96), np.float32)

    # Per instance: the world bbox of its prototype's root box, and the
    # prototype's node range.
    i_bbox, i_range = [], []
    o2w_list, w2o_list = [], []
    lo_all = np.full(3, 1e30, np.float32)
    hi_all = np.full(3, -1e30, np.float32)
    for pid, o2w in instances:
        o2w = np.asarray(o2w, np.float32)
        o2w_list.append(o2w)
        w2o_list.append(np.linalg.inv(o2w).astype(np.float32))
        blo, bhi = proto_bbox[pid][0:3], proto_bbox[pid][3:6]
        corners = np.array([[x, y, z] for x in (blo[0], bhi[0])
                            for y in (blo[1], bhi[1])
                            for z in (blo[2], bhi[2])], np.float32)
        wc = corners @ o2w[:3, :3].T + o2w[:3, 3]
        wlo, whi = wc.min(0), wc.max(0)
        pad = 1e-5 * np.abs(wc).max() + 1e-6
        i_bbox.append(np.concatenate([wlo - pad, whi + pad]))
        i_range.append(proto_range[pid])
        lo_all = np.minimum(lo_all, wlo)
        hi_all = np.maximum(hi_all, whi)

    signs = np.asarray([1.0 if np.linalg.det(np.asarray(m)[:3, :3]) >= 0
                        else -1.0 for m in o2w_list], np.float32) \
        if o2w_list else np.zeros((0,), np.float32)
    dp = jax.device_put
    return InstanceTable(
        inst_sign=dp(signs),
        verts=dp(np.concatenate(all_v)), idx=dp(np.concatenate(all_i)),
        uv=dp(np.concatenate(all_uv)), normals=dp(np.concatenate(all_n)),
        has_normals=dp(np.concatenate(all_hn)),
        material=dp(np.concatenate(all_m)),
        flip_normal=dp(np.concatenate(all_f)),
        nodes=dp(nodes),
        inst_o2w=dp(np.stack(o2w_list)), inst_w2o=dp(np.stack(w2o_list)),
        inst_bbox=dp(np.asarray(i_bbox, np.float32).reshape(-1, 6)),
        inst_range=dp(np.asarray(i_range, np.int32).reshape(-1, 2)),
        bounds_lo=dp(lo_all), bounds_hi=dp(hi_all),
        count=len(instances), n_tris=t_ofs, leaf_k=8)


def intersect(inst: InstanceTable, o, d, mint, maxt, any_hit=False):
    """(t, code, hit): code = inst * n_tris + proto_tri for hits, -1 else.
    Detached (accel-style); callers recompute the winner differentiably
    via recompute_t."""
    # Traversal is fully detached (standard accel discipline): gradients
    # flow only through recompute_t's world-vertex math.
    sg = jax.lax.stop_gradient
    args = (sg(inst.nodes), sg(inst.inst_bbox), inst.inst_range,
            sg(inst.inst_w2o).reshape(inst.count, 16),
            sg(o), sg(d), sg(mint), sg(maxt))
    if bvh_walk.use_kernel():
        t, tri, ii = bvh_walk.traverse_instanced(
            *args, leaf_k=inst.leaf_k, any_hit=any_hit)
    else:
        t, tri, ii = bvh_walk.walk_instanced(
            *args, leaf_k=inst.leaf_k, any_hit=any_hit)
    hit = (tri >= 0) & (ii >= 0)
    code = jnp.where(hit, ii * inst.n_tris + tri, -1)
    return jnp.where(hit, t, _BIG), code, hit


def _world_verts(inst: InstanceTable, code):
    """Gather + transform the hit triangle's vertices to world space.
    Returns (inst_id, tri_id, o2w rows, w2o rows, p0, p1, p2, i3)."""
    code = jnp.maximum(code, 0)
    ii = code // inst.n_tris
    tid = code % inst.n_tris
    i3 = inst.idx[tid]
    o2w_c = tf.row_components(inst.inst_o2w, ii)
    w2o_c = tf.row_components(inst.inst_w2o, ii)
    p0 = tf.rows_apply_point(o2w_c, inst.verts[i3[..., 0]])
    p1 = tf.rows_apply_point(o2w_c, inst.verts[i3[..., 1]])
    p2 = tf.rows_apply_point(o2w_c, inst.verts[i3[..., 2]])
    return ii, tid, o2w_c, w2o_c, p0, p1, p2, i3


def recompute_t(inst: InstanceTable, code, o, d, mint, hit):
    """Differentiable t of the winning instanced triangle (same detached-
    traversal / differentiable-recompute estimator as accel/bvh.py)."""
    from ..shapes import triangle as trimod
    _, _, _, _, p0, p1, p2, _ = _world_verts(inst, code)
    t, _, _, valid = trimod.intersect_pairs(
        p0, p1, p2, o, d, mint, jnp.full(mint.shape, _BIG))
    return t, valid & hit


def hit_geometry(inst: InstanceTable, code, o, d, t):
    """DifferentialGeometry for instanced hits: object-space prototype
    triangle transformed to world (mirrors triangle.differential_geometry;
    normals via the inverse-transpose)."""
    from ..shapes import triangle as trimod
    ii, tid, o2w_c, w2o_c, p0, p1, p2, i3 = _world_verts(inst, code)
    _, b1, b2, _ = trimod.intersect_pairs(
        p0, p1, p2, o, d, jnp.full(t.shape, -_BIG),
        jnp.full(t.shape, _BIG))
    b0 = 1.0 - b1 - b2
    uv0 = inst.uv[i3[..., 0]]
    uv1 = inst.uv[i3[..., 1]]
    uv2 = inst.uv[i3[..., 2]]
    p = o + t[..., None] * d
    u = b0 * uv0[..., 0] + b1 * uv1[..., 0] + b2 * uv2[..., 0]
    v = b0 * uv0[..., 1] + b1 * uv1[..., 1] + b2 * uv2[..., 1]

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
    ng_raw = vm.cross(p1 - p0, p2 - p0)
    _, fu, fv = vm.coordinate_system(vm.normalize(ng_raw))
    dpdu = jnp.where(degen[..., None], fu, dpdu)
    dpdv = jnp.where(degen[..., None], fv, dpdv)

    # Mirror instances swap handedness: fold the per-instance sign so
    # orientation matches the duplication path (ctm @ sctm flip).
    flip = inst.flip_normal[tid] * inst.inst_sign[ii]
    nn = vm.normalize(vm.cross(dpdu, dpdv)) * flip[..., None]

    has_n = inst.has_normals[tid]
    # Shading normals: object space -> world via inverse transpose.
    n0 = tf.rows_apply_normal(w2o_c, inst.normals[i3[..., 0]])
    n1 = tf.rows_apply_normal(w2o_c, inst.normals[i3[..., 1]])
    n2 = tf.rows_apply_normal(w2o_c, inst.normals[i3[..., 2]])
    ns = vm.normalize(b0[..., None] * n0 + b1[..., None] * n1 +
                      b2[..., None] * n2) * flip[..., None]
    ns = jnp.where(has_n[..., None], ns, nn)
    ss = vm.normalize(dpdu)
    ts = vm.normalize(vm.cross(ns, ss))
    ss = vm.cross(ts, ns)
    # dndu/dndv of the world-space shading normals from the uv deltas
    # (trianglemesh.cpp:104-123 semantics; the reference transforms the
    # prototype's dn by the instance transform, core/primitive.cpp:75-85 —
    # equivalent to differencing the already-transformed normals).
    dn1 = n0 - n2
    dn2 = n1 - n2
    dndu = (dv2[..., None] * dn1 - dv1[..., None] * dn2) * invdet[..., None]
    dndv = (-du2[..., None] * dn1 + du1[..., None] * dn2) * invdet[..., None]
    zero = jnp.zeros_like(dndu)
    bad = degen | ~has_n
    dndu = jnp.where(bad[..., None], zero, dndu)
    dndv = jnp.where(bad[..., None], zero, dndv)
    if inst.tri_emissive is not None and inst.inst_area_light is not None:
        # Instanced area emitters: the hit's light id is this instance's
        # own LightTable row (AREA_GEOM_INST; each instance is a distinct
        # light with shared object-space geometry).
        area_light = jnp.where(inst.tri_emissive[tid],
                               inst.inst_area_light[ii],
                               jnp.full_like(tid, -1))
    else:
        area_light = jnp.full_like(tid, -1)
    return dict(p=p, nn=nn, sn=ns, ss=ss, ts=ts, u=u, v=v,
                dpdu=dpdu, dpdv=dpdv, dndu=dndu, dndv=dndv,
                material=inst.material[tid],
                area_light=area_light)

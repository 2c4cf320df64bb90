"""Device-side uniform-grid DDA traversal.

Replacement for GridAccel::Intersect
(/root/reference/accelerators/grid.cpp:206-310): the 3D DDA with
NextCrossingT/DeltaT/Step/Out per axis becomes a batched lax.while_loop over
per-lane register state; the per-voxel prim loop is a masked fori over the
voxel's CSR range. The reference's ray mailboxing (grid.cpp:33-40) is
dropped — duplicate tests are cheap vector lanes here and mailboxes would
serialize.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import vecmath as vm
from ..scene.data import GridAccel, SceneData
from ..shapes import quadrics, triangle

_BIG = jnp.float32(1e30)


def _test_prims(scene: SceneData, pid, o, d, mint, maxt, active):
    """Test each lane's single candidate prim id; (t, valid)."""
    nq = scene.quadrics.count
    nt = scene.triangles.count
    t_out = jnp.full(pid.shape, _BIG)
    valid = jnp.zeros(pid.shape, bool)
    if nq:
        qid = jnp.clip(pid, 0, nq - 1)
        tq, vq = quadrics.intersect_gathered(
            scene.quadrics, qid, o, d, mint, maxt,
            scene.quadrics.kinds_present or quadrics.ALL_QUADRIC_KINDS)
        is_q = pid < nq
        t_out = jnp.where(is_q, tq, t_out)
        valid = jnp.where(is_q, vq, valid)
    if nt:
        tid = jnp.clip(pid - nq, 0, nt - 1)
        p0, p1, p2 = triangle.gather_verts(scene.triangles, tid)
        tt, _, _, vt = triangle.intersect_pairs(p0, p1, p2, o, d, mint, maxt)
        is_t = pid >= nq
        t_out = jnp.where(is_t, tt, t_out)
        valid = jnp.where(is_t, vt, valid)
    valid = valid & active
    return jnp.where(valid, t_out, _BIG), valid


def intersect(scene: SceneData, o, d, mint, maxt):
    """Nearest-hit via grid DDA. Returns (t[N], prim_id[N], hit[N]).

    The traversal (a while_loop) runs detached; the winning prim's t is then
    recomputed differentiably — the standard detached-discrete /
    attached-continuous estimator, so geometry gradients flow through the
    hit distance exactly as in the brute-force path.
    """
    grid: GridAccel = scene.accel
    o_d, d_d, mint_d, maxt_d = o, d, mint, maxt
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    mint = jax.lax.stop_gradient(mint)
    maxt = jax.lax.stop_gradient(maxt)
    nx, ny, nz = grid.nvoxels
    res = jnp.asarray([nx, ny, nz], jnp.int32)
    n = o.shape[0]

    # Clip ray to grid bounds (grid.cpp:211-218).
    inside0 = jnp.all((o >= grid.bounds_lo) & (o <= grid.bounds_hi), -1)
    hit_b, t0, t1 = vm.bbox_intersect_p(grid.bounds_lo, grid.bounds_hi,
                                        o, d, mint, maxt)
    ray_t = jnp.where(inside0, mint, t0)
    enter_ok = inside0 | hit_b

    grid_isect = o + ray_t[..., None] * d
    # Per-axis DDA setup (grid.cpp:219-238).
    pos_f = (grid_isect - grid.bounds_lo) * grid.inv_width
    pos = jnp.clip(pos_f.astype(jnp.int32), 0, res - 1)
    d_safe = jnp.where(jnp.abs(d) < 1e-12,
                       jnp.where(d < 0, -1e-12, 1e-12), d)
    inv_d = 1.0 / d_safe
    step = jnp.where(d >= 0, 1, -1)
    next_vox = jnp.where(d >= 0, pos + 1, pos)
    # Absolute ray parameter of the next boundary crossing per axis
    # (grid.cpp:228-237 computes rayT + (boundary - gridIntersect)/d — the
    # same value measured from the origin).
    next_crossing = (grid.bounds_lo + next_vox.astype(jnp.float32) *
                     grid.width - o) * inv_d
    delta_t = jnp.abs(grid.width * inv_d)
    out = jnp.where(d >= 0, res, -1)

    max_pv = max(grid.max_per_voxel, 1)

    def voxel_test(pos, best_t, best_id, active, maxt_cur):
        vox = pos[..., 0] + pos[..., 1] * nx + pos[..., 2] * nx * ny
        vox = jnp.clip(vox, 0, nx * ny * nz - 1)
        start = grid.cell_start[vox]
        end = grid.cell_start[vox + 1]

        def body(j, carry):
            bt, bi = carry
            slot = start + j
            in_range = (slot < end) & active
            pid = grid.prim_ids[jnp.clip(slot, 0, grid.prim_ids.shape[0] - 1)]
            t, valid = _test_prims(scene, pid, o, d, mint,
                                   jnp.minimum(maxt_cur, bt), in_range)
            upd = valid & (t < bt)
            bt = jnp.where(upd, t, bt)
            bi = jnp.where(upd, pid, bi)
            return bt, bi

        return jax.lax.fori_loop(0, max_pv, body, (best_t, best_id))

    def cond(state):
        pos, nc, best_t, best_id, active = state
        return jnp.any(active)

    def body(state):
        pos, nc, best_t, best_id, active = state
        best_t, best_id = voxel_test(pos, best_t, best_id, active, maxt)
        # Step axis = argmin NextCrossingT (branchless LUT equivalent,
        # grid.cpp:274-284).
        axis = jnp.argmin(nc, axis=-1)

        def ax_comp(v):
            # One-hot select; take_along_axis over the size-3 minor axis
            # lowers to a DMA gather ~100x slower than 3 selects.
            return jnp.where(axis == 0, v[..., 0],
                             jnp.where(axis == 1, v[..., 1], v[..., 2]))

        t_next = jnp.minimum(jnp.minimum(nc[..., 0], nc[..., 1]),
                             nc[..., 2])
        # Done if a hit before the next voxel crossing, or leaving grid.
        found = best_t < t_next
        onehot = jax.nn.one_hot(axis, 3, dtype=jnp.int32)
        new_pos = pos + onehot * step
        leaving = ax_comp(new_pos) == ax_comp(out)
        past_end = t_next > maxt
        active = active & ~found & ~leaving & ~past_end
        nc = nc + onehot.astype(nc.dtype) * delta_t
        pos = jnp.where(active[..., None], new_pos, pos)
        return pos, nc, best_t, best_id, active

    init = (pos, next_crossing, jnp.full((n,), _BIG),
            jnp.full((n,), -1, jnp.int32), enter_ok)
    _, _, best_t, best_id, _ = jax.lax.while_loop(cond, body, init)
    hit = best_id >= 0
    # Differentiable recompute of t at the (detached) winning prim.
    t_diff, valid = _test_prims(scene, jnp.maximum(best_id, 0), o_d, d_d,
                                mint_d, maxt_d * 0 + _BIG, hit)
    t_out = jnp.where(hit & valid, t_diff, _BIG)
    return t_out, best_id, hit

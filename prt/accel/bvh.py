"""Device-side wide skip-link BVH traversal.

The accelerator traversal of the reference
(/root/reference/accelerators/kdtree.cpp:313-402, grid.cpp:239-284) as a
stackless link walk over preorder rows (accel/bvh_build.py; the walk
itself is ops/bvh_walk.py): next = entered interior box ? node + 1 : skip.
Leaves carry their triangles inline, so a visit reads one row.

On a GPU the walk runs as a Pallas kernel, one ray per thread; on the CPU
it runs as the jnp reference. Trees that hold quadrics take the jnp walk
on every platform, with the generic per-prim tester in the leaves (the
kernel tests inlined triangles only). Like the grid/kd paths, traversal
runs detached and the winning prim's t is recomputed differentiably.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import bvh_walk
from ..scene.data import BvhAccel, SceneData

_BIG = jnp.float32(1e30)


def intersect(scene: SceneData, o, d, mint, maxt, any_hit: bool = False):
    """Nearest-hit (t, prim_id, hit); any_hit short-circuits (IntersectP)."""
    bvh: BvhAccel = scene.accel
    o_d, d_d, mint_d, maxt_d = o, d, mint, maxt
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    mint = jax.lax.stop_gradient(mint)
    maxt = jax.lax.stop_gradient(maxt)
    from .grid import _test_prims

    if bvh_walk.use_kernel(bvh.traversal) and bvh.n_quadrics == 0:
        _, best_id = bvh_walk.traverse(bvh.nodes, o, d, mint, maxt,
                                       nn=bvh.n_nodes, leaf_k=bvh.leaf_k,
                                       any_hit=any_hit)
    else:
        leaf_test = None
        if bvh.n_quadrics:
            def leaf_test(pid, in_leaf, tmax):
                return _test_prims(scene, jnp.maximum(pid, 0), o, d, mint,
                                   tmax, in_leaf)
        _, best_id = bvh_walk.walk_rays(
            bvh.nodes, o, d, mint, maxt, nn=bvh.n_nodes, leaf_k=bvh.leaf_k,
            any_hit=any_hit, leaf_test=leaf_test)
    hit = best_id >= 0

    # Differentiable recompute of the winning prim's t (same estimator as
    # the grid/kd paths).
    t_diff, valid = _test_prims(scene, jnp.maximum(best_id, 0), o_d, d_d,
                                mint_d, maxt_d * 0 + _BIG, hit)
    t_out = jnp.where(hit & valid, t_diff, _BIG)
    return t_out, best_id, hit

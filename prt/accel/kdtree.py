"""Device-side kd-tree traversal: stackless kd-restart.

Replacement for KdTreeAccel::Intersect
(/root/reference/accelerators/kdtree.cpp:313-402). The reference walks the
tree with a 64-entry per-ray todo stack; per-lane stacks need scatters on a
vector machine, so each lane instead re-descends from the root with an
advancing parametric window [t0, t1] (classic kd-restart): descend to the
leaf containing t0 (clamping t1 at each split plane), test its prims,
then advance t0 past the leaf and restart. Leaves are visited strictly
front-to-back, so the first hit with t <= leaf exit is the nearest hit.
Everything is gathers + masked arithmetic — no divergence, no stacks.

Mailboxing (kdtree.cpp:28-35) is dropped: duplicate prim tests for
straddling prims are cheap vector lanes; front-to-back early exit bounds
them.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import vecmath as vm
from ..scene.data import KdTreeAccel, SceneData

_BIG = jnp.float32(1e30)


def _descend(kd: KdTreeAccel, o, inv_d, t0, t1):
    """Walk each lane from the root to the leaf containing window start t0,
    clamping t1 to the first split plane beyond t0. Returns (leaf, t1)."""

    def step(_, carry):
        node, t1c = carry
        flags = kd.node_flags[node]
        interior = flags < 3
        axis = jnp.minimum(flags, 2)
        split = kd.node_split[node]
        # One-hot selects (take_along_axis over a size-3 minor axis lowers
        # to a DMA gather that costs more than the whole descend step).
        def ax_comp(v):
            return jnp.where(axis == 0, v[..., 0],
                             jnp.where(axis == 1, v[..., 1], v[..., 2]))
        o_a = ax_comp(o)
        inv_a = ax_comp(inv_d)
        tplane = (split - o_a) * inv_a
        # Near child by origin sidedness (kdtree.cpp:348-351 semantics).
        d_a_neg = inv_a < 0.0
        below_first = (o_a < split) | ((o_a == split) & d_a_neg)
        below = node + 1
        above = kd.node_above[node]
        near = jnp.where(below_first, below, above)
        far = jnp.where(below_first, above, below)
        # tplane <= 0: moving away from the plane -> stay in near.
        # tplane <= t0: window starts beyond the plane -> far child.
        # tplane >= t1: window ends before the plane -> near child.
        # else: near child with window clamped at the plane.
        far_only = (tplane > 0.0) & (tplane <= t0)
        clamp = (tplane > 0.0) & (tplane > t0) & (tplane < t1c)
        child = jnp.where(far_only, far, near)
        node = jnp.where(interior, child, node)
        t1c = jnp.where(interior & clamp, tplane, t1c)
        return node, t1c

    node0 = jnp.zeros(t0.shape, jnp.int32)
    return jax.lax.fori_loop(0, kd.max_depth, step, (node0, t1))


def intersect(scene: SceneData, o, d, mint, maxt, any_hit: bool = False):
    """Nearest-hit (t, prim_id, hit) via kd-restart; any_hit stops at the
    first confirmed hit (shadow rays, IntersectP kdtree.cpp:405-483).

    Traversal runs detached; the winning prim's t is recomputed
    differentiably (same estimator as accel/grid.py)."""
    from .grid import _test_prims  # shared leaf prim tester

    kd: KdTreeAccel = scene.accel
    o_d, d_d, mint_d, maxt_d = o, d, mint, maxt
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    mint = jax.lax.stop_gradient(mint)
    maxt = jax.lax.stop_gradient(maxt)
    n = o.shape[0]

    inside0 = jnp.all((o >= kd.bounds_lo) & (o <= kd.bounds_hi), -1)
    hit_b, t0b, t1b = vm.bbox_intersect_p(kd.bounds_lo, kd.bounds_hi,
                                          o, d, mint, maxt)
    tstart = jnp.where(inside0, mint, t0b)
    tend = jnp.minimum(t1b, maxt)
    enter_ok = (inside0 | hit_b) & (tstart <= tend)

    d_safe = jnp.where(jnp.abs(d) < 1e-12,
                       jnp.where(d < 0, -1e-12, 1e-12), d)
    inv_d = 1.0 / d_safe

    def cond(state):
        return jnp.any(state[3])

    def body(state):
        t0, best_t, best_id, active = state
        leaf, t1 = _descend(kd, o, inv_d, t0, tend)
        offset = kd.node_above[leaf]
        count = kd.node_nprims[leaf]

        def prim_body(j, carry):
            bt, bi = carry
            slot = offset + j
            in_range = (j < count) & active
            pid = kd.prim_ids[jnp.clip(slot, 0, kd.prim_ids.shape[0] - 1)]
            t, valid = _test_prims(scene, pid, o, d, mint,
                                   jnp.minimum(maxt, bt), in_range)
            upd = valid & (t < bt)
            return jnp.where(upd, t, bt), jnp.where(upd, pid, bi)

        best_t, best_id = jax.lax.fori_loop(0, kd.max_leaf_prims, prim_body,
                                            (best_t, best_id))
        # Front-to-back: a hit at or before the leaf exit is the nearest.
        done = best_t <= t1 * (1.0 + 1e-6) + 1e-7
        if any_hit:
            done = done | (best_id >= 0)
        t0 = jnp.maximum(t1, t0 + 1e-7)  # advance past this leaf
        active = active & ~done & (t0 < tend)
        return t0, best_t, best_id, active

    init = (tstart, jnp.full((n,), _BIG), jnp.full((n,), -1, jnp.int32),
            enter_ok)
    _, best_t, best_id, _ = jax.lax.while_loop(cond, body, init)
    hit = best_id >= 0
    t_diff, valid = _test_prims(scene, jnp.maximum(best_id, 0), o_d, d_d,
                                mint_d, maxt_d * 0 + _BIG, hit)
    t_out = jnp.where(hit & valid, t_diff, _BIG)
    return t_out, best_id, hit

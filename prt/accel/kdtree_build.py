"""Host-side SAH kd-tree construction.

Builds the flat-array kd-tree consumed by accel/kdtree.py. The build runs in
native C++ (prt/native/csrc/kdtree_build.cpp, the scene-compile analogue
of /root/reference/accelerators/kdtree.cpp:141-311) with a NumPy fallback
implementing the identical algorithm: per-axis sorted bound-edge SAH sweep
with empty-space bonus, longest-axis-first retry, bad-refine bailout, depth
cap 8 + 1.3*log2(N), defaults isect=80/trav=1/bonus=0.5/maxprims=1
(kdtree.cpp:489-498).
"""
from __future__ import annotations

import ctypes
import math

import numpy as np

from ..scene.data import KdTreeAccel, SceneData
from .grid_build import _prim_bounds


def _build_numpy(lo, hi, isect_cost, trav_cost, empty_bonus, max_prims,
                 max_depth):
    """Pure-NumPy SAH build: same algorithm as the native builder.

    Nodes are allocated in DFS-preorder so the below child is always
    node+1 and node_above is patched after the below subtree completes
    (matching the recursion of kdtree.cpp:300-311); empty children are
    created, never collapsed into a parent leaf (kdtree.cpp:292-311 —
    the empty-space bonus rewards exactly those splits)."""
    n = len(lo)
    if max_depth <= 0:
        max_depth = int(round(8 + 1.3 * math.log2(max(n, 2))))
    max_depth = min(max_depth, 60)

    node_flags, node_split, node_above, node_nprims = [], [], [], []
    prim_ids = []
    max_leaf = [0]
    max_depth_seen = [0]

    def make_leaf(node, prims):
        node_flags[node] = 3
        node_above[node] = len(prim_ids)
        node_nprims[node] = len(prims)
        prim_ids.extend(int(p) for p in prims)
        max_leaf[0] = max(max_leaf[0], len(prims))

    # Worklist DFS with preorder node ids: each popped task allocates the
    # next node index, so pushing the below child last (popped first) makes
    # below == node+1 by construction; the above child's id is unknown until
    # the whole below subtree is built, so the task carries the parent index
    # to patch (`patch`) and fills node_above[parent] when popped.
    blo = lo.min(0)
    bhi = hi.max(0)
    stack = [(blo, bhi, np.arange(n), 0, 0, -1)]
    while stack:
        nblo, nbhi, prims, depth, bad, patch = stack.pop()
        node = len(node_flags)
        node_flags.append(3)
        node_split.append(0.0)
        node_above.append(0)
        node_nprims.append(0)
        if patch >= 0:
            node_above[patch] = node
        max_depth_seen[0] = max(max_depth_seen[0], depth)
        np_ = len(prims)
        if np_ <= max_prims or depth >= max_depth:
            make_leaf(node, prims)
            continue

        d = (nbhi - nblo).astype(np.float32)
        inv_sa = np.float32(1.0) / np.float32(
            max(2.0 * (d[0] * d[1] + d[0] * d[2] + d[1] * d[2]), 1e-30))
        old_cost = isect_cost * np_
        best = (1e30, -1, 0.0)  # cost, axis, t
        axis0 = int(np.argmax(d))
        for attempt in range(3):
            axis = (axis0 + attempt) % 3
            # Edge list sorted by t, starts before ends at ties
            # (BoundEdge::operator<, kdtree.cpp: START(0) < END(1)).
            starts = lo[prims, axis]
            ends = hi[prims, axis]
            ts = np.concatenate([starts, ends])
            is_start = np.concatenate([np.ones(np_, bool),
                                       np.zeros(np_, bool)])
            order = np.lexsort(((~is_start).astype(np.int8), ts))
            ts = ts[order]
            is_start = is_start[order]
            n_below = (np.cumsum(is_start) - is_start)   # before this edge
            n_above = np_ - (np.cumsum(~is_start))       # after this edge
            o0, o1 = (axis + 1) % 3, (axis + 2) % 3
            valid = (ts > nblo[axis]) & (ts < nbhi[axis])
            # f32 arithmetic in the same association as the native builder
            # so both produce bit-identical trees (tested in test_kdtree).
            two = np.float32(2.0)
            sa_b = two * (d[o0] * d[o1] + (ts - nblo[axis]) * (d[o0] + d[o1]))
            sa_a = two * (d[o0] * d[o1] + (nbhi[axis] - ts) * (d[o0] + d[o1]))
            pb = sa_b * inv_sa
            pa = sa_a * inv_sa
            eb = np.where((n_above == 0) | (n_below == 0),
                          np.float32(empty_bonus), np.float32(0.0))
            cost = np.float32(trav_cost) + np.float32(isect_cost) * \
                (np.float32(1.0) - eb) * \
                (pb * n_below.astype(np.float32) +
                 pa * n_above.astype(np.float32))
            cost = np.where(valid, cost, np.float32(1e30))
            i = int(np.argmin(cost))
            if cost[i] < best[0]:
                best = (float(cost[i]), axis, float(ts[i]))
            if best[1] != -1:
                break
        best_cost, best_axis, best_t = best
        if best_cost > old_cost:
            bad += 1
        if (best_cost > 4 * old_cost and np_ < 16) or best_axis == -1 or \
                bad == 3:
            make_leaf(node, prims)
            continue
        # Geometric split classification (kdtree.cpp:292-299): straddlers go
        # to both sides; planar prims exactly on the plane go below.
        plo = lo[prims, best_axis]
        phi = hi[prims, best_axis]
        below = prims[(plo < best_t) | (phi <= best_t)]
        above = prims[phi > best_t]

        node_flags[node] = best_axis
        node_split[node] = best_t
        bhi_b = nbhi.copy()
        bhi_b[best_axis] = best_t
        blo_a = nblo.copy()
        blo_a[best_axis] = best_t
        # below pushed last -> popped next -> node+1, preorder.
        stack.append((blo_a, nbhi, above, depth + 1, bad, node))
        stack.append((nblo, bhi_b, below, depth + 1, bad, -1))

    return (np.asarray(node_flags, np.int32), np.asarray(node_split,
                                                         np.float32),
            np.asarray(node_above, np.int32), np.asarray(node_nprims,
                                                         np.int32),
            np.asarray(prim_ids if prim_ids else [0], np.int32),
            max_leaf[0], max_depth_seen[0], blo, bhi)


def _build_native(lo, hi, isect_cost, trav_cost, empty_bonus, max_prims,
                  max_depth):
    from .. import native
    lib = native.load("kdtree_build")
    if lib is None:
        return None
    n = len(lo)
    fn = lib.prt_kdtree_build
    fn.restype = ctypes.c_int
    node_cap = max(4 * n + 16, 512)
    idx_cap = max(16 * n + 16, 1024)
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    fn.argtypes = [ctypes.c_int, f32p, f32p, ctypes.c_float, ctypes.c_float,
                   ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   i32p, f32p, i32p, i32p, i32p,
                   ctypes.c_int, ctypes.c_int, i32p]
    lo32 = np.ascontiguousarray(lo, np.float32)
    hi32 = np.ascontiguousarray(hi, np.float32)
    for _ in range(4):  # grow caps on overflow
        flags = np.zeros(node_cap, np.int32)
        split = np.zeros(node_cap, np.float32)
        above = np.zeros(node_cap, np.int32)
        nprims = np.zeros(node_cap, np.int32)
        ids = np.zeros(idx_cap, np.int32)
        counts = np.zeros(4, np.int32)
        r = fn(n, lo32, hi32, isect_cost, trav_cost, empty_bonus, max_prims,
               max_depth, flags, split, above, nprims, ids, node_cap,
               idx_cap, counts)
        if r >= 0:
            nn, ni = int(counts[0]), int(counts[1])
            return (flags[:nn], split[:nn], above[:nn], nprims[:nn],
                    ids[:max(ni, 1)], int(counts[2]), int(counts[3]),
                    lo32.min(0).astype(np.float64),
                    hi32.max(0).astype(np.float64))
        node_cap *= 4
        idx_cap *= 4
    return None


def build_kdtree(scene: SceneData, isect_cost=80.0, trav_cost=1.0,
                 empty_bonus=0.5, max_prims=1, max_depth=-1,
                 force_numpy=False) -> KdTreeAccel:
    lo, hi = _prim_bounds(scene)
    out = None
    if not force_numpy:
        out = _build_native(lo, hi, isect_cost, trav_cost, empty_bonus,
                            max_prims, max_depth)
    if out is None:
        out = _build_numpy(lo.astype(np.float32), hi.astype(np.float32),
                           isect_cost, trav_cost, empty_bonus, max_prims,
                           max_depth)
    flags, split, above, nprims, ids, max_leaf, depth_seen, blo, bhi = out
    pad = 1e-4 * np.maximum(np.abs(blo), np.abs(bhi)).max() + 1e-4
    # device_put (no XLA compile): eager consumers index these with
    # traced lane values inside lax loops, which numpy leaves reject.
    import jax
    dp = jax.device_put
    return KdTreeAccel(
        bounds_lo=dp(np.asarray(blo - pad, np.float32)),
        bounds_hi=dp(np.asarray(bhi + pad, np.float32)),
        node_flags=dp(np.asarray(flags)),
        node_split=dp(np.asarray(split)),
        node_above=dp(np.asarray(above)),
        node_nprims=dp(np.asarray(nprims)),
        prim_ids=dp(np.asarray(ids)),
        max_depth=max(int(depth_seen) + 1, 1),
        max_leaf_prims=max(int(max_leaf), 1),
    )

"""Host-side construction of the wide (8-ary) skip-link BVH.

The replacement for the reference's recursive-stack accelerators
(/root/reference/accelerators/kdtree.cpp:141-311, grid.cpp:83-310): a
preorder tree with *skip links* (next = hit ? node+1 : skip — a pure link
walk, no stack, no kd-restart re-descends) made of SELF-CONTAINED 96-float
rows, so one visit reads exactly ONE row:

    row = [lo(3), hi(3), skip, nprims,
           8 x 9 packed leaf triangle vertices (72),
           8 global prim ids, pad]   -> f32[NN, 96]

Interior rows use only the first 8 columns; leaf rows carry their <=8
triangles inline (no prim_ids -> idx -> verts indirection chain). Branching
factor 8 + 8-prim leaves cut the visited-node count ~4x vs a binary tree
of 4-prim leaves.

Build: prims are sorted by the Morton code of their AABB centroid, and
ranges split at the highest-differing-bit boundary (Karras-style radix
tree, the LBVH construction) — spatially aligned boxes, fully
host-vectorized except a shallow recursion over ~nodes. Three radix levels
collapse into each 8-ary node.
"""
from __future__ import annotations

import sys

import numpy as np

from ..scene.data import BvhAccel, SceneData
from .grid_build import _prim_bounds

LEAF_K = 8
BRANCH = 8
ROW_W = 96


def _morton3(x, y, z):
    """Interleave 21-bit quantized coords into 63-bit Morton codes."""
    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 32)) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << 16)) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << 8)) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << 4)) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << 2)) & np.uint64(0x1249249249249249)
        return v
    return (spread(x) << np.uint64(2)) | (spread(y) << np.uint64(1)) | \
        spread(z)


def _radix_split(codes, a, b):
    """Split [a,b) at the highest-differing-Morton-bit boundary (falls back
    to the midpoint when all codes agree). Returns (mid, axis) — axis is
    the world axis of the split bit (Morton interleave x<<2|y<<1|z)."""
    ca = int(codes[a])
    cb = int(codes[b - 1])
    if ca == cb:
        return (a + b) // 2, 0
    hb = (ca ^ cb).bit_length() - 1
    threshold = (ca & ~((1 << (hb + 1)) - 1)) | (1 << hb)
    m = a + int(np.searchsorted(codes[a:b], threshold))
    if m <= a or m >= b:
        m = (a + b) // 2
    return m, 2 - (hb % 3)


def _split_children(codes, a, b):
    """BRANCH rank-indexed child slots of [a,b): three radix-split levels.

    Returns (slots, axes): slots is a list of 8 (s, e) ranges (empty ones
    are (s, s)) whose 3-bit rank encodes which side of each split level
    the child lies on — an ordered walk would XOR the rank with the ray's
    direction signs along `axes` (the Z-order near-first trick; no walk
    reads them today). Unsplittable sub-ranges stay on the 0 branch of
    their level."""
    ranges = [(a, b)]
    axes = []
    for lvl in range(3):
        nxt = []
        lvl_axis = 0
        for (s, e) in ranges:
            if e - s <= LEAF_K or e <= s:
                nxt.append((s, e))
                nxt.append((e, e))
            else:
                m, ax = _radix_split(codes, s, e)
                lvl_axis = ax
                nxt.append((s, m))
                nxt.append((m, e))
        ranges = nxt
        axes.append(lvl_axis)
    return ranges, axes


def _build_native_sah(lo, hi, nq, tri9, p):
    """Binned-SAH wide-BVH via the native C++ builder
    (native/csrc/bvh_build8.cpp). Returns (rows, prim_ids, nn) or None
    (no toolchain / compile failure -> Python LBVH fallback)."""
    import ctypes
    from ..native import load
    lib = load("bvh_build8")
    if lib is None:
        return None
    fn = lib.prt_bvh_build8
    fn.restype = ctypes.c_int
    fptr = ctypes.POINTER(ctypes.c_float)
    iptr = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [ctypes.c_int, fptr, fptr, ctypes.c_int, ctypes.c_int,
                   fptr, ctypes.c_int, fptr, ctypes.c_int, iptr]
    lo_c = np.ascontiguousarray(lo, np.float32)
    hi_c = np.ascontiguousarray(hi, np.float32)
    tri9_c = np.ascontiguousarray(tri9, np.float32)
    cap = max(p // 2 + 64, 64)
    while True:
        rows = np.zeros((cap, ROW_W), np.float32)
        prim_ids = np.full((cap, LEAF_K), -1, np.int32)
        nn = fn(p, lo_c.ctypes.data_as(fptr), hi_c.ctypes.data_as(fptr),
                nq, len(tri9_c), tri9_c.ctypes.data_as(fptr), LEAF_K,
                rows.ctypes.data_as(fptr), cap,
                prim_ids.ctypes.data_as(iptr))
        if nn == -1:
            cap *= 2
            continue
        if nn < 0:
            return None
        return rows[:nn], prim_ids[:nn], nn


def build_rows(lo, hi, nq, tri9):
    """Array-level wide-BVH build over prim AABBs (quadrics first, then
    triangles with packed verts tri9): native binned SAH when the
    toolchain exists, Python Morton LBVH otherwise. Returns
    (rows f32[NN,96], prim_ids i32[NN,LEAF_K], nn). Shared by the scene
    BVH (build_bvh) and per-prototype BLAS builds (accel/instances.py)."""
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    p = len(lo)
    # Prim ids and node-count fields ride in f32 node rows: ids above 2^24
    # are unrepresentable there (silent traversal corruption beyond).
    assert p < (1 << 24), f"{p} prims exceeds the f32-id row format"
    native = _build_native_sah(lo, hi, nq, tri9, p)
    if native is not None:
        assert native[2] < (1 << 24)
        return native
    return _build_python_lbvh(lo, hi, nq, tri9)


def build_bvh(scene: SceneData) -> BvhAccel:
    lo, hi = _prim_bounds(scene)
    lo = lo.astype(np.float32)
    hi = hi.astype(np.float32)
    nq = scene.quadrics.count

    # Packed world-space triangle rows for leaf inlining.
    tri = scene.triangles
    if tri.count:
        idx = np.asarray(tri.idx)
        verts = np.asarray(tri.verts)
        tri9 = np.concatenate([verts[idx[:, 0]], verts[idx[:, 1]],
                               verts[idx[:, 2]]], axis=1).astype(np.float32)
    else:
        tri9 = np.zeros((1, 9), np.float32)

    rows, prim_ids, nn = build_rows(lo, hi, nq, tri9)
    import jax
    dp = jax.device_put
    return BvhAccel(nodes=dp(rows), prim_ids=dp(prim_ids.reshape(-1)),
                    n_nodes=nn, leaf_k=LEAF_K, n_quadrics=nq)


def _build_python_lbvh(lo, hi, nq, tri9):
    p = len(lo)
    # Python LBVH fallback: Morton order of centroids.
    c = 0.5 * (lo + hi)
    cmin = c.min(0)
    cext = np.maximum(c.max(0) - cmin, 1e-12)
    q = np.clip(((c - cmin) / cext * ((1 << 21) - 1)), 0,
                (1 << 21) - 1).astype(np.uint32)
    order = np.argsort(_morton3(q[:, 0], q[:, 1], q[:, 2]),
                       kind="stable").astype(np.int32)
    codes = _morton3(q[order, 0], q[order, 1], q[order, 2])
    slo = lo[order]
    shi = hi[order]

    # Pass 1: subtree node counts (recursion mirrors pass 2 exactly).
    sys.setrecursionlimit(max(sys.getrecursionlimit(), 10000))

    _size_memo = {}

    def count_nodes(a, b):
        key = (a, b)
        got = _size_memo.get(key)
        if got is not None:
            return got
        if b - a <= LEAF_K:
            n = 1
        else:
            slots, _axes = _split_children(codes, a, b)
            n = 1 + sum(count_nodes(s, e) for (s, e) in slots if e > s)
        _size_memo[key] = n
        return n

    nn = count_nodes(0, p)
    rows = np.zeros((nn, ROW_W), np.float32)
    prim_ids = np.full((nn, LEAF_K), -1, np.int32)

    # Pass 2: preorder emission with threaded skip links.
    counter = [0]

    def emit(a, b, skip):
        node = counter[0]
        counter[0] += 1
        rows[node, 0:3] = slo[a:b].min(0)
        rows[node, 3:6] = shi[a:b].max(0)
        rows[node, 6] = skip
        if b - a <= LEAF_K:
            k = b - a
            rows[node, 7] = k
            ids = order[a:b]
            prim_ids[node, :k] = ids
            rows[node, 80:80 + k] = ids.astype(np.float32)
            # Inline triangle vertices (quadric prims keep zeros; the
            # traversal's mixed-scene path tests via prim ids instead).
            for j, gid in enumerate(ids):
                if gid >= nq:
                    rows[node, 8 + 9 * j: 17 + 9 * j] = tri9[gid - nq]
            return 1
        slots, axes = _split_children(codes, a, b)
        kids = [(r, (s, e)) for r, (s, e) in enumerate(slots) if e > s]
        sizes = [count_nodes(s, e) for _, (s, e) in kids]
        # Interior extras for an ordered (near-first) walk: rank-indexed
        # child preorder ids in cols 8..15 (-1 = empty rank) and the three
        # split-level axes in cols 16..18. The skip-link walk does not
        # read them.
        rows[node, 8:16] = -1.0
        rows[node, 16:19] = np.asarray(axes, np.float32)
        child_id = node + 1
        total = 1
        for i, ((rank, (s, e)), sz) in enumerate(zip(kids, sizes)):
            child_skip = child_id + sz if i + 1 < len(kids) else skip
            rows[node, 8 + rank] = child_id
            emit(s, e, child_skip)
            child_id += sz
            total += sz
        return total

    emit(0, p, nn)
    assert counter[0] == nn
    return rows, prim_ids, nn

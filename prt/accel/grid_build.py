"""Host-side uniform-grid accelerator construction.

Replacement for the GridAccel constructor
(/root/reference/accelerators/grid.cpp:121-190): the reference's resolution
heuristic 3*cbrt(N) voxels along the longest axis clamped to [1,64] per axis
(grid.cpp:146-151) and per-voxel primitive lists. Lazy refinement
(grid.cpp:291-310) is unnecessary — all meshes are already eagerly
tessellated at build. Output: flat CSR-style (cell_start, prim_ids) arrays
for the device DDA traversal in accel/grid.py.
"""
from __future__ import annotations

import numpy as np

from ..scene.data import GridAccel, SceneData


def _prim_bounds(scene: SceneData):
    """World AABBs for every prim (quadrics then triangles) as numpy."""
    los, his = [], []
    q = scene.quadrics
    nq = q.count
    if nq:
        o2w = np.asarray(q.o2w)
        params = np.asarray(q.params)
        kind = np.asarray(q.kind)
        for i in range(nq):
            # Conservative object-space box from params.
            k = kind[i]
            if k == 0:   # sphere
                r = params[i, 0]
                lo = np.array([-r, -r, params[i, 1]])
                hi = np.array([r, r, params[i, 2]])
            elif k == 1:  # cylinder
                r = params[i, 0]
                lo = np.array([-r, -r, params[i, 1]])
                hi = np.array([r, r, params[i, 2]])
            elif k == 2:  # disk
                r = params[i, 1]
                lo = np.array([-r, -r, params[i, 0] - 1e-4])
                hi = np.array([r, r, params[i, 0] + 1e-4])
            elif k == 3:  # cone
                r = params[i, 0]
                lo = np.array([-r, -r, 0.0])
                hi = np.array([r, r, params[i, 1]])
            elif k == 4:  # paraboloid
                r = params[i, 0]
                lo = np.array([-r, -r, min(params[i, 1], params[i, 2])])
                hi = np.array([r, r, max(params[i, 1], params[i, 2])])
            else:         # hyperboloid: loose box
                zr = max(abs(params[i, 2]), abs(params[i, 5])) + 1.0
                lo = np.array([-zr, -zr, min(params[i, 2], params[i, 5])])
                hi = np.array([zr, zr, max(params[i, 2], params[i, 5])])
            corners = np.array([[lo[0] if j & 1 else hi[0],
                                 lo[1] if j & 2 else hi[1],
                                 lo[2] if j & 4 else hi[2]]
                                for j in range(8)])
            wc = corners @ o2w[i][:3, :3].T + o2w[i][:3, 3]
            los.append(wc.min(0))
            his.append(wc.max(0))
    tri = scene.triangles
    if tri.count:
        verts = np.asarray(tri.verts)
        idx = np.asarray(tri.idx)
        p = verts[idx]                       # [T,3,3]
        los.extend(p.min(1))
        his.extend(p.max(1))
    return np.asarray(los, np.float64), np.asarray(his, np.float64)


def build_grid(scene: SceneData) -> GridAccel:
    los, his = _prim_bounds(scene)
    n = len(los)
    wlo = los.min(0) - 1e-4
    whi = his.max(0) + 1e-4
    delta = whi - wlo
    max_axis = int(np.argmax(delta))
    inv_max_width = 1.0 / max(delta[max_axis], 1e-9)
    cube_root = 3.0 * n ** (1.0 / 3.0)
    vpud = cube_root * inv_max_width
    res = np.clip(np.round(delta * vpud).astype(int), 1, 64)
    nx, ny, nz = int(res[0]), int(res[1]), int(res[2])
    width = delta / res
    inv_width = np.where(width == 0, 0.0, 1.0 / width)

    nvox = nx * ny * nz
    cells = [[] for _ in range(nvox)]
    to_vox = lambda p: np.clip(((p - wlo) * inv_width).astype(int), 0,
                               res - 1)
    for i in range(n):
        v0 = to_vox(los[i])
        v1 = to_vox(his[i])
        for z in range(v0[2], v1[2] + 1):
            for y in range(v0[1], v1[1] + 1):
                for x in range(v0[0], v1[0] + 1):
                    cells[x + y * nx + z * nx * ny].append(i)

    counts = np.array([len(c) for c in cells], np.int32)
    cell_start = np.zeros(nvox + 1, np.int32)
    cell_start[1:] = np.cumsum(counts)
    prim_ids = np.concatenate([np.asarray(c, np.int32) for c in cells]) \
        if cell_start[-1] else np.zeros(1, np.int32)
    # Tables go to the device here (device_put only, no XLA compile):
    # eager consumers index them with traced lane values inside lax loops.
    import jax
    dp = lambda x, t=np.float32: jax.device_put(np.asarray(x, t))
    return GridAccel(
        nvoxels=(nx, ny, nz),
        bounds_lo=dp(wlo),
        bounds_hi=dp(whi),
        width=dp(width),
        inv_width=dp(inv_width),
        cell_start=dp(cell_start, np.int32),
        prim_ids=dp(prim_ids, np.int32),
        max_per_voxel=int(counts.max()) if nvox else 0,
    )

"""Host-side tessellation of Refine-only shapes into triangle meshes.

Replacement for the lazy Refine() chains of
/root/reference/shapes/{loopsubdiv,nurbs,heightfield}.cpp — run eagerly at
scene build (the reference refines lazily inside accelerators; same
triangles, different time). Pure numpy.

  * heightfield: regular grid split into 2 triangles per cell with unit-square
    uv (heightfield.cpp:62-99).
  * loopsubdiv: Loop subdivision with the reference's exact weights —
    beta(3)=3/16 else 3/(8n) (loopsubdiv.cpp:125-128), boundary even rule
    1/8 (:282), regular-interior 1/16 one-ring, limit-surface projection
    with gamma(n)=1/(n+3/(8 beta)) and boundary 1/5 (:360-368).
  * nurbs: uniform-parameter evaluation of the rational B-spline surface
    (nurbs.cpp tessellates the same way with a fixed grid).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def tessellate(kind: str, params) -> Tuple[np.ndarray, np.ndarray,
                                           Optional[np.ndarray],
                                           Optional[np.ndarray]]:
    """Returns (P [V,3], indices [T,3], N or None, uv or None) object space."""
    if kind == "heightfield":
        return _heightfield(params)
    if kind == "loopsubdiv":
        return _loopsubdiv(params)
    if kind == "nurbs":
        return _nurbs(params)
    raise ValueError(kind)


def _heightfield(params):
    nx = params.find_one("nu", -1)
    ny = params.find_one("nv", -1)
    z = params.find_floats("Pz").reshape(ny, nx)
    xs, ys = np.meshgrid(np.arange(nx), np.arange(ny))
    P = np.stack([xs / (nx - 1), ys / (ny - 1), z], -1).reshape(-1, 3)
    uv = P[:, :2].copy()
    idx = []
    for y in range(ny - 1):
        for x in range(nx - 1):
            v = lambda xx, yy: xx + yy * nx
            idx.append([v(x, y), v(x + 1, y), v(x + 1, y + 1)])
            idx.append([v(x, y), v(x + 1, y + 1), v(x, y + 1)])
    return P.astype(np.float32), np.asarray(idx, np.int32), None, \
        uv.astype(np.float32)


# ---------------------------------------------------------------------------
# Loop subdivision
# ---------------------------------------------------------------------------

def _beta(n):
    return 3.0 / 16.0 if n == 3 else 3.0 / (8.0 * n)


def _gamma(n):
    return 1.0 / (n + 3.0 / (8.0 * _beta(n)))


def _loopsubdiv(params):
    nlevels = params.find_one("nlevels", 3)
    P = params.find_floats("P").reshape(-1, 3).astype(np.float64)
    idx = params.find_ints("indices").reshape(-1, 3)

    for _ in range(nlevels):
        P, idx = _subdivide_once(P, idx)
    P = _limit_surface(P, idx)
    return P.astype(np.float32), idx.astype(np.int32), None, None


def _build_adjacency(P, idx):
    nv = len(P)
    neighbors = [set() for _ in range(nv)]
    edge_faces: Dict[Tuple[int, int], list] = {}
    for fi, (a, b, c) in enumerate(idx):
        for u, v in ((a, b), (b, c), (c, a)):
            neighbors[u].add(v)
            neighbors[v].add(u)
            e = (min(u, v), max(u, v))
            edge_faces.setdefault(e, []).append(fi)
    boundary_v = np.zeros(nv, bool)
    boundary_edges = [e for e, fs in edge_faces.items() if len(fs) == 1]
    for (u, v) in boundary_edges:
        boundary_v[u] = boundary_v[v] = True
    return neighbors, edge_faces, boundary_v, set(boundary_edges)


def _subdivide_once(P, idx):
    neighbors, edge_faces, boundary_v, boundary_e = _build_adjacency(P, idx)
    nv = len(P)

    # Even (existing) vertices.
    newP = np.zeros_like(P)
    bnd_nbrs = [[] for _ in range(nv)]
    for (u, v) in boundary_e:
        bnd_nbrs[u].append(v)
        bnd_nbrs[v].append(u)
    for i in range(nv):
        ns = sorted(neighbors[i])
        n = len(ns)
        if not boundary_v[i]:
            b = _beta(n)
            newP[i] = (1 - n * b) * P[i] + b * P[ns].sum(0)
        else:
            bn = bnd_nbrs[i][:2]
            if len(bn) == 2:
                newP[i] = 0.75 * P[i] + 0.125 * (P[bn[0]] + P[bn[1]])
            else:
                newP[i] = P[i]

    # Odd (edge) vertices.
    edge_new: Dict[Tuple[int, int], int] = {}
    odd_pts = []
    # For interior edges we need the two opposite vertices.
    edge_opp: Dict[Tuple[int, int], list] = {}
    for (a, b, c) in idx:
        for u, v, w in ((a, b, c), (b, c, a), (c, a, b)):
            e = (min(u, v), max(u, v))
            edge_opp.setdefault(e, []).append(w)
    for e, opp in edge_opp.items():
        u, v = e
        if e in boundary_e or len(opp) < 2:
            p = 0.5 * (P[u] + P[v])
        else:
            p = 0.375 * (P[u] + P[v]) + 0.125 * (P[opp[0]] + P[opp[1]])
        edge_new[e] = nv + len(odd_pts)
        odd_pts.append(p)

    allP = np.concatenate([newP, np.asarray(odd_pts)]) if odd_pts else newP
    new_idx = []
    for (a, b, c) in idx:
        eab = edge_new[(min(a, b), max(a, b))]
        ebc = edge_new[(min(b, c), max(b, c))]
        eca = edge_new[(min(c, a), max(c, a))]
        new_idx.extend([[a, eab, eca], [b, ebc, eab],
                        [c, eca, ebc], [eab, ebc, eca]])
    return allP, np.asarray(new_idx, np.int64)


def _limit_surface(P, idx):
    """Push to the limit surface (loopsubdiv.cpp:358-368)."""
    neighbors, edge_faces, boundary_v, boundary_e = _build_adjacency(P, idx)
    out = P.copy()
    bnd_nbrs = [[] for _ in range(len(P))]
    for (u, v) in boundary_e:
        bnd_nbrs[u].append(v)
        bnd_nbrs[v].append(u)
    for i in range(len(P)):
        ns = sorted(neighbors[i])
        n = len(ns)
        if not boundary_v[i] and n > 0:
            g = _gamma(n)
            out[i] = (1 - n * g) * P[i] + g * P[ns].sum(0)
        elif boundary_v[i]:
            bn = bnd_nbrs[i][:2]
            if len(bn) == 2:
                out[i] = 0.6 * P[i] + 0.2 * (P[bn[0]] + P[bn[1]])
    return out


# ---------------------------------------------------------------------------
# NURBS
# ---------------------------------------------------------------------------

def _bspline_basis(i, k, t, knots):
    """Cox-de Boor recursive basis N_{i,k}(t)."""
    if k == 1:
        return 1.0 if knots[i] <= t < knots[i + 1] else 0.0
    d1 = knots[i + k - 1] - knots[i]
    d2 = knots[i + k] - knots[i + 1]
    a = 0.0 if d1 == 0 else (t - knots[i]) / d1 * _bspline_basis(i, k - 1, t, knots)
    b = 0.0 if d2 == 0 else (knots[i + k] - t) / d2 * \
        _bspline_basis(i + 1, k - 1, t, knots)
    return a + b


def _nurbs(params):
    nu = params.find_one("nu", -1)
    uorder = params.find_one("uorder", -1)
    uknots = params.find_floats("uknots")
    u0 = params.find_one("u0", float(uknots[uorder - 1]))
    u1 = params.find_one("u1", float(uknots[nu]))
    nv = params.find_one("nv", -1)
    vorder = params.find_one("vorder", -1)
    vknots = params.find_floats("vknots")
    v0 = params.find_one("v0", float(vknots[vorder - 1]))
    v1 = params.find_one("v1", float(vknots[nv]))
    Pw = params.find_floats("Pw")
    if Pw is not None:
        cp = Pw.reshape(nv, nu, 4).astype(np.float64)
    else:
        Pp = params.find_floats("P").reshape(nv, nu, 3).astype(np.float64)
        cp = np.concatenate([Pp, np.ones((nv, nu, 1))], -1)

    # Tessellation resolution: reference uses 1 + 2*max dims diced grid;
    # we use a 4x-refined uniform grid.
    nudiced = max(nu * 4, 16)
    nvdiced = max(nv * 4, 16)
    us = np.linspace(u0, u1 - 1e-6, nudiced)
    vs = np.linspace(v0, v1 - 1e-6, nvdiced)
    Bu = np.array([[_bspline_basis(i, uorder, u, uknots) for i in range(nu)]
                   for u in us])                       # [nud, nu]
    Bv = np.array([[_bspline_basis(j, vorder, v, vknots) for j in range(nv)]
                   for v in vs])                       # [nvd, nv]
    S = np.einsum("ui,vj,jik->vuk", Bu, Bv, cp)        # [nvd, nud, 4]
    w = np.maximum(S[..., 3:4], 1e-12)
    pts = (S[..., :3] / w).reshape(-1, 3)
    uu, vv = np.meshgrid(np.linspace(0, 1, nudiced), np.linspace(0, 1, nvdiced))
    uv = np.stack([uu, vv], -1).reshape(-1, 2)
    tris = []
    for y in range(nvdiced - 1):
        for x in range(nudiced - 1):
            v00 = y * nudiced + x
            tris.append([v00, v00 + 1, v00 + nudiced + 1])
            tris.append([v00, v00 + nudiced + 1, v00 + nudiced])
    return pts.astype(np.float32), np.asarray(tris, np.int32), None, \
        uv.astype(np.float32)

"""Texture graphs: static topology + device parameters, evaluated as a
straight-line unrolled program over shading wavefronts.

Replacement for the reference's `Texture<T>` virtual tree
(/root/reference/core/texture.{h,cpp}, textures/*.cpp). A pbrt texture is a
DAG (scale/mix nodes reference child textures); here the DAG is flattened at
scene build into a topologically-ordered node list. Node *structure* (kind,
children, mapping, image id) is static Python metadata — it defines the
traced program — while node *parameters* (constant colors, mapping scales,
world-to-texture matrices) are device arrays, so they are differentiable and
jit-stable.

Covered kinds: constant, scale, mix, bilerp, uv, checkerboard (2D none/
closedform, 3D), dots, fbm, wrinkled, windy, marble, imagemap. 2D mappings:
uv/spherical/cylindrical/planar with screen-space derivative propagation
(core/texture.cpp:63-155); 3D mapping: identity transform.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import jax.numpy as jnp

from ..core import transform as tf, vecmath as vm
from ..core.pytree import pytree_dataclass, static


class TexNodeMeta(NamedTuple):
    kind: str                     # node type
    children: Tuple[int, ...] = ()
    image: int = -1               # ImagePyramid index for imagemap
    mapping: str = "uv"           # uv|spherical|cylindrical|planar|3d
    float_from_y: bool = False    # float imagemap converts via luminance
    aamode: str = "closedform"    # checkerboard antialiasing
    trilinear: bool = False       # imagemap filtering (False = EWA)


@pytree_dataclass
class TexGraph:
    fparams: jnp.ndarray          # f32[N,16]
    w2t: jnp.ndarray              # f32[N,4,4]
    nodes: Tuple[TexNodeMeta, ...] = static(default=())


def empty_graph() -> TexGraph:
    return TexGraph(fparams=jnp.zeros((0, 16), jnp.float32),
                    w2t=jnp.zeros((0, 4, 4), jnp.float32), nodes=())


# ---------------------------------------------------------------------------
# Perlin noise (core/texture.cpp:156-239). Permutation is Ken Perlin's
# standard reference table (public-domain constants).
# ---------------------------------------------------------------------------

_PERM = np.array([
    151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7, 225,
    140, 36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6, 148,
    247, 120, 234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32,
    57, 177, 33, 88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175,
    74, 165, 71, 134, 139, 48, 27, 166, 77, 146, 158, 231, 83, 111, 229, 122,
    60, 211, 133, 230, 220, 105, 92, 41, 55, 46, 245, 40, 244, 102, 143, 54,
    65, 25, 63, 161, 1, 216, 80, 73, 209, 76, 132, 187, 208, 89, 18, 169,
    200, 196, 135, 130, 116, 188, 159, 86, 164, 100, 109, 198, 173, 186, 3, 64,
    52, 217, 226, 250, 124, 123, 5, 202, 38, 147, 118, 126, 255, 82, 85, 212,
    207, 206, 59, 227, 47, 16, 58, 17, 182, 189, 28, 42, 223, 183, 170, 213,
    119, 248, 152, 2, 44, 154, 163, 70, 221, 153, 101, 155, 167, 43, 172, 9,
    129, 22, 39, 253, 19, 98, 108, 110, 79, 113, 224, 232, 178, 185, 112, 104,
    218, 246, 97, 228, 251, 34, 242, 193, 238, 210, 144, 12, 191, 179, 162, 241,
    81, 51, 145, 235, 249, 14, 239, 107, 49, 192, 214, 31, 181, 199, 106, 157,
    184, 84, 204, 176, 115, 121, 50, 45, 127, 4, 150, 254, 138, 236, 205, 93,
    222, 114, 67, 29, 24, 72, 243, 141, 128, 195, 78, 66, 215, 61, 156, 180,
], np.int32)
_NOISE_PERM = jnp.asarray(np.concatenate([_PERM, _PERM]))


def _grad(h, dx, dy, dz):
    h = h & 15
    u = jnp.where(h < 8, dx, dy)
    v = jnp.where(h < 4, dy, jnp.where((h == 12) | (h == 14), dx, dz))
    u = jnp.where((h & 1) > 0, -u, u)
    v = jnp.where((h & 2) > 0, -v, v)
    return u + v


def _noise_weight(t):
    t3 = t * t * t
    t4 = t3 * t
    return 6.0 * t4 * t - 15.0 * t4 + 10.0 * t3


def noise(p):
    """Perlin gradient noise at p f32[...,3] (core/texture.cpp:156-201)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    ix = jnp.floor(x).astype(jnp.int32)
    iy = jnp.floor(y).astype(jnp.int32)
    iz = jnp.floor(z).astype(jnp.int32)
    dx, dy, dz = x - ix, y - iy, z - iz
    ix &= 255
    iy &= 255
    iz &= 255
    P = _NOISE_PERM

    def g(ox, oy, oz):
        h = P[P[P[ix + ox] + iy + oy] + iz + oz]
        return _grad(h, dx - ox, dy - oy, dz - oz)

    wx, wy, wz = _noise_weight(dx), _noise_weight(dy), _noise_weight(dz)
    x00 = vm.lerp(wx, g(0, 0, 0), g(1, 0, 0))
    x10 = vm.lerp(wx, g(0, 1, 0), g(1, 1, 0))
    x01 = vm.lerp(wx, g(0, 0, 1), g(1, 0, 1))
    x11 = vm.lerp(wx, g(0, 1, 1), g(1, 1, 1))
    y0 = vm.lerp(wy, x00, x10)
    y1 = vm.lerp(wy, x01, x11)
    return vm.lerp(wz, y0, y1)


_FBM_OCTAVES = 8  # static unroll bound; octave weight masked by footprint


def fbm(p, dpdx, dpdy, omega, max_octaves):
    """Antialiased fractional Brownian motion (core/texture.cpp:202-224).
    max_octaves may be traced; the unroll bound is the static _FBM_OCTAVES."""
    s2 = jnp.maximum(vm.length_sq(dpdx), vm.length_sq(dpdy))
    foctaves = jnp.minimum(jnp.asarray(max_octaves, jnp.float32),
                           1.0 - 0.5 * jnp.log2(jnp.maximum(s2, 1e-30)))
    foctaves = jnp.maximum(foctaves, 0.0)
    octaves = jnp.floor(foctaves).astype(jnp.int32)
    partial = foctaves - octaves.astype(jnp.float32)
    total = jnp.zeros(p.shape[:-1], jnp.float32)
    lam, o = 1.0, 1.0
    for i in range(_FBM_OCTAVES):
        w_full = (i < octaves).astype(jnp.float32)
        w_part = jnp.where(i == octaves, vm.smoothstep(0.3, 0.7, partial), 0.0)
        total = total + (w_full + w_part) * o * noise(lam * p)
        lam *= 1.99
        o *= omega
    return total


def turbulence(p, dpdx, dpdy, omega, max_octaves):
    """Antialiased |noise| sum (core/texture.cpp:225-239)."""
    s2 = jnp.maximum(vm.length_sq(dpdx), vm.length_sq(dpdy))
    foctaves = jnp.minimum(jnp.asarray(max_octaves, jnp.float32),
                           1.0 - 0.5 * jnp.log2(jnp.maximum(s2, 1e-30)))
    foctaves = jnp.maximum(foctaves, 0.0)
    octaves = jnp.floor(foctaves).astype(jnp.int32)
    partial = foctaves - octaves.astype(jnp.float32)
    total = jnp.zeros(p.shape[:-1], jnp.float32)
    lam, o = 1.0, 1.0
    for i in range(_FBM_OCTAVES):
        w_full = (i < octaves).astype(jnp.float32)
        w_part = jnp.where(i == octaves, vm.smoothstep(0.3, 0.7, partial), 0.0)
        total = total + (w_full + w_part) * o * jnp.abs(noise(lam * p))
        lam *= 1.99
        o *= omega
    return total


def lanczos_np(x, tau=2.0):
    """Windowed sinc for host-side resampling (core/texture.cpp:241-249)."""
    x = np.abs(x)
    s = np.where(x < 1e-5, 1.0, np.sin(np.pi * x * tau) / np.maximum(np.pi * x * tau, 1e-9))
    lanc = np.where(x < 1e-5, 1.0, np.sin(np.pi * x) / np.maximum(np.pi * x, 1e-9))
    return np.where(x > 1.0, 0.0, s * lanc)


# ---------------------------------------------------------------------------
# 2D mappings (core/texture.cpp:63-155)
# ---------------------------------------------------------------------------

def _map2d(meta: TexNodeMeta, fp, w2t, dg):
    """Returns (s, t, dsdx, dtdx, dsdy, dtdy)."""
    zeros = jnp.zeros_like(dg["u"])
    if meta.mapping == "uv":
        su, sv, du, dv = fp[8], fp[9], fp[10], fp[11]
        s = su * dg["u"] + du
        t = sv * dg["v"] + dv
        return (s, t, su * dg.get("dudx", zeros), sv * dg.get("dvdx", zeros),
                su * dg.get("dudy", zeros), sv * dg.get("dvdy", zeros))
    if meta.mapping in ("spherical", "cylindrical"):
        p_t = tf.apply_point(w2t, dg["p"])
        if meta.mapping == "spherical":
            vec = vm.normalize(p_t)
            theta = vm.spherical_theta(vec)
            phi = vm.spherical_phi(vec)
            s = theta * jnp.float32(1.0 / jnp.pi)
            t = phi * jnp.float32(0.5 / jnp.pi)
        else:
            phi = vm.spherical_phi(vm.normalize(
                p_t * jnp.asarray([1.0, 1.0, 0.0])))
            s = phi * jnp.float32(0.5 / jnp.pi)
            t = p_t[..., 2]
        # Forward-difference derivative propagation (core/texture.cpp:84-104).
        delta = 0.1
        def sphere_st(pp):
            pv = vm.normalize(tf.apply_point(w2t, pp))
            if meta.mapping == "spherical":
                return (vm.spherical_theta(pv) * jnp.float32(1.0 / jnp.pi),
                        vm.spherical_phi(pv) * jnp.float32(0.5 / jnp.pi))
            ph = vm.spherical_phi(vm.normalize(pv * jnp.asarray([1.0, 1.0, 0.0])))
            return ph * jnp.float32(0.5 / jnp.pi), tf.apply_point(w2t, pp)[..., 2]
        dpdx = dg.get("dpdx", jnp.zeros_like(dg["p"]))
        dpdy = dg.get("dpdy", jnp.zeros_like(dg["p"]))
        sx, tx = sphere_st(dg["p"] + delta * dpdx)
        sy, ty = sphere_st(dg["p"] + delta * dpdy)
        dsdx, dtdx = (sx - s) / delta, (tx - t) / delta
        dsdy, dtdy = (sy - s) / delta, (ty - t) / delta
        # phi wrap fix
        dtdx = jnp.where(dtdx > 0.5, 1.0 - dtdx, jnp.where(dtdx < -0.5, -(dtdx + 1.0), dtdx))
        dtdy = jnp.where(dtdy > 0.5, 1.0 - dtdy, jnp.where(dtdy < -0.5, -(dtdy + 1.0), dtdy))
        return s, t, dsdx, dtdx, dsdy, dtdy
    if meta.mapping == "planar":
        vs = fp[0:3]
        vt = fp[3:6]
        ds, dt_ = fp[6], fp[7]
        vec = dg["p"]
        s = ds + vm.dot(vec, vs)
        t = dt_ + vm.dot(vec, vt)
        dpdx = dg.get("dpdx", jnp.zeros_like(dg["p"]))
        dpdy = dg.get("dpdy", jnp.zeros_like(dg["p"]))
        return (s, t, vm.dot(dpdx, vs), vm.dot(dpdx, vt),
                vm.dot(dpdy, vs), vm.dot(dpdy, vt))
    raise ValueError(f"unknown 2d mapping {meta.mapping}")


def _map3d(w2t, dg):
    p = tf.apply_point(w2t, dg["p"])
    dpdx = tf.apply_vector(w2t, dg.get("dpdx", jnp.zeros_like(dg["p"])))
    dpdy = tf.apply_vector(w2t, dg.get("dpdy", jnp.zeros_like(dg["p"])))
    return p, dpdx, dpdy


# ---------------------------------------------------------------------------
# MIP map lookup (core/mipmap.h). Levels are a static tuple of f32[h,w,3].
# ---------------------------------------------------------------------------

def _wrap_coords(i, n, wrap):
    if wrap == 0:      # repeat
        return jnp.mod(i, n)
    if wrap == 2:      # clamp
        return jnp.clip(i, 0, n - 1)
    return jnp.clip(i, 0, n - 1)  # black handled via mask by caller


def _bilinear(level, s, t, wrap):
    h, w = level.shape[0], level.shape[1]
    x = s * w - 0.5
    y = t * h - 0.5
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xs0 = _wrap_coords(x0, w, wrap)
    xs1 = _wrap_coords(x0 + 1, w, wrap)
    ys0 = _wrap_coords(y0, h, wrap)
    ys1 = _wrap_coords(y0 + 1, h, wrap)
    v00 = level[ys0, xs0]
    v01 = level[ys0, xs1]
    v10 = level[ys1, xs0]
    v11 = level[ys1, xs1]
    out = ((1 - fx) * (1 - fy) * v00 + fx * (1 - fy) * v01 +
           (1 - fx) * fy * v10 + fx * fy * v11)
    if wrap == 1:  # black outside [0,1]
        inside = ((s >= 0) & (s <= 1) & (t >= 0) & (t <= 1))[..., None]
        out = jnp.where(inside, out, 0.0)
    return out


def mipmap_lookup_tri(levels, s, t, width, wrap=0):
    """Isotropic trilinear MIPMap::Lookup (core/mipmap.h:203-221)."""
    nlev = len(levels)
    level_f = nlev - 1 + jnp.log2(jnp.maximum(width, 1e-8))
    level_f = jnp.clip(level_f, 0.0, nlev - 1)
    l0 = jnp.floor(level_f).astype(jnp.int32)
    dl = level_f - l0
    out = jnp.zeros(s.shape + (3,), jnp.float32)
    for li in range(nlev):
        w0 = jnp.where(l0 == li, 1.0 - dl, 0.0) + \
             jnp.where(l0 + 1 == li, dl, 0.0) + \
             jnp.where((li == nlev - 1) & (l0 == nlev - 1), dl, 0.0)
        tap = _bilinear(levels[li], s, t, wrap)
        out = out + w0[..., None] * tap
    return out


def mipmap_lookup_ewa(levels, s, t, ds0, dt0, ds1, dt1, wrap=0,
                      max_anisotropy=8.0):
    """Anisotropic lookup. Approximates EWA (core/mipmap.h:162-186) with the
    standard minor-axis level selection + multi-tap average along the major
    axis — matches EWA's footprint to first order with a fixed tap count
    and no data-dependent loop."""
    d0 = jnp.sqrt(ds0 * ds0 + dt0 * dt0)
    d1 = jnp.sqrt(ds1 * ds1 + dt1 * dt1)
    major = jnp.maximum(d0, d1)
    minor = jnp.minimum(d0, d1)
    minor = jnp.maximum(minor, major / max_anisotropy)
    NTAPS = 4
    out = jnp.zeros(s.shape + (3,), jnp.float32)
    # Taps spread along the major axis direction.
    maj_s = jnp.where(d0 >= d1, ds0, ds1)
    maj_t = jnp.where(d0 >= d1, dt0, dt1)
    for k in range(NTAPS):
        a = (k + 0.5) / NTAPS - 0.5
        out = out + mipmap_lookup_tri(levels, s + a * maj_s, t + a * maj_t,
                                      minor, wrap)
    return out / NTAPS


# ---------------------------------------------------------------------------
# Graph evaluation
# ---------------------------------------------------------------------------

def eval_graph(graph: TexGraph, images, dg):
    """Evaluate every node for a shading wavefront.

    dg: dict with p f32[B,3], u, v f32[B] (+ optional derivative fields).
    Returns f32[N_nodes, B, 3] stacked values (rgb; float textures replicate).
    """
    vals = []
    B = dg["u"].shape[0]
    for ni, meta in enumerate(graph.nodes):
        fp = graph.fparams[ni]
        w2t = graph.w2t[ni]
        k = meta.kind
        if k == "constant":
            v = jnp.broadcast_to(fp[0:3], (B, 3))
        elif k == "scale":
            v = vals[meta.children[0]] * vals[meta.children[1]]
        elif k == "mix":
            amt = vals[meta.children[2]][..., 0:1]
            v = (1.0 - amt) * vals[meta.children[0]] + amt * vals[meta.children[1]]
        elif k == "uv":
            s, t, *_ = _map2d(meta, fp, w2t, dg)
            v = jnp.stack([s - jnp.floor(s), t - jnp.floor(t),
                           jnp.zeros_like(s)], -1)
        elif k == "bilerp":
            # Corners packed in fp[0:12]; mapping params move to w2t row 3
            # is NOT used — bilerp always uses uv mapping with su=sv=1.
            s, t = dg["u"], dg["v"]
            c00, c01 = fp[0:3], fp[3:6]
            c10, c11 = fp[6:9], fp[9:12]
            sf = (s - jnp.floor(s))[..., None]
            tf_ = (t - jnp.floor(t))[..., None]
            v = ((1 - sf) * (1 - tf_) * c00 + (1 - sf) * tf_ * c01 +
                 sf * (1 - tf_) * c10 + sf * tf_ * c11)
        elif k == "checkerboard2d":
            s, t, dsdx, dtdx, dsdy, dtdy = _map2d(meta, fp, w2t, dg)
            t1, t2 = vals[meta.children[0]], vals[meta.children[1]]
            if meta.aamode == "closedform":
                # Box-filter closed form (textures/checkerboard.cpp:69-107).
                ds = jnp.maximum(jnp.abs(dsdx), jnp.abs(dsdy))
                dt = jnp.maximum(jnp.abs(dtdx), jnp.abs(dtdy))
                s0, s1 = s - ds, s + ds
                t0, t1_ = t - dt, t + dt
                same_s = jnp.floor(s0) == jnp.floor(s1)
                same_t = jnp.floor(t0) == jnp.floor(t1_)
                point = ((jnp.floor(s).astype(jnp.int32) +
                          jnp.floor(t).astype(jnp.int32)) % 2) == 0
                bump = lambda x: jnp.floor(x / 2) + 2.0 * jnp.maximum(
                    x / 2 - jnp.floor(x / 2) - 0.5, 0.0)
                area2 = (bump(s1) - bump(s0)) * (bump(t1_) - bump(t0))
                sint = (bump(s1) - bump(s0)) / (2.0 * jnp.maximum(ds, 1e-12))
                tint = (bump(t1_) - bump(t0)) / (2.0 * jnp.maximum(dt, 1e-12))
                area = sint + tint - 2.0 * sint * tint
                area = jnp.where(ds > 1.0, 0.5, area)
                area = jnp.where(dt > 1.0, 0.5, area)
                frac2 = jnp.where(same_s & same_t,
                                  jnp.where(point, 0.0, 1.0), area)
                v = (1.0 - frac2[..., None]) * t1 + frac2[..., None] * t2
            elif meta.aamode == "supersample":
                # 4x4 stratified supersampling with Gaussian weights
                # (textures/checkerboard.cpp:86-141). Deviations from the
                # reference, both trace-time static: the random stratified
                # jitter becomes a FIXED jitter table (deterministic, no
                # rng plumbing into texture eval; cell CENTERS would alias
                # against the checker's period-2 parity at even-cell
                # sample spacings), and the child textures are evaluated
                # once at dg (the graph evaluator computes node values
                # bottom-up; children are near-universally constants).
                jit_tab = np.random.default_rng(0x5A).uniform(
                    size=(4, 4, 2)).astype(np.float32)
                num = jnp.zeros_like(t1)
                wsum = 0.0
                for i in range(4):
                    for j in range(4):
                        dx = (i + jit_tab[i, j, 0]) / 4.0 - 0.5
                        dy = (j + jit_tab[i, j, 1]) / 4.0 - 0.5
                        ss = s + dx * dsdx + dy * dsdy
                        ts = t + dx * dtdx + dy * dtdy
                        wt = float(np.exp(-2.0 * (dx * dx + dy * dy)))
                        pt = ((jnp.floor(ss).astype(jnp.int32) +
                               jnp.floor(ts).astype(jnp.int32)) % 2) == 0
                        num = num + wt * jnp.where(pt[..., None], t1, t2)
                        wsum += wt
                v = num / wsum
            else:
                point = ((jnp.floor(s).astype(jnp.int32) +
                          jnp.floor(t).astype(jnp.int32)) % 2) == 0
                v = jnp.where(point[..., None], t1, t2)
        elif k == "checkerboard3d":
            p, _, _ = _map3d(w2t, dg)
            point = ((jnp.floor(p[..., 0]).astype(jnp.int32) +
                      jnp.floor(p[..., 1]).astype(jnp.int32) +
                      jnp.floor(p[..., 2]).astype(jnp.int32)) % 2) == 0
            v = jnp.where(point[..., None], vals[meta.children[0]],
                          vals[meta.children[1]])
        elif k == "dots":
            # textures/dots.cpp: per-cell jittered polka dots via noise.
            s, t, *_ = _map2d(meta, fp, w2t, dg)
            scell = jnp.floor(s + 0.5)
            tcell = jnp.floor(t + 0.5)
            cellp = jnp.stack([scell + 0.5, tcell + 0.5, jnp.zeros_like(s)], -1)
            has_dot = noise(cellp) > 0.0
            radius = 0.35
            maxshift = 0.5 - radius
            sc = scell + maxshift * noise(cellp + jnp.asarray([1.5, 2.8, 0.0]))
            tc = tcell + maxshift * noise(cellp + jnp.asarray([4.5, 9.8, 0.0]))
            ds_ = s - sc
            dt_ = t - tc
            inside = has_dot & (ds_ * ds_ + dt_ * dt_ < radius * radius)
            v = jnp.where(inside[..., None], vals[meta.children[0]],
                          vals[meta.children[1]])
        elif k in ("fbm", "wrinkled"):
            p, dpdx, dpdy = _map3d(w2t, dg)
            fn = fbm if k == "fbm" else turbulence
            val = fn(p, dpdx, dpdy, fp[1], fp[0])
            v = jnp.broadcast_to(val[..., None], val.shape + (3,))
        elif k == "windy":
            # textures/windy.cpp: two-scale FBm product.
            p, dpdx, dpdy = _map3d(w2t, dg)
            wind = fbm(0.1 * p, 0.1 * dpdx, 0.1 * dpdy, 0.5, 3)
            wave = fbm(p, dpdx, dpdy, 0.5, 6)
            val = jnp.abs(wind) * wave
            v = jnp.broadcast_to(val[..., None], val.shape + (3,))
        elif k == "marble":
            p, dpdx, dpdy = _map3d(w2t, dg)
            scale_, variation = fp[2], fp[3]
            marb = scale_ * fbm(scale_ * p, scale_ * dpdx, scale_ * dpdy,
                                fp[1], _FBM_OCTAVES)
            tval = 0.5 + 0.5 * jnp.sin(marb * variation + p[..., 1] * scale_)
            v = _marble_spline(tval)
        elif k == "imagemap":
            s, t, dsdx, dtdx, dsdy, dtdy = _map2d(meta, fp, w2t, dg)
            levels = images[meta.image].levels
            wrap = images[meta.image].wrap
            if meta.trilinear:
                width = 2.0 * jnp.maximum(
                    jnp.maximum(jnp.abs(dsdx), jnp.abs(dtdx)),
                    jnp.maximum(jnp.abs(dsdy), jnp.abs(dtdy)))
                v = mipmap_lookup_tri(levels, s, t, width, wrap)
            else:
                v = mipmap_lookup_ewa(levels, s, t, dsdx, dtdx, dsdy, dtdy,
                                      wrap)
            if meta.float_from_y:
                from ..core import spectrum as spec
                y = spec.luminance(v)
                v = jnp.broadcast_to(y[..., None], y.shape + (3,))
        else:
            raise ValueError(f"unknown texture kind {k}")
        vals.append(v)
    if not vals:
        return jnp.zeros((0, B, 3), jnp.float32)
    return jnp.stack(vals, 0)


# Marble color spline (textures/marble.cpp's 9-point c[] data).
_MARBLE_C = jnp.asarray([
    [0.58, 0.58, 0.6], [0.58, 0.58, 0.6], [0.58, 0.58, 0.6],
    [0.5, 0.5, 0.5], [0.6, 0.59, 0.58], [0.58, 0.58, 0.6],
    [0.58, 0.58, 0.6], [0.2, 0.2, 0.33], [0.58, 0.58, 0.6],
], jnp.float32)


def _marble_spline(t):
    """Evaluate the cubic Bezier-ish spline pbrt uses (NSEG=6 windows of 4
    control points with first/last duplicated)."""
    nseg = _MARBLE_C.shape[0] - 3
    t = jnp.clip(t, 0.0, 0.9999)
    seg = jnp.floor(t * nseg).astype(jnp.int32)
    tt = t * nseg - seg.astype(jnp.float32)
    c0 = _MARBLE_C[seg]
    c1 = _MARBLE_C[seg + 1]
    c2 = _MARBLE_C[seg + 2]
    c3 = _MARBLE_C[seg + 3]
    s0 = vm.lerp(tt[..., None], c0, c1)
    s1 = vm.lerp(tt[..., None], c1, c2)
    s2 = vm.lerp(tt[..., None], c2, c3)
    s0 = vm.lerp(tt[..., None], s0, s1)
    s1 = vm.lerp(tt[..., None], s1, s2)
    return 1.5 * vm.lerp(tt[..., None], s0, s1)

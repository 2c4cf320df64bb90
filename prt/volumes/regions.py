"""Volume regions: homogeneous, exponential, density grid.

Replacement for /root/reference/volumes/*.cpp and the VolumeRegion
interface (core/volume.h:43-108). All regions live in one SoA table
(scene.volumes); queries are evaluated for every region masked by
bounds-membership and summed — the AggregateVolume (core/volume.h:91-108).
Optical depth Tau is analytic for homogeneous regions
(volumes/homogeneous.cpp:27-85) and fixed-step ray marching with jittered
offset for the rest (core/volume.cpp Tau / DensityRegion).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core import transform as tf, vecmath as vm
from ..scene.data import VolumeTable

VOL_HOMOGENEOUS = 0
VOL_EXPONENTIAL = 1
VOL_GRID = 2

_MARCH_STEPS = 32  # static ray-march step count


def _inside(vol: VolumeTable, p):
    """bool[N, R]: p inside region r's world AABB."""
    lo = vol.bound_lo[None, :, :]
    hi = vol.bound_hi[None, :, :]
    pp = p[:, None, :]
    return jnp.all((pp >= lo) & (pp <= hi), axis=-1)


def density(vol: VolumeTable, p):
    """f32[N, R] local density factor per region kind."""
    n = p.shape[0]
    r = vol.count
    pp = p[:, None, :]
    inside = _inside(vol, p)
    # exponential: a * exp(-b * h), h = dot(p - lo, updir)
    # (volumes/exponential.cpp:27-53)
    h = vm.dot(pp - vol.bound_lo[None], vol.updir[None])
    d_exp = vol.params[None, :, 0] * jnp.exp(-vol.params[None, :, 1] * h)
    d_hom = jnp.ones((n, r), jnp.float32)
    d = jnp.where(vol.kind[None] == VOL_EXPONENTIAL, d_exp, d_hom)
    if vol.density is not None and len(vol.density) > 0:
        # Trilinear grid lookup in volume space (volumes/volumegrid.cpp).
        pv = tf.apply_point(vol.w2v[None], pp)
        for ri, grid in enumerate(vol.density):
            if grid is None:
                continue
            nz, ny, nx = grid.shape
            gx = pv[:, ri, 0] * nx - 0.5
            gy = pv[:, ri, 1] * ny - 0.5
            gz = pv[:, ri, 2] * nz - 0.5
            x0 = jnp.clip(jnp.floor(gx).astype(jnp.int32), 0, nx - 1)
            y0 = jnp.clip(jnp.floor(gy).astype(jnp.int32), 0, ny - 1)
            z0 = jnp.clip(jnp.floor(gz).astype(jnp.int32), 0, nz - 1)
            x1 = jnp.clip(x0 + 1, 0, nx - 1)
            y1 = jnp.clip(y0 + 1, 0, ny - 1)
            z1 = jnp.clip(z0 + 1, 0, nz - 1)
            fx = jnp.clip(gx - x0, 0, 1)[:, None]
            fy = jnp.clip(gy - y0, 0, 1)[:, None]
            fz = jnp.clip(gz - z0, 0, 1)[:, None]
            g = jnp.asarray(grid)
            c = lambda zz, yy, xx: g[zz, yy, xx][:, None]
            v = ((1 - fx) * (1 - fy) * (1 - fz) * c(z0, y0, x0) +
                 fx * (1 - fy) * (1 - fz) * c(z0, y0, x1) +
                 (1 - fx) * fy * (1 - fz) * c(z0, y1, x0) +
                 fx * fy * (1 - fz) * c(z0, y1, x1) +
                 (1 - fx) * (1 - fy) * fz * c(z1, y0, x0) +
                 fx * (1 - fy) * fz * c(z1, y0, x1) +
                 (1 - fx) * fy * fz * c(z1, y1, x0) +
                 fx * fy * fz * c(z1, y1, x1))[:, 0]
            d = d.at[:, ri].set(jnp.where(vol.kind[ri] == VOL_GRID, v,
                                          d[:, ri]))
    return jnp.where(inside, d, 0.0)


def sigma_a(vol: VolumeTable, p):
    return jnp.sum(density(vol, p)[..., None] * vol.sigma_a[None], axis=1)


def sigma_s(vol: VolumeTable, p):
    return jnp.sum(density(vol, p)[..., None] * vol.sigma_s[None], axis=1)


def sigma_t(vol: VolumeTable, p):
    d = density(vol, p)[..., None]
    return jnp.sum(d * (vol.sigma_a + vol.sigma_s)[None], axis=1)


def lve(vol: VolumeTable, p):
    return jnp.sum(density(vol, p)[..., None] * vol.le[None], axis=1)


def mean_g(vol: VolumeTable, p):
    """Density-weighted phase asymmetry at p."""
    d = density(vol, p)
    w = jnp.sum(d, axis=1)
    g = jnp.sum(d * vol.g[None], axis=1)
    return jnp.where(w > 0, g / jnp.maximum(w, 1e-9), 0.0)


def _segment(vol: VolumeTable, o, d_, mint, maxt):
    """Clip the ray to the union AABB of all regions; (t0, t1, any)."""
    lo = jnp.min(vol.bound_lo, axis=0)
    hi = jnp.max(vol.bound_hi, axis=0)
    hit, t0, t1 = vm.bbox_intersect_p(lo, hi, o, d_, mint, maxt)
    return jnp.where(hit, t0, 0.0), jnp.where(hit, t1, 0.0), hit


def tau(vol: VolumeTable, o, d_, mint, maxt, step_jitter):
    """Optical depth along [mint, maxt] (core/volume.cpp Tau semantics):
    fixed-step jittered midpoint marching. Returns f32[N,3]."""
    if vol is None or vol.count == 0:
        return jnp.zeros(o.shape[:-1] + (3,), jnp.float32)
    t0, t1, any_hit = _segment(vol, o, d_, mint, maxt)
    seg = jnp.maximum(t1 - t0, 0.0)
    dt = seg / _MARCH_STEPS
    acc = jnp.zeros(o.shape[:-1] + (3,), jnp.float32)
    for i in range(_MARCH_STEPS):
        tmid = t0 + (i + step_jitter) * dt
        p = o + tmid[..., None] * d_
        acc = acc + sigma_t(vol, p) * dt[..., None]
    return jnp.where(any_hit[..., None], acc, 0.0)


def transmittance(vol: VolumeTable, o, d_, mint, maxt, u):
    """exp(-Tau) (integrators/emission.cpp:47-59)."""
    if vol is None or vol.count == 0:
        return jnp.ones(o.shape[:-1] + (3,), jnp.float32)
    return jnp.exp(-tau(vol, o, d_, mint, maxt, u))

"""Irradiance caching as a probe-grid preprocess + interpolating wavefront.

Replacement for /root/reference/integrators/irradiancecache.cpp:
213-362. The reference computes hemispherical irradiance lazily on cache
miss and stores samples in an Octree; lazy fill is sequential by nature, so
the redesign computes the cache UP FRONT: a probe pass traces camera
rays on a strided pixel grid (following one specular chain so points behind
glass/mirrors get coverage), estimates E at every probe hit with nsamples
cosine-weighted mini path traces (the exact inner loop of
irradiancecache.cpp:225-291: NEE at every vertex, emitted term only after
specular bounces, maxIndirectDepth bound, RR after 3), and stores
(p, n, E, maxDist) in a hashed point grid (accel/photon_grid.py PointGrid —
the Octree's replacement). maxDist is the harmonic-mean ray distance
clamped to [.001, .125] * V^(1/3), scaled by maxError
(irradiancecache.cpp:292-308).

Li interpolates with the reference's weighting (irradiancecache.cpp:340-
362): normal agreement >= 0.01, distance <= maxDist, in-front test,
err = d/(maxDist * n.ni) < 1, weight (1-err)^2. Lanes with no qualifying
sample fall back to the minimum-err sample (documented divergence — the
reference computes a fresh estimate on miss, which a wavefront cannot do
lazily; probe coverage makes misses rare).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..accel import intersect as isect
from ..accel.photon_grid import PointGrid, build_point_grid, gather_points
from ..bsdf import bsdf as B
from ..core import mc, rng, vecmath as vm
from ..lights import lights as lt
from ..samplers import samplers as smp
from ..scene.data import SceneData
from . import common

_EPS = vm.RAY_EPSILON


class IrradParams(NamedTuple):
    """CreateSurfaceIntegrator defaults (irradiancecache.cpp:363-370)."""
    maxerror: float = 0.2
    maxspeculardepth: int = 5
    maxindirectdepth: int = 3
    nsamples: int = 4096
    probe_stride: int = 4      # probe grid: every Nth pixel
    probe_depth: int = 2       # primary hit + specular chain hits


def _mini_path_radiance(scene: SceneData, o, d, max_depth: int, ph, tag):
    """The irradiance-estimate path trace (irradiancecache.cpp:236-291):
    NEE at every vertex, emitted term only after a specular bounce.
    Also returns the FIRST-hit distance (for the harmonic mean)."""
    n = o.shape[0]
    has_inf = bool(scene.lights.infinite_meta)

    def body(carry, depth):
        ro, rd, tp, L, alive, spec, d_first = carry
        t, pid, hit = isect.intersect_ids(scene, ro, rd,
                                          jnp.full((n,), _EPS),
                                          jnp.full((n,), 1e30))
        d_first = jnp.where((depth == 0) & hit, t, d_first)
        if has_inf:
            esc = ~hit & alive
            L = L + jnp.where(esc[..., None],
                              tp * lt.le_escaped(scene, rd), 0.0)
        alive = alive & hit
        dg = isect.hit_geometry(scene, pid, ro, rd, t)
        Le = lt.area_emission(scene, dg["area_light"], dg["nn"], -rd)
        L = L + jnp.where((alive & spec)[..., None], tp * Le, 0.0)
        bsdf = common.make_bsdf_at(scene, dg)
        p, nrm = dg["p"], bsdf.nn
        Ld = common.uniform_sample_one_light(
            scene, p, nrm, -rd, bsdf,
            rng.uniform(ph, tag, depth, 0), rng.uniform(ph, tag, depth, 1),
            rng.uniform(ph, tag, depth, 2), rng.uniform(ph, tag, depth, 3),
            rng.uniform(ph, tag, depth, 4), rng.uniform(ph, tag, depth, 5),
            rng.uniform(ph, tag, depth, 6), alive)
        L = L + jnp.where(alive[..., None], tp * Ld, 0.0)
        bs = B.sample_f(bsdf, -rd, rng.uniform(ph, tag, depth, 7),
                        rng.uniform(ph, tag, depth, 8),
                        rng.uniform(ph, tag, depth, 9), B.ALL)
        ok = bs["valid"] & (bs["pdf"] > 0.0) & jnp.any(bs["f"] > 0.0, -1)
        spec = bs["specular"]
        tp = jnp.where(ok[..., None],
                       tp * bs["f"] * (vm.absdot(bs["wi"], nrm) /
                                       jnp.maximum(bs["pdf"], 1e-20))[..., None],
                       tp)
        rr = rng.uniform(ph, tag, depth, 0xEE)
        cont = (depth <= 3) | (rr <= 0.5)
        tp = jnp.where(((depth > 3) & cont)[..., None], tp * 2.0, tp)
        alive = alive & ok & cont & (depth + 1 < max_depth)
        return (p, bs["wi"], tp, L, alive, spec, d_first), None

    init = (o, d, jnp.ones((n, 3), jnp.float32),
            jnp.zeros((n, 3), jnp.float32), jnp.ones((n,), bool),
            jnp.zeros((n,), bool), jnp.full((n,), 1e30))
    carry, _ = jax.lax.scan(body, init, jnp.arange(max_depth))
    return carry[3], carry[6]


def build_cache(scene: SceneData, prm: IrradParams, xres: int, yres: int,
                seed: int = 0) -> PointGrid:
    """Probe pass (the reference's lazy fill made eager)."""
    from ..cameras import cameras as cam_mod
    stride = max(1, prm.probe_stride)
    pxs = np.arange(stride // 2, xres, stride)
    pys = np.arange(stride // 2, yres, stride)
    PX, PY = np.meshgrid(pxs, pys, indexing="ij")
    px = jnp.asarray(PX.reshape(-1), jnp.int32)
    py = jnp.asarray(PY.reshape(-1), jnp.int32)
    n = px.shape[0]
    ph = rng.hash_u32(px, py, seed, 0x1CAC)

    @jax.jit
    def probe_hits():
        """Primary hits plus a short specular chain of probe points."""
        o, d, mint, maxt, _ = cam_mod.generate_rays(
            scene.camera, px.astype(jnp.float32) + 0.5,
            py.astype(jnp.float32) + 0.5,
            jnp.full((n,), 0.5), jnp.full((n,), 0.5), jnp.zeros((n,)),
            xres, yres)
        pts, nrms, valids = [], [], []
        ro, rd, rmint, rmaxt = o, d, mint, maxt
        alive = jnp.ones((n,), bool)
        for depth in range(prm.probe_depth):
            t, pid, hit = isect.intersect_ids(scene, ro, rd, rmint, rmaxt)
            alive = alive & hit
            dg = isect.hit_geometry(scene, pid, ro, rd, t)
            bsdf = common.make_bsdf_at(scene, dg)
            ng = dg["nn"]
            ng = jnp.where(vm.dot(-rd, ng)[..., None] < 0.0, -ng, ng)
            has_diffuse = B.num_components(
                bsdf, B.REFLECTION | B.TRANSMISSION |
                B.DIFFUSE | B.GLOSSY) > 0
            pts.append(dg["p"])
            nrms.append(ng)
            valids.append(alive & has_diffuse)
            bs = B.sample_f(bsdf, -rd,
                            rng.uniform(ph, depth, 0x51),
                            rng.uniform(ph, depth, 0x52),
                            rng.uniform(ph, depth, 0x53),
                            B.SPECULAR | B.REFLECTION | B.TRANSMISSION)
            alive = alive & bs["valid"] & (bs["pdf"] > 0.0)
            ro, rd = dg["p"], bs["wi"]
            rmint = jnp.full((n,), _EPS)
            rmaxt = jnp.full((n,), 1e30)
        return (jnp.concatenate(pts), jnp.concatenate(nrms),
                jnp.concatenate(valids))

    pts, nrms, valid = probe_hits()
    pts_np = np.asarray(pts)[np.asarray(valid)]
    nrms_np = np.asarray(nrms)[np.asarray(valid)]
    npr = len(pts_np)
    wb = np.asarray(scene.world_bound_hi) - np.asarray(scene.world_bound_lo)
    vol_cbrt = float(np.abs(wb.prod())) ** (1.0 / 3.0)
    min_max = 0.001 * vol_cbrt
    max_max = 0.125 * vol_cbrt
    if npr == 0:
        return build_point_grid(np.zeros((0, 3), np.float32),
                                (np.zeros((0, 3), np.float32),) * 2 +
                                (np.zeros((0,), np.float32),),
                                max(max_max * prm.maxerror, 1e-4))

    # Irradiance estimates: ns cosine rays per probe, one big wavefront.
    ns = max(4, prm.nsamples)
    pr = jnp.asarray(pts_np)
    nr = jnp.asarray(nrms_np)
    phh = rng.hash_u32(jnp.arange(npr, dtype=jnp.uint32),
                       jnp.uint32(seed), 0x1E5)

    @jax.jit
    def estimate():
        _, v1, v2 = vm.coordinate_system(nr)
        E = jnp.zeros((npr, 3), jnp.float32)
        inv_d = jnp.zeros((npr,), jnp.float32)

        def samp(carry, i):
            E, inv_d = carry
            u1 = rng.ld_shuffled_1d(jnp.full((npr,), i, jnp.uint32), phh, 0)
            u2 = rng.ld_shuffled_1d(jnp.full((npr,), i, jnp.uint32), phh, 1)
            w = mc.cosine_sample_hemisphere(u1, u2)
            wd = w[..., 0:1] * v1 + w[..., 1:2] * v2 + \
                jnp.abs(w[..., 2:3]) * nr
            L, d_first = _mini_path_radiance(scene, pr, wd,
                                             prm.maxindirectdepth,
                                             rng.hash_u32(phh, i, 0x7), 0)
            return (E + L, inv_d + 1.0 / jnp.maximum(d_first, 1e-6)), None

        (E, inv_d), _ = jax.lax.scan(samp, (E, inv_d), jnp.arange(ns))
        E = E * (jnp.pi / ns)
        max_dist = ns / jnp.maximum(inv_d, 1e-12)
        return E, max_dist

    E, max_dist = estimate()
    md = np.clip(np.asarray(max_dist), min_max, max_max) * prm.maxerror
    cell = float(max(md.max(), 1e-4))
    return build_point_grid(pts_np, (nrms_np, np.asarray(E),
                                     md.astype(np.float32)), cell)


def interpolate_irradiance(cache: PointGrid, p, n_shading, active):
    """IrradProcess weighting (irradiancecache.cpp:340-362) + min-err
    fallback for uncovered lanes."""
    B_ = p.shape[0]
    zero3 = jnp.zeros((B_, 3), jnp.float32)
    if cache.count == 0:
        return zero3

    def accum(carry, sp, payload, in_bucket):
        Ew, sw, bestE, bestErr = carry
        sn, sE, smax = payload            # [B,27,3],[B,27,3],[B,27]
        ndot = jnp.sum(n_shading[:, None, :] * sn, -1)
        d2 = jnp.sum((sp - p[:, None, :]) ** 2, -1)
        navg = sn + n_shading[:, None, :]
        front = jnp.sum((p[:, None, :] - sp) * navg, -1) >= -0.01
        ok = in_bucket & (ndot >= 0.01) & (d2 <= smax * smax) & front
        err = jnp.sqrt(d2) / jnp.maximum(smax * ndot, 1e-12)
        use = ok & (err < 1.0)
        wt = jnp.where(use, (1.0 - err) ** 2, 0.0)
        Ew = Ew + jnp.sum(wt[..., None] * sE, 1)
        sw = sw + jnp.sum(wt, 1)
        # Fallback candidate: min err among normal-compatible samples.
        err_f = jnp.where(in_bucket & (ndot >= 0.01) & front, err, 1e30)
        jbest = jnp.argmin(err_f, axis=1)
        cand_err = jnp.take_along_axis(err_f, jbest[:, None], 1)[:, 0]
        cand_E = jnp.take_along_axis(sE, jbest[:, None, None], 1)[:, 0]
        better = cand_err < bestErr
        bestE = jnp.where(better[..., None], cand_E, bestE)
        bestErr = jnp.minimum(bestErr, cand_err)
        return (Ew, sw, bestE, bestErr)

    Ew, sw, bestE, bestErr = gather_points(
        cache, p, accum,
        (zero3, jnp.zeros((B_,)), zero3, jnp.full((B_,), 1e30)))
    has = sw > 0.0
    E = jnp.where(has[..., None], Ew / jnp.maximum(sw, 1e-20)[..., None],
                  jnp.where((bestErr < 1e29)[..., None], bestE, 0.0))
    return jnp.where(active[..., None], E, 0.0)


def li(scene: SceneData, cache: PointGrid, o, d, mint, maxt,
       cfg: smp.SamplerConfig, px, py, s_idx, max_depth: int = 5,
       seed: int = 0, prm: IrradParams = IrradParams(), rx=None, ry=None):
    n = o.shape[0]
    ph = rng.hash_u32(px, py, seed, 0x1CA)
    has_inf = bool(scene.lights.infinite_meta)

    def body(carry, depth):
        ro, rd, throughput, L, alive, alpha_acc, t_first = carry
        first = depth == 0
        t, pid, hit = isect.intersect_ids(
            scene, ro, rd,
            jnp.where(first, mint, jnp.full((n,), _EPS)),
            jnp.where(first, maxt, jnp.full((n,), 1e30)))
        t_first = jnp.where(first & hit, t, t_first)
        if has_inf:
            esc = ~hit & alive
            Lesc = lt.le_escaped(scene, rd)
            L = L + jnp.where(esc[..., None], throughput * Lesc, 0.0)
            alpha_acc = jnp.where(esc & first & jnp.any(Lesc > 0, -1), 1.0,
                                  alpha_acc)
        alive = alive & hit
        alpha_acc = jnp.where(first & hit, 1.0, alpha_acc)

        dg = isect.hit_geometry(scene, pid, ro, rd, t)
        if rx is not None:
            dg = isect.compute_differentials(dg, rx[0], rx[1], ry[0], ry[1],
                                             first & alive)
        wo = -rd
        Le = lt.area_emission(scene, dg["area_light"], dg["nn"], wo)
        L = L + jnp.where(alive[..., None], throughput * Le, 0.0)
        bsdf = common.make_bsdf_at(scene, dg)
        p, nrm = dg["p"], bsdf.nn

        def sample_fn(light_i, kind):
            return rng.uniform2(ph, s_idx, depth, light_i, kind)
        Ld = common.uniform_sample_all_lights(scene, p, nrm, wo, bsdf,
                                              sample_fn, alive)
        L = L + jnp.where(alive[..., None], throughput * Ld, 0.0)

        # Indirect = rho/pi * E(p, ng facing wo) (irradiancecache.cpp:
        # 190-202, 315).
        ng = dg["nn"]
        ng = jnp.where(vm.dot(wo, ng)[..., None] < 0.0, -ng, ng)
        E = interpolate_irradiance(cache, p, ng, alive)
        rho_r = B.rho_approx(bsdf, B.REFLECTION | B.DIFFUSE | B.GLOSSY)
        Lind = rho_r * E * jnp.float32(1.0 / jnp.pi)
        rho_t = B.rho_approx(bsdf, B.TRANSMISSION | B.DIFFUSE | B.GLOSSY)
        has_t = jnp.any(rho_t > 0.0, -1)
        Et = interpolate_irradiance(cache, p, -ng, alive & has_t)
        Lind = Lind + rho_t * Et * jnp.float32(1.0 / jnp.pi)
        L = L + jnp.where(alive[..., None], throughput * Lind, 0.0)

        u1 = rng.uniform(ph, s_idx, depth, 0x5A, 1)
        u2 = rng.uniform(ph, s_idx, depth, 0x5A, 2)
        u3 = rng.uniform(ph, s_idx, depth, 0x5A, 3)
        bs = B.sample_f(bsdf, wo, u1, u2, u3,
                        B.SPECULAR | B.REFLECTION | B.TRANSMISSION)
        cont = alive & bs["valid"] & (bs["pdf"] > 0.0) & \
            ~jnp.all(bs["f"] == 0.0, axis=-1) & (depth < max_depth)
        scale = bs["f"] * (vm.absdot(bs["wi"], nrm) /
                           jnp.maximum(bs["pdf"], 1e-20))[..., None]
        throughput = jnp.where(cont[..., None], throughput * scale,
                               throughput)
        return (p, bs["wi"], throughput, L, cont, alpha_acc, t_first), None

    init = (o, d, jnp.ones_like(o), jnp.zeros_like(o),
            d[..., 0] * 0.0 == 0.0, d[..., 0] * 0.0,
            maxt + d[..., 0] * 0.0)
    carry, _ = jax.lax.scan(body, init, jnp.arange(max_depth + 1))
    return carry[3], carry[5], carry[6]

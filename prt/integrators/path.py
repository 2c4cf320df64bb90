"""Path integrator as a wavefront loop compiled once per bounce (lax.scan).

Replacement for /root/reference/integrators/path.cpp:58-145. The
reference's per-ray while loop becomes a lax.scan over bounce index with
masked lanes: intersect -> emitted-term -> NEE (EstimateDirect MIS) -> BSDF
continuation -> Russian roulette. Exact semantics preserved: Le added only
on the first or post-specular vertex, RR p=0.5 after bounce 3
(path.cpp:135-142), MIS one-light NEE (path.cpp:99-110).

Noted divergence from the reference: pbrt switches from precomputed sampler
arrays to its global RNG after SAMPLE_DEPTH=3 bounces (path.cpp:88) because
Sample arrays are finite; our counter-based streams are infinite, so every
bounce uses the sampler's scrambled-LD streams — strictly better
stratification, same estimator.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..accel import intersect as isect
from ..bsdf import bsdf as B
from ..core import rng, vecmath as vm
from ..lights import lights as lt
from ..samplers import samplers as smp
from ..scene.data import SceneData
from . import common

_EPS = vm.RAY_EPSILON


def li(scene: SceneData, o, d, mint, maxt, cfg: smp.SamplerConfig,
       px, py, s_idx, max_depth: int = 5, seed: int = 0, rr_start: int = 3,
       collect_stats: bool = False, rx=None, ry=None):
    """Returns (L f32[N,3], alpha f32[N]) — plus a stats dict (ray counters,
    the reborn stats registry of core/util.cpp:186-285) when collect_stats.
    """
    n_rays = o.shape[0]
    ph = rng.hash_u32(px, py, seed, 0xBA5E)
    has_inf = bool(scene.lights.infinite_meta)
    has_lights = scene.lights.count > 0
    has_vols = scene.volumes is not None and scene.volumes.count > 0

    def body(carry, bounce):
        (ro, rd, rmint, rmaxt, throughput, L, alive, specular, alpha,
         n_rays_traced, t_first) = carry
        first = bounce == 0
        n_alive = jnp.sum(alive.astype(jnp.float32))
        # 1 intersect per alive lane; NEE adds 1 shadow + 1 BSDF-strategy ray.
        n_rays_traced = n_rays_traced + n_alive * (3.0 if has_lights else 1.0)

        t, pid, hit = isect.intersect_ids(scene, ro, rd, rmint, rmaxt)
        # Camera-segment end for the driver's volume composition
        # (core/scene.cpp:120-126) — saves the driver re-intersecting.
        t_first = jnp.where(first & hit, t, t_first)

        # Per-segment volume attenuation for bounce>0 (path.cpp:89); the
        # camera segment's T is applied by the driver (core/scene.cpp:120-126)
        if has_vols:
            from ..volumes import regions as vr
            seg_end = jnp.where(hit, t, rmaxt)
            tr = vr.transmittance(scene.volumes, ro, rd, rmint, seg_end,
                                  rng.uniform(ph, s_idx, bounce, 0x77))
            throughput = jnp.where((~first & alive)[..., None],
                                   throughput * tr, throughput)

        # Escaped rays: env light only on first/post-specular (path.cpp:72-83)
        if has_inf:
            take_le = ~hit & alive & (first | specular)
            Lesc = lt.le_escaped(scene, rd)
            L = L + jnp.where(take_le[..., None], throughput * Lesc, 0.0)
            alpha = jnp.where(take_le & first & jnp.any(Lesc > 0, -1),
                              1.0, alpha)
        alive = alive & hit
        alpha = jnp.where(first & hit, 1.0, alpha)

        # Missed lanes get t = 0, not 1e30: their (masked) shading and
        # light sampling then run at finite points, so the gradient of the
        # masked terms stays finite.
        dg = isect.hit_geometry(scene, pid, ro, rd, jnp.where(hit, t, 0.0))
        # First-hit ray differentials (core/scene.cpp:45-53 aux rays +
        # core/shape.cpp:52-106) for texture filtering.
        if rx is not None:
            dg = isect.compute_differentials(dg, rx[0], rx[1], ry[0], ry[1],
                                             first & alive)

        # Emitted term (area lights) on first/post-specular (path.cpp:91-92).
        if has_lights:
            emit_ok = alive & (first | specular)
            Le = lt.area_emission(scene, dg["area_light"], dg["nn"], -rd)
            L = L + jnp.where(emit_ok[..., None], throughput * Le, 0.0)

        bsdf = common.make_bsdf_at(scene, dg)
        p, ns = dg["p"], bsdf.nn
        wo = -rd

        # --- NEE: UniformSampleOneLight (path.cpp:99-110) ---
        if has_lights:
            u_num = smp.integrator_1d(cfg, px, py, s_idx, bounce, 10, seed)
            ls1, ls2 = smp.integrator_2d(cfg, px, py, s_idx, bounce, 11, seed)
            bs1, bs2 = smp.integrator_2d(cfg, px, py, s_idx, bounce, 12, seed)
            bcs = smp.integrator_1d(cfg, px, py, s_idx, bounce, 13, seed)
            ls3 = rng.uniform(ph, s_idx, bounce, 16)
            Ld = common.uniform_sample_one_light(
                scene, p, ns, wo, bsdf, u_num, ls1, ls2, ls3, bs1, bs2, bcs,
                alive)
            L = L + jnp.where(alive[..., None], throughput * Ld, 0.0)

        # --- BSDF-sampled continuation (path.cpp:112-133) ---
        c1, c2 = smp.integrator_2d(cfg, px, py, s_idx, bounce, 20, seed)
        c3 = smp.integrator_1d(cfg, px, py, s_idx, bounce, 21, seed)
        bs = B.sample_f(bsdf, wo, c1, c2, c3, B.ALL)
        cont = alive & bs["valid"] & (bs["pdf"] > 0.0) & \
            ~jnp.all(bs["f"] == 0.0, axis=-1) & (bounce < max_depth)
        scale = bs["f"] * (vm.absdot(bs["wi"], ns) /
                           jnp.maximum(bs["pdf"], 1e-20))[..., None]
        throughput = jnp.where(cont[..., None], throughput * scale,
                               throughput)
        specular = jnp.where(cont, bs["specular"], specular)
        alive = cont

        # --- Russian roulette (path.cpp:135-142) ---
        u_rr = rng.uniform(ph, s_idx, bounce, 30)
        do_rr = bounce >= rr_start
        survive = ~do_rr | (u_rr < 0.5)
        alive = alive & survive
        throughput = jnp.where((alive & do_rr)[..., None],
                               throughput / 0.5, throughput)

        ro = p
        rd = bs["wi"]
        rmint = rmint * 0.0 + _EPS
        rmaxt = rmaxt * 0.0 + 1e30
        return (ro, rd, rmint, rmaxt, throughput, L, alive, specular,
                alpha, n_rays_traced, t_first), None

    # Carry state derived from the (possibly shard_map-varying) ray inputs
    # so lax.scan sees consistent varying axes on every component.
    init = (o, d, mint + d[..., 0] * 0.0, maxt + d[..., 0] * 0.0,
            jnp.ones_like(o),
            jnp.zeros_like(o),
            d[..., 0] * 0.0 == 0.0,
            d[..., 0] * 0.0 > 1.0,
            d[..., 0] * 0.0,
            jnp.sum(d[..., 0] * 0.0),
            maxt + d[..., 0] * 0.0)
    carry, _ = jax.lax.scan(body, init, jnp.arange(max_depth + 1))
    L = carry[5]
    alpha = carry[8]
    if collect_stats:
        return L, alpha, carry[10], dict(rays_traced=carry[9])
    return L, alpha, carry[10]

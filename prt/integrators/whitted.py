"""Whitted integrator as a wavefront loop compiled once per depth (scan).

Replacement for /root/reference/integrators/whitted.cpp:44-140.
The reference recurses into BOTH specular reflection and transmission; a
wavefront cannot branch, so each lane stochastically selects one specular
continuation with the BSDF mixture sampler restricted to SPECULAR flags —
the mixture pdf (1/#specular components) exactly compensates, so the
estimator is unbiased w.r.t. the reference's deterministic recursion (noted
divergence: variance, not mean). Direct lighting loops over every light with
single samples and no MIS, matching whitted.cpp:74-81.
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
       px, py, s_idx, max_depth: int = 5, seed: int = 0,
       rx=None, ry=None):
    """rx/ry: optional (origin, direction) auxiliary camera rays offset by
    +1 pixel in x/y (core/scene.cpp:45-53) enabling texture filtering via
    ray differentials at the first hit."""
    n_rays = o.shape[0]
    ph = rng.hash_u32(px, py, seed, 0x817)
    has_inf = bool(scene.lights.infinite_meta)

    def body(carry, depth):
        (ro, rd, rmint, rmaxt, throughput, L, alive, alpha, t_first,
         rxo, rxd, ryo, ryd) = carry
        first = depth == 0

        t, pid, hit = isect.intersect_ids(scene, ro, rd, rmint, rmaxt)
        # Camera-segment end for the driver's volume composition
        # (core/scene.cpp:120-126) — saves the driver re-intersecting.
        t_first = jnp.where(first & hit, t, t_first)

        # Miss: sum of light Le along the ray (whitted.cpp:52-58).
        if has_inf:
            esc = ~hit & alive
            Lesc = lt.le_escaped(scene, rd)
            L = L + jnp.where(esc[..., None], throughput * Lesc, 0.0)
            alpha = jnp.where(esc & first & jnp.any(Lesc > 0, -1), 1.0, alpha)
        alive = alive & hit
        alpha = jnp.where(first & hit, 1.0, alpha)

        dg = isect.hit_geometry(scene, pid, ro, rd, t)
        if rx is not None:
            # Differentials at EVERY depth: the carried aux rays are the
            # camera pair at depth 0, then the specular-propagated pair
            # (whitted.cpp:88-136), so EWA texture filtering through
            # mirrors/glass keeps a real anisotropic footprint.
            dg = isect.compute_differentials(dg, rxo, rxd, ryo, ryd, alive)
        # Area-light emission at the hit (whitted.cpp:69).
        Le = lt.area_emission(scene, dg["area_light"], dg["nn"], -rd)
        L = L + jnp.where(alive[..., None], throughput * Le, 0.0)

        bsdf = common.make_bsdf_at(scene, dg)
        p, ns = dg["p"], bsdf.nn
        wo = -rd

        # Direct lighting: every light, single sample, NO MIS
        # (whitted.cpp:74-81; the deprecated Sample_L folds pdf into Li).
        for i in range(scene.lights.count):
            lid = jnp.full((n_rays,), i, jnp.int32)
            ls1 = rng.uniform(ph, s_idx, depth, i, 1)
            ls2 = rng.uniform(ph, s_idx, depth, i, 2)
            ls3 = rng.uniform(ph, s_idx, depth, i, 3)
            sm = lt.sample(scene, lid, p, ns, ls1, ls2, ls3)
            ok = alive & (sm["pdf"] > 0.0) & \
                ~jnp.all(sm["Li"] == 0.0, axis=-1)
            f_val = B.f(bsdf, wo, sm["wi"])
            need = ok & ~jnp.all(f_val == 0.0, axis=-1)
            occ = isect.occluded(scene, p, sm["wi"],
                                 jnp.full((n_rays,), _EPS), sm["vis_maxt"])
            contrib = f_val * sm["Li"] * \
                (vm.absdot(sm["wi"], ns) /
                 jnp.maximum(sm["pdf"], 1e-20))[..., None]
            L = L + jnp.where((need & ~occ)[..., None],
                              throughput * contrib, 0.0)

        # Specular continuation: stochastic pick among specular components
        # (replaces the two-way recursion whitted.cpp:82-136).
        u1 = rng.uniform(ph, s_idx, depth, 0x5A, 1)
        u2 = rng.uniform(ph, s_idx, depth, 0x5A, 2)
        u3 = rng.uniform(ph, s_idx, depth, 0x5A, 3)
        bs = B.sample_f(bsdf, wo, u1, u2, u3,
                        B.SPECULAR | B.REFLECTION | B.TRANSMISSION)
        cont = alive & bs["valid"] & (bs["pdf"] > 0.0) & \
            ~jnp.all(bs["f"] == 0.0, axis=-1) & (depth < max_depth)
        scale = bs["f"] * (vm.absdot(bs["wi"], ns) /
                           jnp.maximum(bs["pdf"], 1e-20))[..., None]
        throughput = jnp.where(cont[..., None], throughput * scale,
                               throughput)
        # Specular differential propagation (whitted.cpp:88-136).
        if rx is not None:
            is_trans = jnp.bitwise_and(bs["flags"], B.TRANSMISSION) > 0
            nrxo, nrxd, nryo, nryd = common.specular_ray_differentials(
                dg, ns, wo, bs["wi"], rxd, ryd, bs["eta"], is_trans)
            m = cont[..., None]
            rxo = jnp.where(m, nrxo, rxo)
            rxd = jnp.where(m, nrxd, rxd)
            ryo = jnp.where(m, nryo, ryo)
            ryd = jnp.where(m, nryd, ryd)
        alive = cont
        ro = p
        rd = bs["wi"]
        rmint = rmint * 0.0 + _EPS
        rmaxt = rmaxt * 0.0 + 1e30
        return (ro, rd, rmint, rmaxt, throughput, L, alive, alpha,
                t_first, rxo, rxd, ryo, ryd), None

    # Carry state derived from the (possibly shard_map-varying) ray inputs
    # so lax.scan sees consistent varying axes on every component.
    zero_d = d * 0.0
    init = (o, d, mint + d[..., 0] * 0.0, maxt + d[..., 0] * 0.0,
            jnp.ones_like(o),
            jnp.zeros_like(o),
            d[..., 0] * 0.0 == 0.0,
            d[..., 0] * 0.0,
            maxt + d[..., 0] * 0.0,
            (rx[0] + zero_d) if rx is not None else zero_d,
            (rx[1] + zero_d) if rx is not None else zero_d,
            (ry[0] + zero_d) if rx is not None else zero_d,
            (ry[1] + zero_d) if rx is not None else zero_d)
    carry, _ = jax.lax.scan(body, init, jnp.arange(max_depth + 1))
    return carry[5], carry[7], carry[8]

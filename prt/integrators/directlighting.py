"""Direct-lighting integrator (strategies all/one/weighted) as a wavefront.

Replacement for /root/reference/integrators/directlighting.cpp.
MIS direct lighting via EstimateDirect with the strategy selecting how
lights are sampled (directlighting.cpp:29-31, 106-126); specular recursion
handled like whitted (stochastic specular pick, see whitted.py). The
"weighted" strategy's stateful per-light running averages
(core/transport.cpp:71-122) are inherently sequential; we implement it as
power-proportional light selection — the stationary limit of the
reference's adaptation — which preserves unbiasedness.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..accel import intersect as isect
from ..bsdf import bsdf as B
from ..core import mc, rng, spectrum as spec, vecmath as vm
from ..lights import lights as lt
from ..samplers import samplers as smp
from ..scene.data import SceneData
from . import common

_EPS = vm.RAY_EPSILON


def li(scene: SceneData, o, d, mint, maxt, cfg: smp.SamplerConfig,
       px, py, s_idx, max_depth: int = 5, seed: int = 0,
       strategy: str = "all", rx=None, ry=None):
    n_rays = o.shape[0]
    ph = rng.hash_u32(px, py, seed, 0xD112)
    has_inf = bool(scene.lights.infinite_meta)
    has_lights = scene.lights.count > 0

    if strategy == "weighted" and has_lights:
        pw = spec.luminance(lt.power(scene))
        sel_func, sel_cdf, sel_int = mc.distribution1d_build(pw)

    def body(carry, depth):
        ro, rd, rmint, rmaxt, throughput, L, alive, alpha, t_first = carry
        first = depth == 0

        t, pid, hit = isect.intersect_ids(scene, ro, rd, rmint, rmaxt)
        t_first = jnp.where(first & hit, t, t_first)
        if has_inf:
            esc = ~hit & alive
            Lesc = lt.le_escaped(scene, rd)
            L = L + jnp.where(esc[..., None], throughput * Lesc, 0.0)
            alpha = jnp.where(esc & first & jnp.any(Lesc > 0, -1), 1.0, alpha)
        alive = alive & hit
        alpha = jnp.where(first & hit, 1.0, alpha)

        dg = isect.hit_geometry(scene, pid, ro, rd, t)
        if rx is not None:
            dg = isect.compute_differentials(dg, rx[0], rx[1], ry[0], ry[1],
                                             first & alive)
        Le = lt.area_emission(scene, dg["area_light"], dg["nn"], -rd)
        L = L + jnp.where(alive[..., None], throughput * Le, 0.0)

        bsdf = common.make_bsdf_at(scene, dg)
        p, ns = dg["p"], bsdf.nn
        wo = -rd

        if has_lights:
            ls1, ls2 = smp.integrator_2d(cfg, px, py, s_idx, depth, 11, seed)
            bs1, bs2 = smp.integrator_2d(cfg, px, py, s_idx, depth, 12, seed)
            bcs = smp.integrator_1d(cfg, px, py, s_idx, depth, 13, seed)
            ls3 = rng.uniform(ph, s_idx, depth, 16)
            if strategy == "all":
                # Per-light sampler streams (directlighting.cpp:39-66 fills
                # LD/stratified integrator sample arrays per light; raw hash
                # uniforms here would forfeit the sampler's stratification).
                # All lights' rays share one traversal launch; static kinds
                # let delta lights skip the BSDF-strategy ray.
                kl = scene.lights.kinds_list
                specs = []
                for i in range(scene.lights.count):
                    lid = jnp.full((n_rays,), i, jnp.int32)
                    l1, l2 = smp.integrator_2d(cfg, px, py, s_idx, depth,
                                               100 + 4 * i, seed)
                    b1, b2 = smp.integrator_2d(cfg, px, py, s_idx, depth,
                                               101 + 4 * i, seed)
                    bc = smp.integrator_1d(cfg, px, py, s_idx, depth,
                                           102 + 4 * i, seed)
                    specs.append(dict(light_id=lid, ls1=l1, ls2=l2, ls3=ls3,
                                      bs1=b1, bs2=b2, bcs=bc,
                                      static_kind=kl[i] if kl else None))
                Ld = common.estimate_direct_multi(scene, specs, p, ns, wo,
                                                  bsdf, alive)
            elif strategy == "weighted":
                u_num = smp.integrator_1d(cfg, px, py, s_idx, depth, 10, seed)
                lid, pmf = mc.distribution1d_sample_discrete(
                    sel_func, sel_cdf, sel_int, u_num)
                Ld = common.estimate_direct(
                    scene, lid, p, ns, wo, bsdf, ls1, ls2, ls3, bs1, bs2,
                    bcs, alive) / jnp.maximum(pmf, 1e-12)[..., None]
            else:  # "one"
                u_num = smp.integrator_1d(cfg, px, py, s_idx, depth, 10, seed)
                Ld = common.uniform_sample_one_light(
                    scene, p, ns, wo, bsdf, u_num, ls1, ls2, ls3, bs1, bs2,
                    bcs, alive)
            L = L + jnp.where(alive[..., None], throughput * Ld, 0.0)

        # Specular recursion (directlighting.cpp:128-182) — stochastic pick.
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
        alive = cont
        return (p, bs["wi"], rmint * 0.0 + _EPS,
                rmaxt * 0.0 + 1e30, throughput, L,
                alive, alpha, t_first), None

    # Carry state derived from the (possibly shard_map-varying) ray inputs
    # so lax.scan sees consistent varying axes on every component.
    init = (o, d, mint + d[..., 0] * 0.0, maxt + d[..., 0] * 0.0,
            jnp.ones_like(o),
            jnp.zeros_like(o),
            d[..., 0] * 0.0 == 0.0,
            d[..., 0] * 0.0,
            maxt + d[..., 0] * 0.0)
    carry, _ = jax.lax.scan(body, init, jnp.arange(max_depth + 1))
    return carry[5], carry[7], carry[8]

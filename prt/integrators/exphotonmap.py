"""Extended photon mapping: precomputed radiance photons + importance-
sampled final gather with cone-pdf MIS.

Replacement for /root/reference/integrators/exphotonmap.cpp:
  * Preprocess (exphotonmap.cpp:295-492): the photonmap shooting pass also
    samples radiance-photon candidates with prob 1/8 (:410-421); their
    outgoing radiance Lo = E(+n) rho_r/pi + E(-n) rho_t/pi is precomputed
    from Epanechnikov-kernel irradiance estimates over the direct,
    indirect, and caustic maps (estimateE, :200-245 region + :464-489) and
    stored in a hashed point grid (the kd-tree replacement).
  * Li (exphotonmap.cpp:494-707): area-light emission + all-lights direct
    + kernel caustics + two-strategy final gather: gather rays sampled
    from the BSDF AND from cones around nearby indirect-photon directions
    (gatherangle), MIS-combined with the power heuristic (:517-634); at
    gather hits the NEAREST same-hemisphere radiance photon supplies
    Lindir — one grid lookup instead of three density estimates.

Redesigns (documented):
  * "nearest 50 photons with radius doubling" becomes fixed-radius
    collection: the photon-direction distribution draws a uniform photon
    by streaming reservoir sampling over the in-radius photons, and the
    cone pdf averages over the same in-radius set;
  * the radiance-photon nearest lookup is nearest-within-R (R = 4 x
    maxdist) rather than unbounded.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..accel import intersect as isect
from ..accel.photon_grid import (PointGrid, build_point_grid, gather_photons,
                                 gather_points)
from ..bsdf import bsdf as B
from ..core import mc, rng, vecmath as vm
from ..core.pytree import pytree_dataclass
from ..lights import lights as lt
from ..samplers import samplers as smp
from ..scene.data import SceneData
from . import common
from .photonmap import PhotonMaps, PhotonParams, build_maps, lphoton

_EPS = vm.RAY_EPSILON


class ExPhotonParams(NamedTuple):
    """CreateSurfaceIntegrator defaults (exphotonmap.cpp:709-727)."""
    caustic: int = 20000
    indirect: int = 100000
    direct: int = 100000
    max_dist: float = 0.1
    final_gather: bool = True
    gather_samples: int = 32
    gather_angle: float = 10.0          # degrees
    max_specular_depth: int = 5
    shoot_depth: int = 8
    batch: int = 16384
    max_shot: int = 500000


@pytree_dataclass
class ExPhotonAux:
    maps: PhotonMaps
    radiance: PointGrid                # payload: (n f32[N,3], Lo f32[N,3])
    cos_gather: jnp.ndarray            # f32[]


def _kernel_w(d2, md2):
    """Epanechnikov-style kernel (exphotonmap.cpp:70-75):
    3/(pi md2) (1 - d2/md2)^2."""
    s = 1.0 - d2 / md2
    return (3.0 / (math.pi * md2)) * s * s


def _estimate_e(grid, p, n):
    """estimateE: kernel-weighted irradiance from photons whose arrival
    direction lies in n's hemisphere (exphotonmap.cpp:464-489)."""
    if grid.count == 0:
        return jnp.zeros(p.shape[:-1] + (3,), jnp.float32)
    md2 = jnp.float32(grid.radius * grid.radius)

    def accum(E, wi_b, alpha_b, w, d2):
        ok = w & (jnp.sum(wi_b * n[..., None, :], -1) > 0.0)
        k = _kernel_w(d2, md2)
        return E + jnp.sum(jnp.where(ok[..., None],
                                     alpha_b * k[..., None], 0.0), 1)

    E = gather_photons(grid, p, accum,
                       jnp.zeros(p.shape[:-1] + (3,), jnp.float32))
    return E / grid.n_paths


def build_aux(scene: SceneData, prm: ExPhotonParams, seed: int = 0,
              log=None) -> ExPhotonAux:
    pp = PhotonParams(caustic=prm.caustic, direct=prm.direct,
                      indirect=prm.indirect, max_dist=prm.max_dist,
                      shoot_depth=prm.shoot_depth, batch=prm.batch,
                      max_shot=prm.max_shot)
    maps, rad = build_maps(scene, pp, seed, log=log, collect_radiance=True)

    # Precompute Lo at the radiance photons (exphotonmap.cpp:464-489).
    nrad = len(rad["p"])
    if nrad:
        @jax.jit
        def lo_of(p, n, rho_r, rho_t):
            E_f = (_estimate_e(maps.direct, p, n) +
                   _estimate_e(maps.indirect, p, n) +
                   _estimate_e(maps.caustic, p, n))
            E_b = (_estimate_e(maps.direct, p, -n) +
                   _estimate_e(maps.indirect, p, -n) +
                   _estimate_e(maps.caustic, p, -n))
            inv_pi = jnp.float32(1.0 / math.pi)
            return E_f * inv_pi * rho_r + E_b * inv_pi * rho_t

        Lo = np.asarray(lo_of(jnp.asarray(rad["p"]), jnp.asarray(rad["n"]),
                              jnp.asarray(rad["rho_r"]),
                              jnp.asarray(rad["rho_t"])))
    else:
        Lo = np.zeros((0, 3), np.float32)
    radiance = build_point_grid(rad["p"], (rad["n"], Lo),
                                radius=prm.max_dist * 4.0)
    return ExPhotonAux(maps=maps, radiance=radiance,
                       cos_gather=jnp.asarray(
                           math.cos(math.radians(prm.gather_angle)),
                           jnp.float32))


def _radiance_lookup(grid: PointGrid, p, ng):
    """Nearest same-hemisphere radiance photon's Lo
    (RadiancePhotonProcess, exphotonmap.cpp:53-69)."""
    if grid.count == 0:
        return jnp.zeros(p.shape[:-1] + (3,), jnp.float32)
    big = jnp.full(p.shape[:-1], 1e30)
    zero = jnp.zeros(p.shape[:-1] + (3,), jnp.float32)

    def accum(carry, pp, payload, in_bucket):
        best_d2, best_lo = carry
        n_b, lo_b = payload
        d2 = jnp.sum((pp - p[..., None, :]) ** 2, -1)
        ok = in_bucket & \
            (jnp.sum(n_b * ng[..., None, :], -1) > 0.0) & \
            (d2 < grid.radius * grid.radius)
        d2m = jnp.where(ok, d2, 1e30)
        j = jnp.argmin(d2m, axis=-1)
        cand_d2 = jnp.min(d2m, axis=-1)
        cand_lo = jnp.take_along_axis(
            lo_b, j[..., None, None], axis=-2)[..., 0, :]
        upd = cand_d2 < best_d2
        return (jnp.where(upd, cand_d2, best_d2),
                jnp.where(upd[..., None], cand_lo, best_lo))

    _, lo = gather_points(grid, p, accum, (big, zero))
    return lo


def _photon_dir_pdf(grid, p, wi, cos_ga):
    """pdf of the photon-cone direction distribution at wi: the average of
    UniformConePdf over in-radius indirect photons whose direction is
    within the gather cone of wi (exphotonmap.cpp:570-577, with the
    nearest-50 set replaced by the in-radius set)."""
    cone_pdf = mc.uniform_cone_pdf(cos_ga)

    def accum(carry, wi_b, _alpha_b, w):
        aligned, total = carry
        dots = jnp.sum(wi_b * wi[..., None, :], -1)
        a = w & (dots > 0.999 * cos_ga)
        return (aligned + jnp.sum(a.astype(jnp.float32), -1),
                total + jnp.sum(w.astype(jnp.float32), -1))

    zero = jnp.zeros(p.shape[:-1], jnp.float32)
    aligned, total = gather_photons(grid, p, accum, (zero, zero))
    return jnp.where(total > 0, cone_pdf * aligned /
                     jnp.maximum(total, 1.0), 0.0), total


def _reservoir_photon_dir(grid, p, ph, s_idx, depth, gi):
    """Uniform draw from the in-radius indirect photons' directions by
    streaming reservoir sampling (replaces indexing into the nearest-50
    array, exphotonmap.cpp:588-596)."""
    def accum(carry, wi_b, _alpha_b, w):
        count, dir_sel, step = carry
        # Scan the 27-cell axis sequentially inside this bucket step.
        def cell(j, c):
            cnt, ds = c
            wj = w[..., j]
            cnt2 = cnt + wj.astype(jnp.float32)
            u = rng.uniform(ph, s_idx, depth, gi, step * 32 + j, 0x9E)
            take = wj & (u * cnt2 < 1.0)
            ds = jnp.where(take[..., None], wi_b[..., j, :], ds)
            return cnt2, ds
        count, dir_sel = jax.lax.fori_loop(0, w.shape[-1], cell,
                                           (count, dir_sel))
        return count, dir_sel, step + 1

    zero = jnp.zeros(p.shape[:-1], jnp.float32)
    dir0 = jnp.zeros(p.shape[:-1] + (3,), jnp.float32)
    count, dir_sel, _ = gather_photons(grid, p, accum,
                                       (zero, dir0, jnp.int32(0)))
    return dir_sel, count > 0


def lphoton_kernel(grid, bsdf, wo, p, active, may_glossy: bool = True):
    """LPhoton with the Epanechnikov kernel (exphotonmap.cpp:70-75,
    :200-245) instead of photonmap's flat 1/(pi r^2). Diffuse surfaces
    take the reference's rho shortcut (exphotonmap.cpp:228-245):
    kernel-weighted hemisphere flux sums in the loop, one rho(wo)
    multiply outside; per-photon f only for glossy lanes (skipped at
    trace time when may_glossy is False)."""
    if grid.count == 0:
        return jnp.zeros(p.shape[:-1] + (3,), jnp.float32)
    md2 = jnp.float32(grid.radius * grid.radius)
    import math as _math
    from ..core import vecmath as _vm
    nf = jnp.where(_vm.dot(wo, bsdf.nn)[..., None] < 0.0, -bsdf.nn,
                   bsdf.nn)
    zero3 = jnp.zeros(p.shape[:-1] + (3,), jnp.float32)

    def accum(carry, wi_b, alpha_b, w, d2):
        Lr, Lt, Lg = carry
        k = _kernel_w(d2, md2)
        ka = alpha_b * k[..., None]
        front = jnp.sum(wi_b * nf[..., None, :], -1) > 0.0
        Lr = Lr + jnp.sum(jnp.where((w & front)[..., None], ka, 0.0), 1)
        Lt = Lt + jnp.sum(jnp.where((w & ~front)[..., None], ka, 0.0), 1)
        if may_glossy:
            f_val = jax.vmap(lambda wi: B.f(bsdf, wo, wi),
                             in_axes=1, out_axes=1)(wi_b)
            Lg = Lg + jnp.sum(jnp.where(w[..., None], f_val * ka, 0.0), 1)
        return Lr, Lt, Lg

    Lr, Lt, Lg = gather_photons(grid, p, accum, (zero3, zero3, zero3))
    L_diff = (Lr * B.rho_approx(bsdf, B.ALL_REFLECTION) +
              Lt * B.rho_approx(bsdf, B.ALL_TRANSMISSION)) / _math.pi
    if may_glossy:
        glossy = B.num_components(
            bsdf, B.REFLECTION | B.TRANSMISSION | B.GLOSSY) > 0
        L = jnp.where(glossy[..., None], Lg, L_diff)
    else:
        L = L_diff
    return jnp.where(active[..., None], L / grid.n_paths, 0.0)


def li(scene: SceneData, aux: ExPhotonAux, o, d, mint, maxt,
       cfg: smp.SamplerConfig, px, py, s_idx, max_depth: int = 5,
       seed: int = 0, prm: ExPhotonParams = ExPhotonParams(),
       rx=None, ry=None):
    n_rays = o.shape[0]
    ph = rng.hash_u32(px, py, seed, 0xE9B)
    has_inf = bool(scene.lights.infinite_meta)
    from .photonmap import GLOSSY_LOBE_KINDS
    mg = any(k in GLOSSY_LOBE_KINDS
             for k in (scene.materials.lobe_kinds or ()))
    maps = aux.maps
    cos_ga = aux.cos_gather
    gs = prm.gather_samples

    def body(carry, depth):
        ro, rd, throughput, L, alive, alpha_acc, t_first = carry
        first = depth == 0
        t, pid, hit = isect.intersect_ids(
            scene, ro, rd,
            jnp.where(first, mint, jnp.full((n_rays,), _EPS)),
            jnp.where(first, maxt, jnp.full((n_rays,), 1e30)))
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
        p, ns = dg["p"], bsdf.nn

        # Direct: all lights with MIS (exphotonmap.cpp:513-517).
        def sample_fn(light_i, kind):
            return rng.uniform2(ph, s_idx, depth, light_i, kind)
        Ld = common.uniform_sample_all_lights(scene, p, ns, wo, bsdf,
                                              sample_fn, alive)
        L = L + jnp.where(alive[..., None], throughput * Ld, 0.0)

        # Caustics via kernel estimate (exphotonmap.cpp:524-525).
        L = L + throughput * lphoton_kernel(maps.caustic, bsdf, wo, p,
                                            alive, may_glossy=mg)

        if prm.final_gather and maps.indirect.count > 0 and \
                aux.radiance.count > 0:
            def gather_one(acc, gi):
                # --- Strategy 1: BSDF-sampled gather ray (:544-583) ---
                g1 = rng.uniform(ph, s_idx, depth, gi, 0x61)
                g2 = rng.uniform(ph, s_idx, depth, gi, 0x62)
                g3 = rng.uniform(ph, s_idx, depth, gi, 0x63)
                bs = B.sample_f(bsdf, wo, g1, g2, g3, B.ALL & ~B.SPECULAR)
                ok1 = alive & bs["valid"] & (bs["pdf"] > 0.0) & \
                    jnp.any(bs["f"] > 0.0, -1)
                t1h, pid1, hit1 = isect.intersect_ids(
                    scene, p, bs["wi"], jnp.full((n_rays,), _EPS),
                    jnp.full((n_rays,), 1e30))
                ok1 = ok1 & hit1
                g1dg = isect.hit_geometry_light(scene, pid1, p, bs["wi"],
                                                t1h)
                ng1 = jnp.where(
                    vm.dot(g1dg["nn"], bs["wi"])[..., None] > 0,
                    -g1dg["nn"], g1dg["nn"])
                Lind1 = _radiance_lookup(aux.radiance, g1dg["p"], ng1)
                ppdf1, _found = _photon_dir_pdf(maps.indirect, p, bs["wi"],
                                                cos_ga)
                wt1 = mc.power_heuristic(gs, bs["pdf"], gs, ppdf1)
                c1 = bs["f"] * Lind1 * (vm.absdot(bs["wi"], ns) * wt1 /
                                        jnp.maximum(bs["pdf"],
                                                    1e-20))[..., None]
                acc = acc + jnp.where(ok1[..., None], c1, 0.0)

                # --- Strategy 2: photon-cone-sampled ray (:585-634) ---
                pdir, has_p = _reservoir_photon_dir(maps.indirect, p, ph,
                                                    s_idx, depth, gi)
                u2 = rng.uniform(ph, s_idx, depth, gi, 0x72)
                u3 = rng.uniform(ph, s_idx, depth, gi, 0x73)
                _, vx, vy = vm.coordinate_system(pdir)
                wi2 = mc.uniform_sample_cone_frame(u2, u3, cos_ga, vx, vy,
                                                   pdir)
                f2 = B.f(bsdf, wo, wi2)
                ppdf2, _f2 = _photon_dir_pdf(maps.indirect, p, wi2, cos_ga)
                ok2 = alive & has_p & (ppdf2 > 0.0) & \
                    jnp.any(f2 > 0.0, -1)
                t2h, pid2, hit2 = isect.intersect_ids(
                    scene, p, wi2, jnp.full((n_rays,), _EPS),
                    jnp.full((n_rays,), 1e30))
                ok2 = ok2 & hit2
                g2dg = isect.hit_geometry_light(scene, pid2, p, wi2, t2h)
                ng2 = jnp.where(vm.dot(g2dg["nn"], wi2)[..., None] > 0,
                                -g2dg["nn"], g2dg["nn"])
                Lind2 = _radiance_lookup(aux.radiance, g2dg["p"], ng2)
                bpdf2 = B.pdf(bsdf, wo, wi2, B.ALL & ~B.SPECULAR)
                wt2 = mc.power_heuristic(gs, ppdf2, gs, bpdf2)
                c2 = f2 * Lind2 * (vm.absdot(wi2, ns) * wt2 /
                                   jnp.maximum(ppdf2, 1e-20))[..., None]
                acc = acc + jnp.where(ok2[..., None], c2, 0.0)
                return acc, None

            Lg, _ = jax.lax.scan(gather_one,
                                 jnp.zeros((n_rays, 3), jnp.float32),
                                 jnp.arange(gs))
            L = L + throughput * Lg / float(gs)
        else:
            L = L + throughput * lphoton(maps.indirect, bsdf, wo, p, alive)

        # Specular continuation (exphotonmap.cpp:645-707), stochastic
        # single pick as in whitted.py.
        u1 = rng.uniform(ph, s_idx, depth, 0x5A, 1)
        u2 = rng.uniform(ph, s_idx, depth, 0x5A, 2)
        u3 = rng.uniform(ph, s_idx, depth, 0x5A, 3)
        bs = B.sample_f(bsdf, wo, u1, u2, u3,
                        B.SPECULAR | B.REFLECTION | B.TRANSMISSION)
        cont = alive & bs["valid"] & (bs["pdf"] > 0.0) & \
            ~jnp.all(bs["f"] == 0.0, axis=-1) & \
            (depth < prm.max_specular_depth)
        scale = bs["f"] * (vm.absdot(bs["wi"], ns) /
                           jnp.maximum(bs["pdf"], 1e-20))[..., None]
        throughput = jnp.where(cont[..., None], throughput * scale,
                               throughput)
        return (p, bs["wi"], throughput, L, cont, alpha_acc, t_first), None

    init = (o, d, jnp.ones_like(o), jnp.zeros_like(o),
            d[..., 0] * 0.0 == 0.0, d[..., 0] * 0.0,
            maxt + d[..., 0] * 0.0)
    depth_n = min(max_depth, prm.max_specular_depth) + 1
    carry, _ = jax.lax.scan(body, init, jnp.arange(depth_n))
    return carry[3], carry[5], carry[6]

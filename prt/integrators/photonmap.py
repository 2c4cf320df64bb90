"""Photon mapping as wavefront passes + grid-hash density estimation.

Replacement for /root/reference/integrators/photonmap.cpp:
  * Preprocess (photonmap.cpp:147-298): QMC photon shooting becomes jitted
    fixed-size path batches under lax.scan; the host loop keeps batching
    until each map (direct/caustic/indirect) reaches its target count,
    exactly like the reference's while loop. Classification is identical:
    first hit -> direct, all-specular prefix -> caustic, else indirect;
    photons deposit only on surfaces with a non-specular component.
  * Storage (core/kdtree.h): grid-hash buckets (accel/photon_grid.py)
    instead of a pointer kd-tree.
  * LPhoton (photonmap.cpp:433-483): fixed-radius estimate
    sum f(wo, wi_p) * alpha_p / (n_paths * pi * maxDist^2), with the
    reference's diffuse rho-shortcut (flux sums in the loop, one rho
    multiply outside; per-photon f only on glossy lanes, skipped at
    trace time for glossy-free scenes); kNN radius shrinking is replaced
    by fixed radius (documented in photon_grid.py).
  * Li (photonmap.cpp:299-431): direct via all-lights MIS sampling (or the
    direct map), caustics + indirect via maps, optional one-bounce final
    gather, stochastic single-pick specular continuation (whitted-style
    wavefront flattening of the two-way recursion).

Divergences (documented): shooting depth is a static bound (default 8)
rather than RR-only termination; gather rays use hash-RNG streams instead
of precomputed sampler arrays.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..accel import intersect as isect
from ..accel.photon_grid import PhotonGrid, build_photon_grid, gather_photons
from ..bsdf import bsdf as B
from ..core import rng, vecmath as vm
from ..core.pytree import pytree_dataclass
from ..lights import emission, lights as lt
from ..samplers import samplers as smp
from ..scene.data import SceneData
from . import common

_EPS = vm.RAY_EPSILON


class PhotonParams(NamedTuple):
    """CreateSurfaceIntegrator defaults (photonmap.cpp:511-524)."""
    caustic: int = 20000
    direct: int = 100000
    indirect: int = 100000
    max_dist: float = 0.1
    final_gather: bool = False
    gather_samples: int = 32
    direct_with_photons: bool = False
    shoot_depth: int = 8          # static wavefront bound (RR starts at 4)
    # 64K-path shooting batches: the build loop syncs the host per batch
    # (collection/classification is numpy), so batch count is the fixed
    # cost that matters (31 x 16K batches measured ~11s of mostly host
    # time; 8 x 64K ~3s).
    batch: int = 65536
    max_shot: int = 500000


@pytree_dataclass
class PhotonMaps:
    caustic: PhotonGrid
    direct: PhotonGrid
    indirect: PhotonGrid


# ---------------------------------------------------------------------------
# Shooting (Preprocess)
# ---------------------------------------------------------------------------

def shoot_batch(scene: SceneData, base: int, n: int, depth_bound: int,
                seed: int, radiance: bool = False):
    """Trace n photon paths with global path ids base..base+n-1.

    Returns per-depth stacked arrays [D, n]: pos, wi, alpha, cls
    (0 direct / 1 caustic / 2 indirect), valid; with radiance=True the
    tuple extends with (nn, rho_r, rho_t, rad_pick) for exphotonmap's
    radiance photons (exphotonmap.cpp:410-421: candidate with prob 1/8,
    normal flipped against the photon direction, rho per hemisphere)."""
    idx = jnp.arange(n, dtype=jnp.uint32) + jnp.uint32(base + 1)
    u0 = rng.radical_inverse(idx, 2)
    u1 = rng.radical_inverse(idx, 3)
    u2 = rng.radical_inverse(idx, 5)
    u3 = rng.radical_inverse(idx, 7)
    ul = rng.radical_inverse(idx, 11)
    ph = rng.hash_u32(idx, seed, 0x9107)
    u5 = rng.uniform(ph, 0, 0x51)

    lid, light_pdf = emission.pick_light_uniform(scene, ul)
    em = emission.sample_emission(scene, lid, u0, u1, u2, u3, u5)
    denom = jnp.maximum(em["pdf"] * light_pdf, 1e-20)
    alpha = em["Le"] / denom[..., None]
    alive = (em["pdf"] > 0.0) & jnp.any(alpha > 0.0, -1)

    def body(carry, depth):
        o, d, alpha, spec_path, alive = carry
        t, pid, hit = isect.intersect_ids(scene, o, d,
                                          jnp.full((n,), _EPS),
                                          jnp.full((n,), 1e30))
        alive = alive & hit
        dg = isect.hit_geometry(scene, pid, o, d, t)
        if scene.volumes is not None and scene.volumes.count > 0:
            from . import volume as vol_integ
            uj = rng.uniform(ph, depth, 0x7A)
            Tr = vol_integ.transmittance(scene, o, d,
                                         jnp.full((n,), _EPS), t, uj)
            alpha = alpha * Tr
        bsdf = common.make_bsdf_at(scene, dg)
        nspec = B.num_components(bsdf, B.SPECULAR | B.REFLECTION |
                                 B.TRANSMISSION)
        has_nonspec = B.num_components(bsdf, B.ALL) > nspec
        cls = jnp.where(depth == 0, 0, jnp.where(spec_path, 1, 2))
        out = (dg["p"], -d, alpha, cls, alive & has_nonspec)
        if radiance:
            nn_f = jnp.where(vm.dot(dg["nn"], d)[..., None] > 0.0,
                             -dg["nn"], dg["nn"])
            rho_r = B.rho_approx(bsdf, B.ALL_REFLECTION)
            rho_t = B.rho_approx(bsdf, B.ALL_TRANSMISSION)
            pick = rng.uniform(ph, depth, 0xAD) < 0.125
            out = out + (nn_f, rho_r, rho_t, pick)

        # Continuation (photonmap.cpp:262-292): QMC dims at the first
        # bounce, hash RNG after.
        c1 = jnp.where(depth == 0, rng.radical_inverse(idx, 13),
                       rng.uniform(ph, depth, 1))
        c2 = jnp.where(depth == 0, rng.radical_inverse(idx, 17),
                       rng.uniform(ph, depth, 2))
        c3 = jnp.where(depth == 0, rng.radical_inverse(idx, 19),
                       rng.uniform(ph, depth, 3))
        bs = B.sample_f(bsdf, -d, c1, c2, c3, B.ALL)
        ok = bs["valid"] & (bs["pdf"] > 0.0) & jnp.any(bs["f"] > 0.0, -1)
        spec_path = ((depth == 0) | spec_path) & bs["specular"]
        scale = bs["f"] * (vm.absdot(bs["wi"], bsdf.nn) /
                           jnp.maximum(bs["pdf"], 1e-20))[..., None]
        alpha2 = alpha * scale
        # RR after the 4th intersection (nIntersections > 3 <=> depth >= 3).
        rr = rng.uniform(ph, depth, 0xEE)
        cont = (depth < 3) | (rr <= 0.5)
        alpha2 = jnp.where((depth >= 3)[..., None] & cont[..., None],
                           alpha2 * 2.0, alpha2)
        alive = alive & ok & cont
        return (dg["p"], bs["wi"], alpha2, spec_path, alive), out

    init = (em["o"], em["d"], alpha,
            jnp.zeros((n,), bool), alive)
    _, outs = jax.lax.scan(body, init, jnp.arange(depth_bound))
    return outs   # (pos [D,n,3], wi, alpha, cls [D,n], valid [D,n])


def _shoot_packed(scene: SceneData, base, n: int, depth_bound: int,
                  seed: int, radiance: bool):
    """shoot_batch + device-side compaction: valid deposits sorted first
    (path-major, so photon order still follows global path ids) and a
    count, so the host transfers ONLY the valid rows instead of the raw
    [D, n] arrays (~50 MB/batch)."""
    outs = shoot_batch(scene, base, n, depth_bound, seed,
                       radiance=radiance)
    pos, wi, al, cls, valid = outs[:5]

    def pm(x):
        return jnp.swapaxes(x, 0, 1).reshape((n * depth_bound,) +
                                             x.shape[2:])

    v = pm(valid)
    pid = jnp.repeat(jnp.arange(n, dtype=jnp.int32) + base, depth_bound)
    order = jnp.argsort(jnp.where(v, 0, 1), stable=True)
    res = dict(P=pm(pos)[order], W=pm(wi)[order], A=pm(al)[order],
               C=pm(cls)[order], I=pid[order],
               cnt=jnp.sum(v.astype(jnp.int32)))
    if radiance:
        nn_, rr_, rt_, pick = outs[5:9]
        vr = pm(valid & pick)
        order_r = jnp.argsort(jnp.where(vr, 0, 1), stable=True)
        res.update(RP=pm(pos)[order_r], RN=pm(nn_)[order_r],
                   RR=pm(rr_)[order_r], RT=pm(rt_)[order_r],
                   rcnt=jnp.sum(vr.astype(jnp.int32)))
    return res


_shoot_packed_jit = jax.jit(
    _shoot_packed, static_argnames=("n", "depth_bound", "seed", "radiance"))


def build_maps(scene: SceneData, prm: PhotonParams, seed: int = 0,
               log=None, collect_radiance: bool = False):
    """Host loop around jitted batches (the reference's Preprocess while
    loop, photonmap.cpp:163-296). Exact normalization: each map's n_paths
    is the number of paths shot up to and including the one that filled
    it (photon path ids make this exact even with batching)."""
    targets = {"direct": prm.direct, "caustic": prm.caustic,
               "indirect": prm.indirect}
    if scene.lights.count == 0 or all(v == 0 for v in targets.values()):
        empty = build_photon_grid(np.zeros((0, 3), np.float32),
                                  np.zeros((0, 3), np.float32),
                                  np.zeros((0, 3), np.float32),
                                  prm.max_dist, 1.0)
        maps = PhotonMaps(caustic=empty, direct=empty, indirect=empty)
        if collect_radiance:
            return maps, dict(p=np.zeros((0, 3), np.float32),
                              n=np.zeros((0, 3), np.float32),
                              rho_r=np.zeros((0, 3), np.float32),
                              rho_t=np.zeros((0, 3), np.float32))
        return maps

    # Module-level jit: a fresh lambda per call re-traced the whole
    # shooting graph (~2s host) every build.
    def shoot(b):
        return _shoot_packed_jit(scene, b, n=prm.batch,
                                 depth_bound=prm.shoot_depth, seed=seed,
                                 radiance=collect_radiance)
    rad = {"p": [], "n": [], "rho_r": [], "rho_t": []}
    coll = {k: {"pos": [], "wi": [], "alpha": [], "pid": []}
            for k in targets}
    shot = 0
    dispatched = 0
    pending = None
    while shot < prm.max_shot:
        # One batch in flight ahead: reading cnt syncs the device, so
        # dispatch the next batch first (its ~50 ms of shooting overlaps
        # this batch's host-side collection).
        if pending is None:
            pending = shoot(shot)
            dispatched = shot + prm.batch
        res = pending
        if dispatched < prm.max_shot:
            pending = shoot(dispatched)
            dispatched += prm.batch
        else:
            pending = None
        cnt = int(res["cnt"])
        if collect_radiance:
            rcnt = int(res["rcnt"])
            rad["p"].append(np.asarray(res["RP"][:rcnt]))
            rad["n"].append(np.asarray(res["RN"][:rcnt]))
            rad["rho_r"].append(np.asarray(res["RR"][:rcnt]))
            rad["rho_t"].append(np.asarray(res["RT"][:rcnt]))
        # Already path-major + valid-compacted on device (_shoot_packed):
        # photon order follows global path ids.
        order = (np.asarray(res["P"][:cnt]), np.asarray(res["W"][:cnt]),
                 np.asarray(res["A"][:cnt]),
                 np.asarray(res["C"][:cnt]),
                 np.ones((cnt,), bool),
                 np.asarray(res["I"][:cnt]).astype(np.int64))
        shot += prm.batch
        done = True
        for ci, k in enumerate(("direct", "caustic", "indirect")):
            have = sum(len(x) for x in coll[k]["pid"]) if coll[k]["pid"] \
                else 0
            if have < targets[k]:
                m = order[4] & (order[3] == ci)
                coll[k]["pos"].append(order[0][m])
                coll[k]["wi"].append(order[1][m])
                coll[k]["alpha"].append(order[2][m])
                coll[k]["pid"].append(order[5][m])
                have += int(m.sum())
            if have < targets[k]:
                done = False
        if log:
            log(f"photons: shot={shot} " + " ".join(
                f"{k}={sum(len(x) for x in coll[k]['pid'])}/{targets[k]}"
                for k in targets))
        if done:
            break
        # "unsuccessful" bail (photonmap.cpp:139-144, 165-177): stop when
        # every still-unfilled map has found nothing (or < shot/1024) —
        # it will never fill (e.g. no caustic paths exist in the scene).
        if shot >= 8 * prm.batch:
            def _stalled(k):
                have = sum(len(x) for x in coll[k]["pid"])
                return have >= targets[k] or have == 0 or \
                    have < shot // 1024
            if all(_stalled(k) for k in targets):
                break

    grids = {}
    for k in targets:
        pos = np.concatenate(coll[k]["pos"]) if coll[k]["pos"] else \
            np.zeros((0, 3), np.float32)
        wi = np.concatenate(coll[k]["wi"]) if coll[k]["wi"] else \
            np.zeros((0, 3), np.float32)
        al = np.concatenate(coll[k]["alpha"]) if coll[k]["alpha"] else \
            np.zeros((0, 3), np.float32)
        pid = np.concatenate(coll[k]["pid"]) if coll[k]["pid"] else \
            np.zeros((0,), np.int64)
        tgt = targets[k]
        if len(pid) > tgt:
            n_paths = float(pid[tgt - 1] + 1)
            pos, wi, al = pos[:tgt], wi[:tgt], al[:tgt]
        else:
            n_paths = float(shot)
        grids[k] = build_photon_grid(pos, wi, al, prm.max_dist, n_paths)
    maps = PhotonMaps(**grids)
    if collect_radiance:
        cat = {k: (np.concatenate(v) if v else
                   np.zeros((0, 3), np.float32)) for k, v in rad.items()}
        return maps, cat
    return maps


# ---------------------------------------------------------------------------
# Density estimation (LPhoton)
# ---------------------------------------------------------------------------

GLOSSY_LOBE_KINDS = (B.BX_MICROFACET, B.BX_FRESNELBLEND)


def lphoton(grid: PhotonGrid, bsdf: B.BsdfBatch, wo, p, active,
            may_glossy: bool = True):
    """Fixed-radius photon radiance estimate (photonmap.cpp:433-483).

    Like the reference, diffuse-only surfaces take the rho shortcut:
    the per-photon loop accumulates hemisphere flux sums Lr/Lt and ONE
    rho(wo) multiply happens outside (photonmap.cpp:472-481). The
    per-photon BSDF evaluation (photonmap.cpp:464-470) only runs for
    lanes with a glossy component — and is skipped at TRACE time when
    the scene's static lobe-kind set has no glossy lobes (may_glossy),
    which is what makes the gather loop pure flux arithmetic on typical
    photon-map scenes (it was the dominant render cost when evaluated
    per photon unconditionally)."""
    if grid.count == 0:
        return jnp.zeros(p.shape[:-1] + (3,), jnp.float32)
    nf = jnp.where(vm.dot(wo, bsdf.nn)[..., None] < 0.0, -bsdf.nn,
                   bsdf.nn)
    zero3 = jnp.zeros(p.shape[:-1] + (3,), jnp.float32)

    def accum(carry, wi_b, alpha_b, w):
        Lr, Lt, Lg = carry
        front = jnp.sum(wi_b * nf[..., None, :], -1) > 0.0
        Lr = Lr + jnp.sum(jnp.where((w & front)[..., None], alpha_b, 0.0),
                          1)
        Lt = Lt + jnp.sum(jnp.where((w & ~front)[..., None], alpha_b,
                                    0.0), 1)
        if may_glossy:
            f_val = jax.vmap(lambda wi: B.f(bsdf, wo, wi),
                             in_axes=1, out_axes=1)(wi_b)
            Lg = Lg + jnp.sum(jnp.where(w[..., None], f_val * alpha_b,
                                        0.0), 1)
        return Lr, Lt, Lg

    Lr, Lt, Lg = gather_photons(grid, p, accum, (zero3, zero3, zero3))
    scale = 1.0 / (grid.n_paths * math.pi * grid.radius * grid.radius)
    L_diff = (Lr * B.rho_approx(bsdf, B.ALL_REFLECTION) +
              Lt * B.rho_approx(bsdf, B.ALL_TRANSMISSION)) / math.pi
    if may_glossy:
        glossy = B.num_components(
            bsdf, B.REFLECTION | B.TRANSMISSION | B.GLOSSY) > 0
        L = jnp.where(glossy[..., None], Lg, L_diff)
    else:
        L = L_diff
    return jnp.where(active[..., None], L * scale, 0.0)


# ---------------------------------------------------------------------------
# Li
# ---------------------------------------------------------------------------

def photon_radiance(scene: SceneData, maps: PhotonMaps, prm: PhotonParams,
                    bsdf, wo, p, ns, alive, ph, s_idx, depth):
    """Non-recursive radiance core of Li at shading points — direct
    lighting + caustic map + indirect map / flat final gather
    (photonmap.cpp:315-364) — shared by the scan driver (li) and the
    regenerating wavefront pool (path_wavefront mode="photonmap").
    Returns per-lane radiance, already masked to `alive` lanes. RNG
    streams are functions of (ph, s_idx, depth, purpose) only, so both
    drivers compute identical estimates per camera sample."""
    n_rays = p.shape[0]
    # Trace-time fact: per-photon BSDF evaluation exists only for scenes
    # whose material set includes a glossy lobe (see lphoton).
    mg = any(k in GLOSSY_LOBE_KINDS
             for k in (scene.materials.lobe_kinds or ()))

    # Direct lighting (photonmap.cpp:315-323).
    if prm.direct_with_photons:
        Ld = lphoton(maps.direct, bsdf, wo, p, alive, may_glossy=mg)
    else:
        def sample_fn(light_i, kind):
            return rng.uniform2(ph, s_idx, depth, light_i, kind)
        Ld = common.uniform_sample_all_lights(scene, p, ns, wo, bsdf,
                                              sample_fn, alive)
    Lsum = jnp.where(alive[..., None], Ld, 0.0)

    # Caustics always come from the caustic map.
    Lsum = Lsum + lphoton(maps.caustic, bsdf, wo, p, alive, may_glossy=mg)

    if prm.final_gather and maps.indirect.count > 0:
        # Flat-batched final gather (photonmap.cpp:327-364's per-sample
        # loop): gather samples run Gb AT A TIME as one widened
        # wavefront (lane i*Gb+g = ray i's sample g), under a short scan
        # over sample blocks. Blocking bounds BOTH the scan length and
        # the widened width (n_rays x Gb <= ~128K, a bound inherited from
        # an earlier build and not yet measured on the H100; ROADMAP A4).
        # RNG streams are per (pixel, sample, depth, g) exactly as
        # before -> identical estimates.
        G = prm.gather_samples
        Gb = max(1, min(G, (1 << 17) // max(n_rays, 1)))
        while G % Gb:
            Gb -= 1

        def rep(x):
            return jnp.repeat(x, Gb, axis=0)

        bsdfG = jax.tree_util.tree_map(rep, bsdf)
        phG, sG = rep(ph), rep(s_idx)
        woG, pG, nsG = rep(wo), rep(p), rep(ns)
        aliveG = rep(alive)
        # depth is a scalar scan index under the scan driver but a
        # PER-LANE bounce array under the wavefront pool — widen it too.
        dG = rep(depth) if getattr(depth, "ndim", 0) > 0 else depth
        g_base = jnp.tile(jnp.arange(Gb, dtype=jnp.int32), n_rays)

        def gather_block(acc, blk):
            gi = g_base + blk * Gb
            g1 = rng.uniform(phG, sG, dG, gi, 0x61)
            g2 = rng.uniform(phG, sG, dG, gi, 0x62)
            g3 = rng.uniform(phG, sG, dG, gi, 0x63)
            bs = B.sample_f(bsdfG, woG, g1, g2, g3, B.ALL & ~B.SPECULAR)
            gok = aliveG & bs["valid"] & (bs["pdf"] > 0.0) & \
                jnp.any(bs["f"] > 0.0, -1)
            # Provably-zero lanes carry degenerate rays (empty windows)
            # so the walk retires them at once.
            gt, gpid, ghit = isect.intersect_ids(
                scene, pG, bs["wi"],
                jnp.where(gok, _EPS, 1.0),
                jnp.where(gok, 1e30, -1.0))
            gok = gok & ghit
            gdg = isect.hit_geometry(scene, gpid, pG, bs["wi"], gt)
            gbsdf = common.make_bsdf_at(scene, gdg)
            gwo = -bs["wi"]
            Lind = (lphoton(maps.direct, gbsdf, gwo, gdg["p"], gok,
                            may_glossy=mg) +
                    lphoton(maps.indirect, gbsdf, gwo, gdg["p"], gok,
                            may_glossy=mg) +
                    lphoton(maps.caustic, gbsdf, gwo, gdg["p"], gok,
                            may_glossy=mg))
            contrib = bs["f"] * Lind * \
                (vm.absdot(bs["wi"], nsG) /
                 jnp.maximum(bs["pdf"], 1e-20))[..., None]
            dLg = jnp.where(gok[..., None], contrib,
                            0.0).reshape(n_rays, Gb, 3).sum(1)
            return acc + dLg, None

        if G // Gb > 1:
            Lg, _ = jax.lax.scan(gather_block,
                                 jnp.zeros((n_rays, 3), jnp.float32),
                                 jnp.arange(G // Gb))
        else:
            Lg, _ = gather_block(jnp.zeros((n_rays, 3), jnp.float32),
                                 jnp.int32(0))
        Lsum = Lsum + Lg / float(G)
    else:
        Lsum = Lsum + lphoton(maps.indirect, bsdf, wo, p, alive,
                              may_glossy=mg)
    return Lsum


# ---------------------------------------------------------------------------
# Li
# ---------------------------------------------------------------------------

def li(scene: SceneData, maps: PhotonMaps, o, d, mint, maxt,
       cfg: smp.SamplerConfig, px, py, s_idx, max_depth: int = 5,
       seed: int = 0, prm: PhotonParams = PhotonParams(),
       rx=None, ry=None):
    n_rays = o.shape[0]
    ph = rng.hash_u32(px, py, seed, 0x9B1)
    has_inf = bool(scene.lights.infinite_meta)

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

        L = L + throughput * photon_radiance(scene, maps, prm, bsdf, wo,
                                             p, ns, alive, ph, s_idx,
                                             depth)

        # Specular continuation (photonmap.cpp:366-425), stochastic
        # single pick as in whitted.py.
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
        return (p, bs["wi"], throughput, L, cont, alpha_acc, t_first), None

    init = (o, d, jnp.ones_like(o), jnp.zeros_like(o),
            d[..., 0] * 0.0 == 0.0, d[..., 0] * 0.0,
            maxt + d[..., 0] * 0.0)
    carry, _ = jax.lax.scan(body, init, jnp.arange(max_depth + 1))
    return carry[3], carry[5], carry[6]

"""Wavefront path tracing with path regeneration (stream compaction).

The scan-based integrator (path.py) carries every camera sample through
max_depth+1 bounce passes even after its path dies; in a depth-5 Cornell
trace most lanes are dead after 2-3 bounces, so roughly half the
intersect/shade work is wasted (SURVEY.md step 3 calls for compaction).

On a vector machine the idiomatic fix is not physical compaction (a sort
+ gather that still leaves a ragged tail) but **path regeneration**: one
fixed-size lane pool; the moment a lane's path terminates, its radiance
is splatted to the film and the lane immediately restarts with the next
(pixel, sample) from a global cursor. Every pass then runs at ~full lane
occupancy until the sample space drains. This is the wavefront analogue of the
wavefront/persistent-threads design, replacing the reference's one-
sample-at-a-time loop (/root/reference/core/scene.cpp:42-83).

Estimator equivalence: every random stream is a pure function of
(pixel, sample-index, bounce, purpose) — never of lane position or
scheduling — so each camera sample computes exactly what path.li computes
and the developed image matches to scatter-add reordering (~1e-6).

Semantics preserved from path.cpp:58-145 via the same building blocks:
MIS one-light NEE, Le only on first/post-specular vertices, RR p=0.5
after bounce 3. Volume scenes compose Scene::Li's L = T*Lo + Lv inline at
the bounce-0 pass (T folded into throughput before any radiance
accumulates, Lv splatted once), so the regenerating pool handles Volume
statements without falling back to the scan driver.
"""
from __future__ import annotations

import math
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..accel import intersect as isect
from ..bsdf import bsdf as B
from ..cameras import cameras as cam_mod
from ..core import rng, vecmath as vm
from ..film import film as film_mod
from ..lights import lights as lt
from ..samplers import samplers as smp
from ..scene.data import SceneData
from . import common

_EPS = vm.RAY_EPSILON


def _rank_among_true(mask):
    """Exclusive prefix count of a bool[N]: out[i] = #True among mask[:i].

    Two-level formulation: an intra-block inclusive prefix via a
    [128,128] triangular matmul + a short cumsum over per-block sums. Exact
    in f32 (counts < 2^24) because matmuls run at "highest" precision
    (prt/__init__.py). It replaced jnp.cumsum in an earlier build; it is not
    yet compared with jnp.cumsum on the H100 (ROADMAP A5).
    """
    n = mask.shape[0]
    block = 128
    nb = -(-n // block)
    x = mask.astype(jnp.float32)
    if nb * block != n:
        x = jnp.pad(x, (0, nb * block - n))
    xb = x.reshape(nb, block)
    # T[i,j] = 1 iff i <= j  ->  (xb @ T)[b,j] = inclusive prefix in block.
    tri = jnp.triu(jnp.ones((block, block), jnp.float32))
    intra = xb @ tri
    sums = xb.sum(axis=1)
    offs = jnp.concatenate([jnp.zeros((1,), jnp.float32),
                            jnp.cumsum(sums)[:-1]])
    incl = intra + offs[:, None]
    excl = incl.reshape(-1)[:n] - x[:n]
    return excl.astype(jnp.int32)


def _regen(scene: SceneData, cfg, lin, seed, xres, yres, xstart, xcount,
           ystart, spp):
    """Fresh camera rays (+x/+y differentials) for linear sample ids.

    lin is uint32: linear sample ids run to xres*yres*spp, which exceeds
    int32 at 4Kx4K x 128spp; uint32 doubles the headroom (render() guards
    the 2^32 ceiling)."""
    lin = lin.astype(jnp.uint32)
    s_idx = (lin % spp).astype(jnp.int32)
    pix = lin // spp
    px = (xstart + pix % xcount).astype(jnp.int32)
    py = (ystart + pix // xcount).astype(jnp.int32)
    cs = smp.camera_samples(cfg, px, py, s_idx, seed)
    o, d, mint, maxt, _t = cam_mod.generate_rays(
        scene.camera, cs["image_x"], cs["image_y"], cs["lens_u"],
        cs["lens_v"], cs["time"], xres, yres)
    o_rx, d_rx, *_ = cam_mod.generate_rays(
        scene.camera, cs["image_x"] + 1.0, cs["image_y"], cs["lens_u"],
        cs["lens_v"], cs["time"], xres, yres)
    o_ry, d_ry, *_ = cam_mod.generate_rays(
        scene.camera, cs["image_x"], cs["image_y"] + 1.0, cs["lens_u"],
        cs["lens_v"], cs["time"], xres, yres)
    return dict(px=px, py=py, s_idx=s_idx, ix=cs["image_x"],
                iy=cs["image_y"], o=o, d=d, mint=mint, maxt=maxt,
                rx_o=o_rx, rx_d=d_rx, ry_o=o_ry, ry_d=d_ry)


def _direct_ld(scene, cfg, strategy, p, ns, wo, bsdf, ph, px, py, s_idx,
               bounce, seed, alive):
    """Direct lighting for directlighting mode — streams replicate
    integrators/directlighting.py exactly (depth == bounce)."""
    from ..core import mc, spectrum as spec
    n_rays = p.shape[0]
    ls1, ls2 = smp.integrator_2d(cfg, px, py, s_idx, bounce, 11, seed)
    bs1, bs2 = smp.integrator_2d(cfg, px, py, s_idx, bounce, 12, seed)
    bcs = smp.integrator_1d(cfg, px, py, s_idx, bounce, 13, seed)
    ls3 = rng.uniform(ph, s_idx, bounce, 16)
    if strategy == "all":
        kl = scene.lights.kinds_list
        specs = []
        for i in range(scene.lights.count):
            lid = jnp.full((n_rays,), i, jnp.int32)
            l1, l2 = smp.integrator_2d(cfg, px, py, s_idx, bounce,
                                       100 + 4 * i, seed)
            b1, b2 = smp.integrator_2d(cfg, px, py, s_idx, bounce,
                                       101 + 4 * i, seed)
            bc = smp.integrator_1d(cfg, px, py, s_idx, bounce,
                                   102 + 4 * i, seed)
            specs.append(dict(light_id=lid, ls1=l1, ls2=l2, ls3=ls3,
                              bs1=b1, bs2=b2, bcs=bc,
                              static_kind=kl[i] if kl else None))
        return common.estimate_direct_multi(scene, specs, p, ns, wo, bsdf,
                                            alive)
    if strategy == "weighted":
        pw = spec.luminance(lt.power(scene))
        sel_func, sel_cdf, sel_int = mc.distribution1d_build(pw)
        u_num = smp.integrator_1d(cfg, px, py, s_idx, bounce, 10, seed)
        lid, pmf = mc.distribution1d_sample_discrete(
            sel_func, sel_cdf, sel_int, u_num)
        return common.estimate_direct(
            scene, lid, p, ns, wo, bsdf, ls1, ls2, ls3, bs1, bs2, bcs,
            alive) / jnp.maximum(pmf, 1e-12)[..., None]
    # "one"
    u_num = smp.integrator_1d(cfg, px, py, s_idx, bounce, 10, seed)
    return common.uniform_sample_one_light(
        scene, p, ns, wo, bsdf, u_num, ls1, ls2, ls3, bs1, bs2, bcs, alive)


def _whitted_ld(scene, p, ns, wo, bsdf, ph, s_idx, bounce, alive):
    """Whitted direct lighting: every light, single sample, NO MIS
    (whitted.cpp:74-81); streams replicate integrators/whitted.py. All
    lights' shadow rays share one any-hit traversal launch."""
    n_rays = p.shape[0]
    samples = []
    segs = []
    for i in range(scene.lights.count):
        lid = jnp.full((n_rays,), i, jnp.int32)
        ls1 = rng.uniform(ph, s_idx, bounce, i, 1)
        ls2 = rng.uniform(ph, s_idx, bounce, i, 2)
        ls3 = rng.uniform(ph, s_idx, bounce, i, 3)
        sm = lt.sample(scene, lid, p, ns, ls1, ls2, ls3)
        f_val = B.f(bsdf, wo, sm["wi"])
        ok = alive & (sm["pdf"] > 0.0) & ~jnp.all(sm["Li"] == 0.0, axis=-1)
        need = ok & ~jnp.all(f_val == 0.0, axis=-1)
        samples.append((sm, f_val, need))
        # Degenerate rays for provably-zero lanes (see
        # common.estimate_direct_multi): empty windows retire dead lanes
        # at their first node.
        segs.append((p, sm["wi"],
                     jnp.where(need, _EPS, 1.0),
                     jnp.where(need, sm["vis_maxt"], -1.0)))
    if not segs:
        return jnp.zeros_like(p)
    vis = common.batched_visibility(scene, segs, ["any"] * len(segs))
    Ld = jnp.zeros_like(p)
    for (sm, f_val, need), occ in zip(samples, vis):
        contrib = f_val * sm["Li"] * \
            (vm.absdot(sm["wi"], ns) /
             jnp.maximum(sm["pdf"], 1e-20))[..., None]
        Ld = Ld + jnp.where((need & ~occ)[..., None], contrib, 0.0)
    return Ld


def _step(scene: SceneData, film, st, cursor, cfg, seed, max_depth,
          rr_start, total, xres, yres, xstart, xcount, ystart, spp,
          filter_kind, filter_xwidth, filter_ywidth,
          vol_integrator="emission", mode="path", strategy="all",
          aux=None, prm=None):
    """One wavefront pass: bounce every live lane once, splat + regenerate
    finished lanes. Returns (film, state, cursor, n_alive, n_active).

    mode selects the integrator semantics (all share the regenerating-pool
    drive; VERDICT r3 item 2):
      "path"            path.cpp:58-145 (MIS one-light NEE, RR, full BSDF
                        continuation) — the original wavefront.
      "directlighting"  directlighting.cpp (strategy all/one/weighted,
                        specular-only continuation, no RR).
      "whitted"         whitted.cpp:44-140 (all lights, single sample, no
                        MIS, specular-only continuation with propagated
                        ray differentials).
      "photonmap"       photonmap.cpp:299-431 (direct + map estimates +
                        flat final gather via photonmap.photon_radiance;
                        aux = PhotonMaps, prm = PhotonParams). The pool
                        drive matters most here: the scan driver paid
                        the photon-map sweeps at FULL width for every
                        depth while only specular continuations remain
                        alive past depth 0.
    Random streams replicate the matching scan integrator exactly, so
    wavefront == scan holds per sample for every mode.
    """
    alive = st["alive"]
    px, py, s_idx, bounce = st["px"], st["py"], st["s_idx"], st["bounce"]
    ro, rd = st["o"], st["d"]
    throughput, L = st["throughput"], st["L"]
    specular, alpha = st["specular"], st["alpha"]
    first = bounce == 0
    salt = {"path": 0xBA5E, "directlighting": 0xD112,
            "whitted": 0x817, "photonmap": 0x9B1}[mode]
    ph = rng.hash_u32(px, py, seed, salt)
    has_inf = bool(scene.lights.infinite_meta)
    has_lights = scene.lights.count > 0
    has_vols = scene.volumes is not None and scene.volumes.count > 0
    n_active = jnp.sum(alive.astype(jnp.float32))

    t, pid, hit = isect.intersect_ids(scene, ro, rd, st["mint"], st["maxt"])

    if has_vols:
        # Volume composition matching the scan driver + Scene::Li exactly
        # (same streams, so wavefront == scan holds on volume scenes):
        # bounce-0 segments realize the driver's L = T*Lo + Lv
        # (core/scene.cpp:120-126; T multiplies throughput BEFORE any
        # radiance is accumulated, Lv adds un-attenuated once); in path
        # mode bounce>0 segments also get path.cpp:89's per-segment
        # transmittance (the scan dl/whitted drivers attenuate only the
        # camera segment, so those modes match that).
        from ..volumes import regions as vr
        from . import volume as vol_integ
        ph_cam = rng.hash_u32(px, py, seed, 0xF0)
        seg_end = jnp.where(hit, t, st["maxt"])
        u_cam = rng.uniform(ph_cam, s_idx, 0x7A)
        if mode == "path":
            u_seg = rng.uniform(ph, s_idx, bounce, 0x77)
            tr = vr.transmittance(scene.volumes, ro, rd, st["mint"],
                                  seg_end, jnp.where(first, u_cam, u_seg))
            throughput = jnp.where(alive[..., None], throughput * tr,
                                   throughput)
        else:
            tr = vr.transmittance(scene.volumes, ro, rd, st["mint"],
                                  seg_end, u_cam)
            throughput = jnp.where((first & alive)[..., None],
                                   throughput * tr, throughput)
        if vol_integrator == "single":
            Lv = vol_integ.li_single(scene, ro, rd, st["mint"], seg_end,
                                     ph_cam, s_idx, seed)
        else:
            Lv = vol_integ.li_emission(scene, ro, rd, st["mint"], seg_end,
                                       u_cam)
        L = L + jnp.where((first & alive)[..., None], Lv, 0.0)

    if has_inf:
        if mode == "path":
            take_le = ~hit & alive & (first | specular)
        else:
            # dl/whitted scan drivers add escape Le on every miss of a live
            # lane (their continuations are specular-only, so this is the
            # same set — but keep the literal condition for parity).
            take_le = ~hit & alive
        Lesc = lt.le_escaped(scene, rd)
        L = L + jnp.where(take_le[..., None], throughput * Lesc, 0.0)
        alpha = jnp.where(take_le & first & jnp.any(Lesc > 0, -1), 1.0,
                          alpha)
    alive = alive & hit
    alpha = jnp.where(first & hit, 1.0, alpha)
    # Vertices shaded this pass == NEE shadow rays traced (the reference's
    # "Number of shadow rays traced" counter, light.cpp VisibilityTester).
    n_shadow = jnp.sum(alive.astype(jnp.float32))

    dg = isect.hit_geometry(scene, pid, ro, rd, t)
    diff_ok = alive if mode == "whitted" else (first & alive)
    dg = isect.compute_differentials(dg, st["rx_o"], st["rx_d"],
                                     st["ry_o"], st["ry_d"], diff_ok)

    if has_lights:
        emit_ok = alive & (first | specular) if mode == "path" else alive
        Le = lt.area_emission(scene, dg["area_light"], dg["nn"], -rd)
        L = L + jnp.where(emit_ok[..., None], throughput * Le, 0.0)

    bsdf = common.make_bsdf_at(scene, dg)
    p, ns = dg["p"], bsdf.nn
    wo = -rd

    if has_lights:
        if mode == "path":
            u_num = smp.integrator_1d(cfg, px, py, s_idx, bounce, 10, seed)
            ls1, ls2 = smp.integrator_2d(cfg, px, py, s_idx, bounce, 11,
                                         seed)
            bs1, bs2 = smp.integrator_2d(cfg, px, py, s_idx, bounce, 12,
                                         seed)
            bcs = smp.integrator_1d(cfg, px, py, s_idx, bounce, 13, seed)
            ls3 = rng.uniform(ph, s_idx, bounce, 16)
            Ld = common.uniform_sample_one_light(
                scene, p, ns, wo, bsdf, u_num, ls1, ls2, ls3, bs1, bs2,
                bcs, alive)
        elif mode == "directlighting":
            Ld = _direct_ld(scene, cfg, strategy, p, ns, wo, bsdf, ph,
                            px, py, s_idx, bounce, seed, alive)
        elif mode == "photonmap":
            from . import photonmap as _pm
            Ld = _pm.photon_radiance(scene, aux, prm, bsdf, wo, p, ns,
                                     alive, ph, s_idx, bounce)
        else:  # whitted: every light, single sample, NO MIS
            Ld = _whitted_ld(scene, p, ns, wo, bsdf, ph, s_idx, bounce,
                             alive)
        L = L + jnp.where(alive[..., None], throughput * Ld, 0.0)

    if mode == "path":
        c1, c2 = smp.integrator_2d(cfg, px, py, s_idx, bounce, 20, seed)
        c3 = smp.integrator_1d(cfg, px, py, s_idx, bounce, 21, seed)
        bs = B.sample_f(bsdf, wo, c1, c2, c3, B.ALL)
    else:
        c1 = rng.uniform(ph, s_idx, bounce, 0x5A, 1)
        c2 = rng.uniform(ph, s_idx, bounce, 0x5A, 2)
        c3 = rng.uniform(ph, s_idx, bounce, 0x5A, 3)
        bs = B.sample_f(bsdf, wo, c1, c2, c3,
                        B.SPECULAR | B.REFLECTION | B.TRANSMISSION)
    cont = alive & bs["valid"] & (bs["pdf"] > 0.0) & \
        ~jnp.all(bs["f"] == 0.0, axis=-1) & (bounce < max_depth)
    scale = bs["f"] * (vm.absdot(bs["wi"], ns) /
                       jnp.maximum(bs["pdf"], 1e-20))[..., None]
    throughput = jnp.where(cont[..., None], throughput * scale, throughput)
    specular = jnp.where(cont, bs["specular"], specular)

    # Whitted propagates specular ray differentials across bounces
    # (whitted.cpp:88-136) so EWA filtering keeps a footprint through
    # mirrors/glass; path/dl only use the camera pair at the first hit.
    rx_o, rx_d = st["rx_o"], st["rx_d"]
    ry_o, ry_d = st["ry_o"], st["ry_d"]
    if mode == "whitted":
        is_trans = jnp.bitwise_and(bs["flags"], B.TRANSMISSION) > 0
        nrxo, nrxd, nryo, nryd = common.specular_ray_differentials(
            dg, ns, wo, bs["wi"], rx_d, ry_d, bs["eta"], is_trans)
        m = cont[..., None]
        rx_o = jnp.where(m, nrxo, rx_o)
        rx_d = jnp.where(m, nrxd, rx_d)
        ry_o = jnp.where(m, nryo, ry_o)
        ry_d = jnp.where(m, nryd, ry_d)
    alive = cont

    if mode == "path":
        u_rr = rng.uniform(ph, s_idx, bounce, 30)
        do_rr = bounce >= rr_start
        survive = ~do_rr | (u_rr < 0.5)
        alive = alive & survive
        throughput = jnp.where((alive & do_rr)[..., None],
                               throughput / 0.5, throughput)

    ro = p
    rd = bs["wi"]
    bounce = bounce + 1

    # --- finish & splat -------------------------------------------------
    finished = st["alive"] & ~alive
    bad = jnp.any(~jnp.isfinite(L) | (L < 0.0), axis=-1)
    Ls = jnp.where((finished & ~bad)[..., None], L, 0.0)
    ix = jnp.where(finished, st["ix"], -1e6)
    iy = jnp.where(finished, st["iy"], -1e6)
    film = film_mod.add_samples(film, ix, iy, Ls,
                                jnp.where(finished, alpha, 0.0),
                                filter_kind, filter_xwidth, filter_ywidth)

    # --- regenerate ------------------------------------------------------
    dead = ~alive
    slot = _rank_among_true(dead)                      # rank among dead
    # uint32 sample ids: see _regen (int32 overflows at 2^31 samples).
    new_lin = cursor.astype(jnp.uint32) + slot.astype(jnp.uint32)
    regen = dead & (new_lin < jnp.uint32(total))
    fresh = _regen(scene, cfg, jnp.where(regen, new_lin, 0), seed, xres,
                   yres, xstart, xcount, ystart, spp)
    n_regen = jnp.sum(regen.astype(jnp.uint32))

    def sel(new, old):
        m = regen
        while m.ndim < new.ndim:
            m = m[..., None]
        return jnp.where(m, new, old)

    st_out = dict(
        alive=alive | regen,
        px=sel(fresh["px"], px), py=sel(fresh["py"], py),
        s_idx=sel(fresh["s_idx"], s_idx),
        bounce=jnp.where(regen, 0, bounce),
        ix=sel(fresh["ix"], st["ix"]), iy=sel(fresh["iy"], st["iy"]),
        o=sel(fresh["o"], ro), d=sel(fresh["d"], rd),
        mint=sel(fresh["mint"], jnp.full_like(st["mint"], _EPS)),
        maxt=sel(fresh["maxt"], jnp.full_like(st["maxt"], 1e30)),
        rx_o=sel(fresh["rx_o"], rx_o),
        rx_d=sel(fresh["rx_d"], rx_d),
        ry_o=sel(fresh["ry_o"], ry_o),
        ry_d=sel(fresh["ry_d"], ry_d),
        throughput=sel(jnp.ones_like(throughput), throughput),
        L=sel(jnp.zeros_like(L), L),
        alpha=jnp.where(regen, 0.0, alpha),
        specular=jnp.where(regen, False, specular),
    )
    cursor = cursor.astype(jnp.uint32) + n_regen
    n_alive = jnp.sum(st_out["alive"].astype(jnp.int32))
    return film, st_out, cursor, n_alive, n_active, n_shadow


# Passes per jit dispatch of the progress-reporting drive: each host
# round-trip (reading n_alive) costs a full device sync; lax.scan
# amortizes it.
INNER = 8


# Module-level jits (NOT closures rebuilt per render call): re-tracing the
# INNER-pass scan body costs seconds of host time per call, which previously
# doubled the wall time of a warm benchmark render.
@partial(jax.jit, donate_argnums=(1, 2, 3),
         static_argnames=("cfg", "seed", "max_depth", "total", "xres",
                          "yres", "xstart", "xcount", "ystart", "spp",
                          "filter_kind", "filter_xwidth", "filter_ywidth",
                          "vol_integrator", "mode", "strategy", "prm"))
def _jstep(scene, film, st, cursor, aux=None, *, cfg, seed, max_depth,
           total, xres, yres, xstart, xcount, ystart, spp, filter_kind,
           filter_xwidth, filter_ywidth, vol_integrator="emission",
           mode="path", strategy="all", prm=None):
    def body(carry, _):
        film_c, st_c, cur_c = carry
        film_c, st_c, cur_c, n_alive, n_active, n_shadow = _step(
            scene, film_c, st_c, cur_c, cfg, seed, max_depth, 3, total,
            xres, yres, xstart, xcount, ystart, spp, filter_kind,
            filter_xwidth, filter_ywidth, vol_integrator, mode, strategy,
            aux, prm)
        return (film_c, st_c, cur_c), (n_alive, n_active, n_shadow)
    (film, st, cursor), (n_alive, n_active, n_shadow) = jax.lax.scan(
        body, (film, st, cursor), None, length=INNER)
    return (film, st, cursor, n_alive[-1], jnp.sum(n_active),
            jnp.sum(n_shadow), jnp.sum((n_active > 0).astype(jnp.int32)))


@partial(jax.jit, donate_argnums=(1, 2, 3),
         static_argnames=("cfg", "seed", "max_depth", "total", "xres",
                          "yres", "xstart", "xcount", "ystart", "spp",
                          "filter_kind", "filter_xwidth", "filter_ywidth",
                          "pass_limit", "vol_integrator", "mode",
                          "strategy", "prm"))
def _jrun(scene, film, st, cursor, aux=None, *, cfg, seed, max_depth,
          total, xres, yres, xstart, xcount, ystart, spp, filter_kind,
          filter_xwidth, filter_ywidth, pass_limit,
          vol_integrator="emission", mode="path", strategy="all",
          prm=None):
    """The entire wavefront drive as ONE device-side while_loop dispatch.

    The host-chunked driver costs a device->host scalar read per INNER
    passes to learn n_alive. Here the termination test runs on device
    and the host reads back only the final (film, stats). pass_limit bounds
    the loop against bugs (it is loose: every sample terminates within
    max_depth+1 passes of its regeneration).
    """
    # Counters as (millions, units) f32 pairs: a single f32 accumulator
    # loses increments past 2^24 (~16.7M segments — any moderately large
    # render; ADVICE r3). Per-pass increments are < 2^21 (lane count), so
    # the units column stays exact; the carry keeps totals exact to 2^44.
    stats0 = jnp.zeros((3, 2), jnp.float32)

    def cond(c):
        _film, st_c, _cur, _stats, npass = c
        return jnp.any(st_c["alive"]) & (npass < pass_limit)

    def body(c):
        film_c, st_c, cur_c, stats_c, npass = c
        film_c, st_c, cur_c, _n_alive, n_active, n_shadow = _step(
            scene, film_c, st_c, cur_c, cfg, seed, max_depth, 3, total,
            xres, yres, xstart, xcount, ystart, spp, filter_kind,
            filter_xwidth, filter_ywidth, vol_integrator, mode, strategy,
            aux, prm)
        units = stats_c[:, 1] + jnp.stack(
            [n_active, n_shadow, (n_active > 0).astype(n_active.dtype)])
        carry = jnp.floor(units / 1e6)
        stats_c = jnp.stack([stats_c[:, 0] + carry, units - carry * 1e6],
                            axis=1)
        return (film_c, st_c, cur_c, stats_c, npass + 1)

    film, st, cursor, stats, npass = jax.lax.while_loop(
        cond, body, (film, st, cursor, stats0, jnp.int32(0)))
    return film, stats, npass


@partial(jax.jit, static_argnames=("cfg", "seed", "n_lanes", "total",
                                   "xres", "yres", "xstart", "xcount",
                                   "ystart", "spp"))
def _jinit(scene, *, cfg, seed, n_lanes, total, xres, yres, xstart, xcount,
           ystart, spp):
    """Initial fill: lanes 0..n_lanes-1 take the first sample ids. Jitted:
    un-jitted this is ~50 individually-dispatched device ops."""
    lin0 = jnp.arange(n_lanes, dtype=jnp.uint32)
    valid0 = lin0 < total
    fresh = _regen(scene, cfg, jnp.minimum(lin0, total - 1), seed,
                   xres, yres, xstart, xcount, ystart, spp)
    z3 = jnp.zeros((n_lanes, 3), jnp.float32)
    return dict(alive=valid0, bounce=jnp.zeros(n_lanes, jnp.int32),
                px=fresh["px"], py=fresh["py"], s_idx=fresh["s_idx"],
                ix=fresh["ix"], iy=fresh["iy"],
                o=fresh["o"], d=fresh["d"], mint=fresh["mint"],
                maxt=fresh["maxt"], rx_o=fresh["rx_o"],
                rx_d=fresh["rx_d"], ry_o=fresh["ry_o"],
                ry_d=fresh["ry_d"], throughput=z3 + 1.0, L=z3,
                alpha=jnp.zeros(n_lanes, jnp.float32),
                specular=jnp.zeros(n_lanes, bool))


_develop = jax.jit(film_mod.develop)


def render(scene: SceneData, opts, progress: bool = False, stats=None,
           aux=None):
    """Full-frame wavefront render (path, directlighting, whitted, or
    photonmap per opts.integrator; photonmap needs aux=PhotonMaps from
    photonmap.build_maps). Returns (rgb, alpha) like render.render."""
    if opts.integrator not in ("path", "directlighting", "whitted",
                               "photonmap"):
        raise ValueError(
            f"wavefront driver supports path/directlighting/whitted/"
            f"photonmap, not {opts.integrator}")
    film = film_mod.make_film(opts.xres, opts.yres, opts.crop)
    xstart, xcount, ystart, ycount = film_mod.pixel_extent(film)
    spp = smp.samples_per_pixel(opts.sampler)
    total = xcount * ycount * spp
    if total >= 2 ** 32:
        raise ValueError(
            f"sample space {total} exceeds the uint32 cursor; split the "
            "render with crop windows (film/image.cpp:79-85 semantics)")
    n_lanes = int(min(opts.chunk_size, total))
    prm = None
    if opts.integrator == "photonmap":
        from . import photonmap as _pm
        prm = opts.photon if opts.photon else _pm.PhotonParams()
        if aux is None:
            aux = _pm.build_maps(scene, prm, opts.seed)
        if prm.final_gather:
            # Widened flat gather: lanes x gather_samples <= 2^15 under
            # the pool. The cap was inherited from an earlier build, where
            # larger products faulted; it is not yet measured on the H100
            # (ROADMAP A4).
            n_lanes = min(n_lanes,
                          max(1 << 11,
                              (1 << 15) // max(prm.gather_samples, 1)))
    cfg = opts.sampler

    step_kw = dict(cfg=cfg, seed=opts.seed, max_depth=opts.max_depth,
                   total=total, xres=opts.xres, yres=opts.yres,
                   xstart=xstart, xcount=xcount, ystart=ystart, spp=spp,
                   filter_kind=opts.filter_kind,
                   filter_xwidth=opts.filter_xwidth,
                   filter_ywidth=opts.filter_ywidth,
                   vol_integrator=opts.volume_integrator,
                   mode=opts.integrator,
                   strategy=getattr(opts, "direct_strategy", "all"),
                   prm=prm)

    def jstep(film, st, cursor):
        return _jstep(scene, film, st, cursor, aux, **step_kw)

    st = _jinit(scene, cfg=cfg, seed=opts.seed, n_lanes=n_lanes,
                total=total, xres=opts.xres, yres=opts.yres, xstart=xstart,
                xcount=xcount, ystart=ystart, spp=spp)
    cursor = jnp.asarray(n_lanes if total >= n_lanes else total,
                         jnp.uint32)

    if not progress:
        # Whole render in one dispatch; host reads back only final stats.
        pass_limit = math.ceil(total * (opts.max_depth + 2) / n_lanes) + \
            opts.max_depth + 8
        film, dev_stats, _npass = _jrun(scene, film, st, cursor, aux,
                                        pass_limit=pass_limit, **step_kw)
        dev_stats = np.asarray(dev_stats, np.float64)
        totals = dev_stats[:, 0] * 1e6 + dev_stats[:, 1]
        segments, shadow, passes = (float(totals[0]), float(totals[1]),
                                    int(totals[2]))
    else:
        from ..utils.progress import ProgressReporter
        rep = ProgressReporter(total, "Rendering")
        segments = 0.0
        shadow = 0.0
        passes = 0
        done = 0
        while True:
            (film, st, cursor, n_alive, n_active, n_shadow,
             n_busy) = jstep(film, st, cursor)
            passes += int(n_busy)   # non-empty passes only (tail may idle)
            segments += float(n_active)
            shadow += float(n_shadow)
            n_alive = int(n_alive)
            newly = int(cursor) - done if int(cursor) > done else 0
            done = int(cursor)
            if newly:
                rep.update(newly)
            if n_alive == 0:
                break
        rep.done()

    if stats is not None:
        stats.add("Wavefront", "Passes", passes)
        stats.add("Wavefront", "Path segments traced", segments)
        stats.add("Wavefront", "Shadow rays traced", shadow)
        stats.add_ratio("Wavefront", "Lane occupancy",
                        segments, float(passes) * n_lanes)
        stats.add("Camera", "Samples taken", total)

    rgb, alpha = _develop(film)
    if getattr(opts, "half_readback", False):
        rgb, alpha = film_mod.to_half(rgb, alpha)
        return (np.asarray(rgb).astype(np.float32),
                np.asarray(alpha).astype(np.float32))
    return np.asarray(rgb), np.asarray(alpha)

"""Shared direct-lighting estimators for wavefront integrators.

The counterpart of /root/reference/core/transport.cpp:31-194:
UniformSampleAllLights / UniformSampleOneLight / EstimateDirect. The
two-strategy MIS (light sampling with visibility + BSDF sampling with
area/env identification, power heuristic) is preserved exactly; control flow
becomes masked lanes.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..accel import intersect as isect
from ..bsdf import bsdf as B
from ..core import mc, vecmath as vm
from ..lights import lights as lt
from ..materials import factory as _factory
from ..textures import graph as _tex
from ..scene.data import AREA_GEOM_TRIS, LIGHT_AREA, LIGHT_INFINITE, SceneData

_EPS = vm.RAY_EPSILON


def shading_dg_for_hit(scene: SceneData, prim_id, o, d, t):
    dg = isect.hit_geometry(scene, prim_id, o, d, t)
    return dg


def make_bsdf_at(scene: SceneData, dg, active=None):
    """Evaluate textures + assemble lobes at hit points (GetBSDF chain,
    core/primitive.cpp:126-133 -> materials/*.cpp), bump-mapping the shading
    frame first when any material carries a displacement texture."""
    tex_vals = _tex.eval_graph(scene.textures, scene.images, dg)
    if scene.materials.has_bump:
        dg = _bump(scene, dg, tex_vals)
    lobes = _factory.make_lobes(scene.materials, dg["material"], tex_vals)
    nn, sn, tn, ng = B.make_frame(dg["sn"], dg["dpdu"], dg["nn"])
    return B.BsdfBatch(nn=nn, sn=sn, tn=tn, ng=ng, lobes=lobes)


def _bump(scene: SceneData, dg, tex_vals):
    """Material::Bump (core/material.cpp:29-71): evaluate the displacement
    texture at u/v-shifted points, perturb dpdu/dpdv, recompute the shading
    normal. Lanes whose material has no bump texture pass through."""
    bid = scene.materials.bump[dg["material"]]           # i32[B], -1 = none
    n_nodes = tex_vals.shape[0]
    lanes = jnp.arange(dg["u"].shape[0])
    safe = jnp.clip(bid, 0, max(n_nodes - 1, 0))

    def disp_of(tv):
        return tv[safe, lanes, 0]

    zero = jnp.zeros_like(dg["u"])
    du = 0.5 * (jnp.abs(dg.get("dudx", zero)) + jnp.abs(dg.get("dudy", zero)))
    du = jnp.where(du == 0.0, 0.01, du)
    dv = 0.5 * (jnp.abs(dg.get("dvdx", zero)) + jnp.abs(dg.get("dvdy", zero)))
    dv = jnp.where(dv == 0.0, 0.01, dv)

    dg_u = dict(dg)
    dg_u["p"] = dg["p"] + du[..., None] * dg["dpdu"]
    dg_u["u"] = dg["u"] + du
    dg_v = dict(dg)
    dg_v["p"] = dg["p"] + dv[..., None] * dg["dpdv"]
    dg_v["v"] = dg["v"] + dv
    u_disp = disp_of(_tex.eval_graph(scene.textures, scene.images, dg_u))
    v_disp = disp_of(_tex.eval_graph(scene.textures, scene.images, dg_v))
    disp = disp_of(tex_vals)

    dpdu_b = dg["dpdu"] + ((u_disp - disp) / du)[..., None] * dg["sn"] + \
        disp[..., None] * dg["dndu"]
    dpdv_b = dg["dpdv"] + ((v_disp - disp) / dv)[..., None] * dg["sn"] + \
        disp[..., None] * dg["dndv"]
    nb = vm.normalize(vm.cross(dpdu_b, dpdv_b))
    # Orient to match the geometric normal (material.cpp:63-70; the
    # handedness flip is already baked into dg["nn"] at hit_geometry).
    nb = jnp.where((vm.dot(dg["nn"], nb) < 0.0)[..., None], -nb, nb)

    has = (bid >= 0)[..., None]
    out = dict(dg)
    out["sn"] = jnp.where(has, nb, dg["sn"])
    out["dpdu"] = jnp.where(has, dpdu_b, dg["dpdu"])
    out["dpdv"] = jnp.where(has, dpdv_b, dg["dpdv"])
    return out


def specular_ray_differentials(dg, ns, wo, wi, rx_d, ry_d, eta, is_trans):
    """Ray differentials of a specular reflected/transmitted ray
    (/root/reference/integrators/whitted.cpp:88-136): given the incoming
    aux-ray directions rx_d/ry_d and the first-order surface derivatives in
    dg (dpdx/dpdy, dndu/dndv, dudx..dvdy), return the continuation ray's
    (rx_o, rx_d, ry_o, ry_d). eta: BSDF eta (etat/etai); is_trans selects
    the refraction formula per lane.
    """
    p = dg["p"]
    rx_o = p + dg["dpdx"]
    ry_o = p + dg["dpdy"]
    dndx = dg["dndu"] * dg["dudx"][..., None] + \
        dg["dndv"] * dg["dvdx"][..., None]
    dndy = dg["dndu"] * dg["dudy"][..., None] + \
        dg["dndv"] * dg["dvdy"][..., None]
    dwodx = -rx_d - wo
    dwody = -ry_d - wo
    dDNdx = vm.dot(dwodx, ns) + vm.dot(wo, dndx)
    dDNdy = vm.dot(dwody, ns) + vm.dot(wo, dndy)
    wodn = vm.dot(wo, ns)

    refl_rx = wi - dwodx + 2.0 * (wodn[..., None] * dndx +
                                  dDNdx[..., None] * ns)
    refl_ry = wi - dwody + 2.0 * (wodn[..., None] * dndy +
                                  dDNdy[..., None] * ns)

    w = -wo
    # Deliberate divergence from whitted.cpp:117-120, which selects
    # eta=bsdf.eta when ENTERING the medium: the first-order refraction
    # derivative needs the Snell direction ratio etai/etat (= 1/eta
    # entering, eta exiting). The v1 selection is inverted — a known v1
    # erratum, fixed in later pbrt editions; our FD test exposes it as an
    # exact -eta^2 scale error.
    eta_r = jnp.where(wodn > 0.0, 1.0 / jnp.maximum(eta, 1e-6), eta)
    widn = vm.dot(wi, ns)
    widn_safe = jnp.where(jnp.abs(widn) < 1e-6,
                          jnp.where(widn < 0, -1e-6, 1e-6), widn)
    wdn = vm.dot(w, ns)
    mu = eta_r * wdn - widn
    dmu_fac = eta_r - (eta_r * eta_r * wdn) / widn_safe
    dmudx = dmu_fac * dDNdx
    dmudy = dmu_fac * dDNdy
    # Second deliberate sign fix vs whitted.cpp:134-135 (same erratum
    # family): wi = eta*w - mu*n with w = -wo gives
    # dwi = -eta*dwodx + (dmu*n + mu*dndx); validated against exact Snell
    # refraction by finite differences in test_differentials.
    trans_rx = wi - eta_r[..., None] * dwodx + \
        (mu[..., None] * dndx + dmudx[..., None] * ns)
    trans_ry = wi - eta_r[..., None] * dwody + \
        (mu[..., None] * dndy + dmudy[..., None] * ns)

    m = is_trans[..., None]
    return (rx_o, jnp.where(m, trans_rx, refl_rx),
            ry_o, jnp.where(m, trans_ry, refl_ry))


# Light kinds whose Sample_L is a delta distribution (IsDeltaLight,
# /root/reference/core/light.h:60-65): BSDF-strategy MIS is skipped.
from ..scene.data import (LIGHT_POINT, LIGHT_SPOT, LIGHT_DISTANT,
                          LIGHT_PROJECTION, LIGHT_GONIOMETRIC)
DELTA_KINDS = (LIGHT_POINT, LIGHT_SPOT, LIGHT_DISTANT, LIGHT_PROJECTION,
               LIGHT_GONIOMETRIC)


def batched_visibility(scene: SceneData, segs, needs):
    """Resolve a list of ray segments, batching them into ONE traversal
    launch on accelerated scenes (VERDICT r3 item 7: EstimateDirect used
    to launch up to 3 traversals per bounce; batching the NEE shadow rays
    and MIS BSDF-strategy rays of every light amortizes the per-launch
    fixed cost and gives the traversal one bigger ray set).

    segs:  list of (o f32[N,3], d f32[N,3], mint f32[N], maxt f32[N]).
    needs: list of "any" | "nearest" per segment.
    Returns per-segment results: (t, pid, hit) for "nearest" segments,
    occluded booleans for "any" segments.

    Small scenes with no accelerator run per-segment launches at each
    segment's own mode instead: their unrolled brute-force tester makes
    any-hit genuinely cheaper than nearest, and launches cost nothing.
    """
    fuse = scene.accel is not None and len(segs) > 1
    if not fuse:
        out = []
        for s, nd in zip(segs, needs):
            if nd == "nearest":
                out.append(isect.intersect_ids(scene, *s))
            else:
                out.append(isect.occluded(scene, *s))
        return out
    O = jnp.concatenate([s[0] for s in segs], axis=0)
    D = jnp.concatenate([s[1] for s in segs], axis=0)
    MINT = jnp.concatenate([s[2] for s in segs], axis=0)
    MAXT = jnp.concatenate([s[3] for s in segs], axis=0)
    out = []
    ofs = 0
    if any(nd == "nearest" for nd in needs):
        t, pid, hit = isect.intersect_ids(scene, O, D, MINT, MAXT)
        for s, nd in zip(segs, needs):
            nn = s[0].shape[0]
            if nd == "nearest":
                out.append((t[ofs:ofs + nn], pid[ofs:ofs + nn],
                            hit[ofs:ofs + nn]))
            else:
                out.append(hit[ofs:ofs + nn])
            ofs += nn
    else:
        occ = isect.occluded(scene, O, D, MINT, MAXT)
        for s in segs:
            nn = s[0].shape[0]
            out.append(occ[ofs:ofs + nn])
            ofs += nn
    return out


def estimate_direct_multi(scene: SceneData, specs, p, n, wo,
                          bsdf: B.BsdfBatch, active):
    """Sum of EstimateDirect (core/transport.cpp:123-194) over several
    lights with every visibility + BSDF-strategy ray batched into ONE
    traversal launch.

    specs: list of dicts with keys
      light_id i32[N], ls1, ls2, ls3, bs1, bs2, bcs (sampler streams),
      static_kind: int LIGHT_* when the light's kind is known at trace time
        (per-light unrolled callers), else None,
      weight: optional scalar/array factor on this light's contribution.
    """
    lights = scene.lights
    from ..scene.data import LIGHT_AREA as _LA
    has_area = _LA in (scene.lights.kinds_present or (_LA,))
    has_vols = scene.volumes is not None and scene.volumes.count > 0

    # ---- Phase 1: sample lights + BSDF, emit ray segments ---------------
    segs = []          # ray segments, in order
    needs = []         # per segment: "any" | "nearest"
    plan = []          # per spec: dict of intermediates + segment indices
    for sp in specs:
        light_id = sp["light_id"]
        sk = sp.get("static_kind")
        smp = lt.sample(scene, light_id, p, n, sp["ls1"], sp["ls2"],
                        sp["ls3"])
        f_val = B.f(bsdf, wo, smp["wi"])
        # Lanes with a provably-zero contribution (inactive, zero pdf,
        # black Li, or black BSDF toward the light) get DEGENERATE rays
        # (mint 1 > maxt -1, empty slab window): the walk retires them at
        # their first node instead of walking a full path for nothing.
        usable = active & (smp["pdf"] > 0.0) & \
            ~jnp.all(smp["Li"] == 0.0, axis=-1)
        need_vis = usable & ~jnp.all(f_val == 0.0, axis=-1)
        rec = dict(sp=sp, smp=smp, f_val=f_val, need_vis=need_vis,
                   seg1=len(segs), seg2=-1)
        segs.append((p, smp["wi"],
                     jnp.where(need_vis, _EPS, 1.0),
                     jnp.where(need_vis, smp["vis_maxt"], -1.0)))
        needs.append("any")
        # Strategy 2 exists only for non-delta lights (transport.cpp:166):
        # a statically-delta light skips the BSDF sample AND its traversal.
        if sk is None or sk not in DELTA_KINDS:
            bs = B.sample_f(bsdf, wo, sp["bs1"], sp["bs2"], sp["bcs"],
                            B.ALL & ~B.SPECULAR)
            go = active & ~smp["delta"] & bs["valid"] & \
                (bs["pdf"] > 0.0) & ~jnp.all(bs["f"] == 0.0, axis=-1)
            rec["bs"] = bs
            rec["go"] = go
            rec["seg2"] = len(segs)
            segs.append((p, bs["wi"],
                         jnp.where(go, _EPS, 1.0),
                         jnp.where(go, 1e30, -1.0)))
            # Nearest-hit needed only when the strategy-2 ray must identify
            # an AREA light at its hit; statically-INFINITE lights only
            # need the escape predicate (transport.cpp:181-188).
            nearest2 = has_area and (sk is None or sk == LIGHT_AREA)
            needs.append("nearest" if nearest2 else "any")
        plan.append(rec)

    vis = batched_visibility(scene, segs, needs)

    # ---- Phase 2: resolve contributions ---------------------------------
    Ld = jnp.zeros(p.shape[:-1] + (3,), jnp.float32)
    for rec in plan:
        sp = rec["sp"]
        light_id = sp["light_id"]
        sk = sp.get("static_kind")
        smp = rec["smp"]
        kind = lights.kind[light_id] if sk is None else None
        wi = smp["wi"]
        light_pdf = smp["pdf"]
        Li = smp["Li"]
        f_val = rec["f_val"]
        need_vis = rec["need_vis"]
        occ = vis[rec["seg1"]]      # NEE segments always resolve as "any"
        unocc = need_vis & ~occ
        if has_vols:
            from ..volumes import regions as vr
            Li = Li * vr.transmittance(scene.volumes, p, wi,
                                       jnp.full(light_pdf.shape, _EPS),
                                       smp["vis_maxt"], sp["ls3"])
        bsdf_pdf = B.pdf(bsdf, wo, wi, B.ALL & ~B.SPECULAR)
        w_mis = jnp.where(smp["delta"], 1.0,
                          mc.power_heuristic(1.0, light_pdf, 1.0, bsdf_pdf))
        contrib = f_val * Li * (vm.absdot(wi, n) * w_mis /
                                jnp.maximum(light_pdf, 1e-20))[..., None]
        Ldi = jnp.where(unocc[..., None], contrib, 0.0)

        if rec["seg2"] >= 0:
            bs = rec["bs"]
            wi2 = bs["wi"]
            f2 = bs["f"]
            bpdf = bs["pdf"]
            go = rec["go"]
            lpdf2 = lt.pdf(scene, light_id, p, n, wi2)
            v2 = vis[rec["seg2"]]
            if needs[rec["seg2"]] == "nearest":
                t2, pid2, hit2 = v2
                dg2 = isect.hit_geometry_light(scene, pid2, p, wi2, t2)
                is_area = (kind == LIGHT_AREA) if sk is None \
                    else (sk == LIGHT_AREA)
                hit_is_light = hit2 & (dg2["area_light"] == light_id) & \
                    is_area
                Li2 = jnp.where(hit_is_light[..., None],
                                lt.area_emission(scene, dg2["area_light"],
                                                 dg2["nn"], -wi2),
                                0.0)
                # Escaped ray hitting THIS infinite light
                # (transport.cpp:181-188 uses light->Le(ray) per light —
                # summing all env lights would double count).
                is_inf = (kind == LIGHT_INFINITE) if sk is None \
                    else (sk == LIGHT_INFINITE)
                esc = ~hit2 & is_inf
                Li2 = jnp.where(esc[..., None],
                                lt.env_radiance(scene, light_id, wi2), Li2)
                # Area-light pdf from the actual hit: triangle sets and
                # uniform-area-sampled quadrics (disk/cylinder); spheres
                # keep the analytic cone pdf.
                use_hit_pdf = lights.area_geom_kind[light_id] == \
                    AREA_GEOM_TRIS
                if scene.quadrics.count > 0:
                    from ..scene.data import (AREA_GEOM_QUADRIC,
                                              QUADRIC_SPHERE)
                    qid = jnp.clip(lights.area_first[light_id], 0,
                                   scene.quadrics.count - 1)
                    use_hit_pdf = use_hit_pdf | (
                        (lights.area_geom_kind[light_id] ==
                         AREA_GEOM_QUADRIC) &
                        (scene.quadrics.kind[qid] != QUADRIC_SPHERE))
                # Missed lanes carry hit points at t = 1e30, whose squared
                # distance overflows; feed them a finite point so the
                # masked-out pdf keeps a finite gradient.
                hit_p = jnp.where(hit_is_light[..., None], dg2["p"],
                                  p + wi2)
                lpdf_hit = lt.pdf_area_from_hit(scene, light_id, p, wi2,
                                                hit_p, dg2["nn"])
                lpdf2 = jnp.where(hit_is_light & use_hit_pdf, lpdf_hit,
                                  lpdf2)
            else:
                # Any-hit resolution: Li2 can only be an INFINITE light's
                # escape radiance.
                occ2 = v2
                is_inf = (kind == LIGHT_INFINITE) if sk is None \
                    else (sk == LIGHT_INFINITE)
                esc = ~occ2 & is_inf
                Li2 = jnp.where(esc[..., None],
                                lt.env_radiance(scene, light_id, wi2), 0.0)
            ok2 = go & (lpdf2 > 0.0) & ~jnp.all(Li2 == 0.0, axis=-1)
            w2 = mc.power_heuristic(1.0, bpdf, 1.0, lpdf2)
            contrib2 = f2 * Li2 * (vm.absdot(wi2, n) * w2 /
                                   jnp.maximum(bpdf, 1e-20))[..., None]
            Ldi = Ldi + jnp.where(ok2[..., None], contrib2, 0.0)

        w = sp.get("weight")
        if w is not None:
            Ldi = Ldi * (w[..., None] if getattr(w, "ndim", 0) == 1 else w)
        Ld = Ld + Ldi
    return Ld


def estimate_direct(scene: SceneData, light_id, p, n, wo, bsdf: B.BsdfBatch,
                    ls1, ls2, ls3, bs1, bs2, bcs, active,
                    static_kind=None):
    """EstimateDirect (core/transport.cpp:123-194) for a wavefront.

    active: bool[N] — lanes that need the estimate (others return 0).
    Thin wrapper over estimate_direct_multi (single spec): the NEE shadow
    ray and the MIS BSDF-strategy ray share one traversal launch.
    """
    return estimate_direct_multi(
        scene,
        [dict(light_id=light_id, ls1=ls1, ls2=ls2, ls3=ls3, bs1=bs1,
              bs2=bs2, bcs=bcs, static_kind=static_kind)],
        p, n, wo, bsdf, active)


def uniform_sample_one_light(scene: SceneData, p, n, wo, bsdf, u_num,
                             ls1, ls2, ls3, bs1, bs2, bcs, active):
    """UniformSampleOneLight (core/transport.cpp:51-70)."""
    n_lights = scene.lights.count
    if n_lights == 0:
        return jnp.zeros(p.shape[:-1] + (3,), jnp.float32)
    light_id = jnp.minimum((u_num * n_lights).astype(jnp.int32), n_lights - 1)
    return float(n_lights) * estimate_direct(
        scene, light_id, p, n, wo, bsdf, ls1, ls2, ls3, bs1, bs2, bcs, active)


def uniform_sample_all_lights(scene: SceneData, p, n, wo, bsdf, sample_fn,
                              active):
    """UniformSampleAllLights (core/transport.cpp:31-50) with 1 sample per
    light; sample_fn(i, purpose) -> per-lane uniforms for light i. Every
    light's rays share one traversal launch; each light's kind is known
    statically (kinds_list), so delta lights cost no BSDF-strategy ray."""
    specs = []
    kl = scene.lights.kinds_list
    for i in range(scene.lights.count):
        lid = jnp.full(p.shape[:-1], i, jnp.int32)
        ls1, ls2 = sample_fn(i, 0)
        ls3 = sample_fn(i, 1)[0]
        bs1, bs2 = sample_fn(i, 2)
        bcs = sample_fn(i, 3)[0]
        specs.append(dict(light_id=lid, ls1=ls1, ls2=ls2, ls3=ls3,
                          bs1=bs1, bs2=bs2, bcs=bcs,
                          static_kind=kl[i] if kl else None))
    if not specs:
        return jnp.zeros(p.shape[:-1] + (3,), jnp.float32)
    return estimate_direct_multi(scene, specs, p, n, wo, bsdf, active)

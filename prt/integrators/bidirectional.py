"""Bidirectional path tracing as fixed-size wavefront subpaths.

Replacement for /root/reference/integrators/bidirectional.cpp:
80-210. MAX_VERTS=4 eye and light subpaths are generated by two lax.scans
storing per-vertex geometry + BSDF stacks; all 4x4 prefix connections are
statically unrolled with masked visibility rays; uniform path weighting
1/(nEye+nLight) (weightPath, bidirectional.cpp:185-188); per-prefix direct
lighting with the directWt recurrence (bidirectional.cpp:120-132); RR with
p=0.2 after 2 vertices.

Divergences (documented):
  * the reference OVERWRITES the sampled light emission with
    `Le = lightWeight / lightPdf` (bidirectional.cpp:106) — dropping the
    light's spectrum entirely (fixed in later pbrt versions); we keep
    Le * nLights / lightPdf, the correct factor.
  * emitted radiance when the eye ray hits a light directly, and escaped
    env radiance, are added at the first eye vertex (the reference drops
    both, rendering camera-visible lights black).
  * connection directions are normalized before BSDF evaluation (the
    reference passes the unnormalized difference vector into BSDF::f).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..accel import intersect as isect
from ..bsdf import bsdf as B
from ..core import rng, vecmath as vm
from ..lights import emission, lights as lt
from ..samplers import samplers as smp
from ..scene.data import SceneData
from . import common

_EPS = vm.RAY_EPSILON
MAX_VERTS = 4


def _generate_path(scene: SceneData, o, d, ph, stream: int):
    """generatePath (bidirectional.cpp:133-170) for a wavefront.

    Returns dict of stacked per-vertex arrays [MAX_VERTS, B, ...]:
    p, ng, wi (toward the previous vertex), wo (continuation), f_cont,
    cosw, bw (bsdfWeight), rrw, valid — plus the stacked BsdfBatch."""
    n = o.shape[0]

    def body(carry, v):
        ro, rd, alive = carry
        t, pid, hit = isect.intersect_ids(scene, ro, rd,
                                          jnp.full((n,), _EPS),
                                          jnp.full((n,), 1e30))
        valid = alive & hit
        dg = isect.hit_geometry(scene, pid, ro, rd, t)
        bsdf = common.make_bsdf_at(scene, dg)
        wi = -rd
        # RR after 2 vertices (bidirectional.cpp:152-157).
        rr = rng.uniform(ph, v, stream, 0xEE)
        survive = (v < 2) | (rr <= 0.2)
        rrw = jnp.where((v >= 2) & survive, 5.0, 1.0)
        u1 = rng.uniform(ph, v, stream, 1)
        u2 = rng.uniform(ph, v, stream, 2)
        u3 = rng.uniform(ph, v, stream, 3)
        bs = B.sample_f(bsdf, wi, u1, u2, u3, B.ALL)
        cont_ok = bs["valid"] & (bs["pdf"] > 0.0) & \
            ~(jnp.all(bs["f"] == 0.0, -1) & (bs["pdf"] == 0.0))
        f_cont = B.f(bsdf, wi, bs["wi"])
        cosw = vm.absdot(bs["wi"], dg["nn"])
        out = dict(p=dg["p"], ng=dg["nn"], wi=wi, wo=bs["wi"],
                   f_cont=f_cont, cosw=cosw,
                   bw=jnp.maximum(bs["pdf"], 1e-20), rrw=rrw, valid=valid,
                   area_light=dg["area_light"], bsdf=bsdf)
        alive = valid & survive & cont_ok & (bs["pdf"] > 0.0)
        return (dg["p"], bs["wi"], alive), out

    init = (o, d, jnp.ones(o.shape[:-1], bool))
    _, outs = jax.lax.scan(body, init, jnp.arange(MAX_VERTS))
    return outs


def _vertex(stacked, i):
    return jax.tree_util.tree_map(lambda a: a[i], stacked)


def li(scene: SceneData, o, d, mint, maxt, cfg: smp.SamplerConfig,
       px, py, s_idx, max_depth: int = 5, seed: int = 0, rx=None, ry=None):
    del max_depth  # MAX_VERTS is the reference's fixed bound
    n = o.shape[0]
    ph = rng.hash_u32(px, py, seed, 0xBD12)
    ph = rng.hash_u32(ph, s_idx, 0xBD13)
    has_inf = bool(scene.lights.infinite_meta)
    L = jnp.zeros((n, 3), jnp.float32)

    eye = _generate_path(scene, o, d, ph, 0xE)
    n_eye_v = eye["valid"]           # [4, B]

    # First-hit info for the driver (alpha, t_first).
    t0, pid0, hit0 = isect.intersect_ids(scene, o, d, mint, maxt)
    alpha = jnp.where(hit0, 1.0, 0.0)
    t_first = jnp.where(hit0, t0, maxt)

    # Divergence: emitted + escaped-env radiance at the first eye vertex.
    if has_inf:
        Lesc = lt.le_escaped(scene, d)
        L = L + jnp.where(~hit0[..., None], Lesc, 0.0)
        alpha = jnp.where(~hit0 & jnp.any(Lesc > 0, -1), 1.0, alpha)
    e0 = _vertex(eye, 0)
    L = L + jnp.where(n_eye_v[0][..., None],
                      lt.area_emission(scene, e0["area_light"], e0["ng"],
                                       e0["wi"]), 0.0)

    if scene.lights.count == 0:
        return L, alpha, t_first

    # Light subpath start (bidirectional.cpp:94-112).
    un = rng.uniform(ph, 0x17, 0)
    lid, light_pdf_sel = emission.pick_light_uniform(scene, un)
    u1 = rng.uniform(ph, 0x17, 1)
    u2 = rng.uniform(ph, 0x17, 2)
    u3 = rng.uniform(ph, 0x17, 3)
    u4 = rng.uniform(ph, 0x17, 4)
    u5 = rng.uniform(ph, 0x17, 5)
    em = emission.sample_emission(scene, lid, u1, u2, u3, u4, u5)
    le_ok = em["pdf"] > 0.0
    # Correct factor Le * nLights / pdf (reference bug: drops Le).
    Le = em["Le"] / jnp.maximum(em["pdf"] * light_pdf_sel, 1e-20)[..., None]
    Le = jnp.where(le_ok[..., None], Le, 0.0)
    light = _generate_path(scene, em["o"], em["d"], ph, 0x11)
    n_light_v = light["valid"] & le_ok

    # Prefix throughputs EP[i] = prod_{k<=i-2} f cos/(bw rr) arriving at
    # eye vertex i-1 (evalPath, bidirectional.cpp:189-196).
    def prefixes(path, valid):
        ps = [jnp.ones((n, 3), jnp.float32)]
        for k in range(MAX_VERTS - 1):
            vk = _vertex(path, k)
            step = vk["f_cont"] * (vk["cosw"] / vk["bw"])[..., None] / \
                vk["rrw"][..., None]
            ps.append(ps[-1] * jnp.where(valid[k][..., None], step, 0.0))
        return ps                      # ps[i] valid for vertex index i

    EP = prefixes(eye, n_eye_v)
    LP = prefixes(light, n_light_v)

    # Per-prefix direct lighting + connections (bidirectional.cpp:113-132).
    direct_wt = jnp.ones((n, 3), jnp.float32)
    for i in range(1, MAX_VERTS + 1):
        ev = _vertex(eye, i - 1)
        ev_ok = n_eye_v[i - 1]
        direct_wt = direct_wt / ev["rrw"][..., None]
        ls1 = rng.uniform(ph, i, 0xD1, 1)
        ls2 = rng.uniform(ph, i, 0xD1, 2)
        ls3 = rng.uniform(ph, i, 0xD1, 3)
        bs1 = rng.uniform(ph, i, 0xD1, 4)
        bs2 = rng.uniform(ph, i, 0xD1, 5)
        bcs = rng.uniform(ph, i, 0xD1, 6)
        unum = rng.uniform(ph, i, 0xD1, 7)
        Ld = common.uniform_sample_one_light(
            scene, ev["p"], ev["ng"], ev["wi"], ev["bsdf"],
            unum, ls1, ls2, ls3, bs1, bs2, bcs, ev_ok)
        L = L + jnp.where(ev_ok[..., None],
                          direct_wt * Ld / float(i), 0.0)
        direct_wt = direct_wt * ev["f_cont"] * \
            (ev["cosw"] / ev["bw"])[..., None]

        for j in range(1, MAX_VERTS + 1):
            lv = _vertex(light, j - 1)
            both = ev_ok & n_light_v[j - 1]
            to_l = lv["p"] - ev["p"]
            d2 = jnp.maximum(vm.length_sq(to_l), 1e-12)
            w = to_l * jax.lax.rsqrt(d2)[..., None]
            f_e = B.f(ev["bsdf"], ev["wi"], w)
            f_l = B.f(lv["bsdf"], -w, lv["wi"])
            G = vm.absdot(ev["ng"], w) * vm.absdot(lv["ng"], w) / d2
            contrib = EP[i - 1] * f_e * f_l * LP[j - 1] * Le * \
                (G / (ev["rrw"] * lv["rrw"]))[..., None] / float(i + j)
            need = both & jnp.any(contrib != 0.0, -1)
            dist = jnp.sqrt(d2)
            occ = isect.occluded(scene, ev["p"], w,
                                 jnp.full((n,), _EPS),
                                 dist * (1.0 - 1e-3))
            L = L + jnp.where((need & ~occ)[..., None], contrib, 0.0)

    return L, alpha, t_first

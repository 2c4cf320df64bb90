"""Branchless batched BSDFs: the full BxDF set over SoA lobe tables.

Replacement for /root/reference/core/reflection.{h,cpp}. The
reference's `BSDF` holds up to 8 heap-allocated `BxDF*`; here a shading
wavefront carries a fixed-size lobe table (kind tags + parameter columns) and
every per-kind formula is evaluated masked, elementwise. Semantics preserved
exactly:

  * Fresnel dielectric/conductor (reflection.cpp:31-96),
  * Lambertian / Oren-Nayar (reflection.cpp:128-156, reflection.h:260-276),
  * Torrance-Sparrow microfacet with Blinn & Anisotropic distributions and
    their exact sampling pdfs (reflection.cpp:157-175, 246-332),
  * specular reflection/transmission incl. TIR (reflection.cpp:96-127),
  * FresnelBlend (reflection.cpp:199-218, 333-354),
  * Lafortune lobes (reflection.cpp:176-198),
  * BRDFToBTDF hemisphere flip as a per-lobe flag (reflection.h:143-167),
  * the BSDF mixture rules: uniform component choice, pdf averaged over
    matching non-specular components, BRDF-vs-BTDF sidedness by geometric
    normal (reflection.cpp:402-457, 480-494).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core import mc, vecmath as vm
from ..core.pytree import pytree_dataclass, static

# BxDFType bitflags (reference core/reflection.h:53-68).
REFLECTION = 1
TRANSMISSION = 2
DIFFUSE = 4
GLOSSY = 8
SPECULAR = 16
ALL_TYPES = DIFFUSE | GLOSSY | SPECULAR
ALL_REFLECTION = REFLECTION | ALL_TYPES
ALL_TRANSMISSION = TRANSMISSION | ALL_TYPES
ALL = ALL_REFLECTION | ALL_TRANSMISSION

# Lobe kinds.
BX_NONE = -1
BX_LAMBERTIAN = 0
BX_ORENNAYAR = 1
BX_SPECREFL = 2
BX_SPECTRANS = 3
BX_MICROFACET = 4
BX_FRESNELBLEND = 5
BX_LAFORTUNE = 6

# Fresnel kinds (aux0 for BX_SPECREFL / BX_MICROFACET).
FR_DIELECTRIC = 0
FR_CONDUCTOR = 1
FR_NOOP = 2

# Distribution kinds (aux1 for BX_MICROFACET / BX_FRESNELBLEND).
DIST_BLINN = 0
DIST_ANISO = 1

INV_PI = jnp.float32(1.0 / jnp.pi)
INV_TWOPI = jnp.float32(1.0 / (2.0 * jnp.pi))


_ALL_KINDS = (0, 1, 2, 3, 4, 5, 6)
_ALL_DISTS = (0, 1)


@pytree_dataclass
class LobeTable:
    """SoA BxDF lobes for a shading wavefront of shape [..., L].

    kinds_present/dist_kinds are STATIC sets of kinds that can occur — the
    per-kind formulas below are only traced for present kinds, so a scene
    with only diffuse+specular materials compiles a fraction of the code."""
    kind: jnp.ndarray    # i32[...,L]
    flags: jnp.ndarray   # i32[...,L] BxDFType bits
    flip: jnp.ndarray    # bool[...,L] — BRDFToBTDF wrapper
    R: jnp.ndarray       # f32[...,L,3]
    eta: jnp.ndarray     # f32[...,L,3] conductor eta | [etai, etat, _] diel
    k: jnp.ndarray       # f32[...,L,3] conductor k | FresnelBlend Rs
    p: jnp.ndarray       # f32[...,L,4] exponent / (A,B) / (ex,ey)
    aux0: jnp.ndarray    # i32[...,L] fresnel kind / lafortune id
    aux1: jnp.ndarray    # i32[...,L] distribution kind
    kinds_present: tuple = static(default=None)
    dist_kinds: tuple = static(default=None)


def _kinds(lo) -> tuple:
    kp = lo.kinds_present
    return _ALL_KINDS if kp is None else kp


def _dists(lo_or_tuple) -> tuple:
    d = lo_or_tuple if isinstance(lo_or_tuple, (tuple, type(None))) \
        else lo_or_tuple.dist_kinds
    return _ALL_DISTS if not d else d


@pytree_dataclass
class BsdfBatch:
    """Shading frame + lobes; the wavefront analogue of core/reflection.h
    BSDF (frame from shading dgs: sn=normalize(dpdu), tn=nn x sn)."""
    nn: jnp.ndarray      # f32[...,3] shading normal
    sn: jnp.ndarray
    tn: jnp.ndarray
    ng: jnp.ndarray      # geometric normal
    lobes: LobeTable = None


def make_frame(nn, dpdu, ng):
    sn = vm.normalize(dpdu)
    # Re-orthogonalize against nn.
    sn = vm.normalize(sn - vm.dot(sn, nn)[..., None] * nn)
    tn = vm.cross(nn, sn)
    return nn, sn, tn, ng


def world_to_local(b: BsdfBatch, v):
    return jnp.stack([vm.dot(v, b.sn), vm.dot(v, b.tn), vm.dot(v, b.nn)], -1)


def local_to_world(b: BsdfBatch, v):
    return (v[..., 0:1] * b.sn + v[..., 1:2] * b.tn + v[..., 2:3] * b.nn)


# ---------------------------------------------------------------------------
# Fresnel (reflection.cpp:31-96)
# ---------------------------------------------------------------------------

def fr_diel(cosi, cost, etai, etat):
    rparl = (etat * cosi - etai * cost) / jnp.maximum(etat * cosi + etai * cost, 1e-12)
    rperp = (etai * cosi - etat * cost) / jnp.maximum(etai * cosi + etat * cost, 1e-12)
    return (rparl * rparl + rperp * rperp) * 0.5


def fr_cond(cosi, eta, k):
    cosi = jnp.abs(cosi)[..., None]
    tmp = (eta * eta + k * k) * cosi * cosi
    rparl2 = (tmp - 2.0 * eta * cosi + 1.0) / jnp.maximum(tmp + 2.0 * eta * cosi + 1.0, 1e-12)
    tmp_f = eta * eta + k * k
    rperp2 = (tmp_f - 2.0 * eta * cosi + cosi * cosi) / \
        jnp.maximum(tmp_f + 2.0 * eta * cosi + cosi * cosi, 1e-12)
    return (rparl2 + rperp2) * 0.5


def fresnel_dielectric(cosi, etai, etat):
    """Scalar dielectric Fresnel with sidedness + TIR (reflection.cpp:78-96).
    Lanes whose lobe is not dielectric carry eta 0 and are masked by the
    caller; they get eta 1 here, so their value and gradient stay finite."""
    etai = jnp.where(etai > 0.0, etai, 1.0)
    etat = jnp.where(etat > 0.0, etat, 1.0)
    cosi = jnp.clip(cosi, -1.0, 1.0)
    entering = cosi > 0.0
    ei = jnp.where(entering, etai, etat)
    et = jnp.where(entering, etat, etai)
    sint = ei / et * jnp.sqrt(jnp.maximum(1e-12, 1.0 - cosi * cosi))
    tir = sint >= 1.0
    cost = jnp.sqrt(jnp.maximum(1e-12, 1.0 - sint * sint))
    f = fr_diel(jnp.abs(cosi), cost, ei, et)
    return jnp.where(tir, 1.0, f)


def fresnel_approx_eta(fr):
    r = jnp.clip(fr, 0.0, 0.999)
    return (1.0 + jnp.sqrt(r)) / (1.0 - jnp.sqrt(r))


def fresnel_approx_k(fr):
    r = jnp.clip(fr, 0.0, 0.999)
    return 2.0 * jnp.sqrt(r / (1.0 - r))


def _fresnel_eval(aux0, eta, k, cosi):
    """Per-lobe Fresnel spectrum [...,3] by fresnel-kind tag."""
    f_d = fresnel_dielectric(cosi, eta[..., 0], eta[..., 1])[..., None]
    f_c = fr_cond(cosi, eta, k)
    one = jnp.ones_like(f_c)
    out = jnp.where((aux0 == FR_DIELECTRIC)[..., None], f_d,
          jnp.where((aux0 == FR_CONDUCTOR)[..., None], f_c, one))
    return out


# ---------------------------------------------------------------------------
# Microfacet distributions (reflection.h:311-345, reflection.cpp:246-332)
# ---------------------------------------------------------------------------

def _blinn_d(e, wh):
    costh = jnp.abs(wh[..., 2])
    return (e + 2.0) * INV_TWOPI * jnp.power(jnp.maximum(costh, 1e-7), e)


def _aniso_d(ex, ey, wh):
    costh = jnp.abs(wh[..., 2])
    d = 1.0 - costh * costh
    d = jnp.maximum(d, 1e-8)
    e = (ex * wh[..., 0] ** 2 + ey * wh[..., 1] ** 2) / d
    return jnp.sqrt((ex + 2.0) * (ey + 2.0)) * INV_TWOPI * \
        jnp.power(jnp.maximum(costh, 1e-7), e)


def _dist_d(aux1, p, wh, dists=_ALL_DISTS):
    if DIST_ANISO not in dists:
        return _blinn_d(p[..., 0], wh)
    if DIST_BLINN not in dists:
        return _aniso_d(p[..., 0], p[..., 1], wh)
    return jnp.where(aux1 == DIST_BLINN, _blinn_d(p[..., 0], wh),
                     _aniso_d(p[..., 0], p[..., 1], wh))


def _dist_pdf(aux1, p, wo, wi, dists=_ALL_DISTS):
    wh = vm.normalize(wo + wi)
    woh = vm.dot(wo, wh)
    costh = jnp.abs(wh[..., 2])
    if DIST_BLINN in dists:
        e_b = p[..., 0]
        blinn = (e_b + 1.0) * jnp.power(jnp.maximum(costh, 1e-7), e_b) / \
            (2.0 * jnp.pi * 4.0 * jnp.maximum(woh, 1e-7))
    if DIST_ANISO in dists:
        ex, ey = p[..., 0], p[..., 1]
        ds = jnp.maximum(1.0 - costh * costh, 1e-8)
        e_a = (ex * wh[..., 0] ** 2 + ey * wh[..., 1] ** 2) / ds
        d_a = jnp.sqrt((ex + 1.0) * (ey + 1.0)) * INV_TWOPI * \
            jnp.power(jnp.maximum(costh, 1e-7), e_a)
        aniso = d_a / (4.0 * jnp.maximum(woh, 1e-7))
    if DIST_ANISO not in dists:
        pdf = blinn
    elif DIST_BLINN not in dists:
        pdf = aniso
    else:
        pdf = jnp.where(aux1 == DIST_BLINN, blinn, aniso)
    return jnp.where(woh <= 0.0, 0.0, pdf)


def _dist_sample_wh(aux1, p, wo, u1, u2, dists=_ALL_DISTS):
    """Sample the half-vector; returns wh (flipped into wo's hemisphere)."""
    if DIST_BLINN in dists:
        # Blinn (reflection.cpp:246-262)
        e_b = p[..., 0]
        cost_b = jnp.power(jnp.maximum(u1, 1e-12), 1.0 / (e_b + 1.0))
        phi_b = u2 * 2.0 * jnp.pi
    if DIST_ANISO in dists:
        # Anisotropic first-quadrant remap (reflection.cpp:275-321)
        ex, ey = p[..., 0], p[..., 1]
        q = jnp.floor(u1 * 4.0)
        u1r = jnp.where(q == 0, 4.0 * u1,
              jnp.where(q == 1, 4.0 * (0.5 - u1),
              jnp.where(q == 2, 4.0 * (u1 - 0.5), 4.0 * (1.0 - u1))))
        u1r = jnp.clip(u1r, 0.0, 1.0)
        same = jnp.abs(ex - ey) < 1e-6
        phi_fq = jnp.where(
            same, jnp.pi * u1r * 0.5,
            jnp.arctan(jnp.sqrt((ex + 1.0) / (ey + 1.0)) *
                       jnp.tan(jnp.pi * jnp.minimum(u1r, 0.999999) * 0.5)))
        cosphi, sinphi = jnp.cos(phi_fq), jnp.sin(phi_fq)
        cost_a = jnp.power(jnp.maximum(u2, 1e-12),
                           1.0 / (ex * cosphi * cosphi + ey * sinphi * sinphi + 1.0))
        phi_a = jnp.where(q == 0, phi_fq,
                jnp.where(q == 1, jnp.pi - phi_fq,
                jnp.where(q == 2, jnp.pi + phi_fq, 2.0 * jnp.pi - phi_fq)))
    if DIST_ANISO not in dists:
        cost, phi = cost_b, phi_b
    elif DIST_BLINN not in dists:
        cost, phi = cost_a, phi_a
    else:
        cost = jnp.where(aux1 == DIST_BLINN, cost_b, cost_a)
        phi = jnp.where(aux1 == DIST_BLINN, phi_b, phi_a)
    sint = jnp.sqrt(jnp.maximum(1e-12, 1.0 - cost * cost))
    wh = vm.spherical_direction(sint, cost, phi)
    flip = (wo[..., 2] * wh[..., 2]) < 0.0
    wh = jnp.where(flip[..., None], -wh, wh)
    return wh


def _microfacet_g(wo, wi, wh):
    ndwh = jnp.abs(wh[..., 2])
    ndwo = jnp.abs(wo[..., 2])
    ndwi = jnp.abs(wi[..., 2])
    wodwh = jnp.maximum(vm.absdot(wo, wh), 1e-7)
    return jnp.minimum(1.0, jnp.minimum(2.0 * ndwh * ndwo / wodwh,
                                        2.0 * ndwh * ndwi / wodwh))


# ---------------------------------------------------------------------------
# Lafortune measured-material data (materials/{bluepaint,...}.cpp). Loaded
# lazily from materials/lafortune_data.py.
# ---------------------------------------------------------------------------

def _lafortune_f(aux0, R, wo, wi):
    from ..materials.lafortune_data import LOBE_X, LOBE_Y, LOBE_Z, LOBE_E
    lx, ly, lz, le = (jnp.asarray(LOBE_X), jnp.asarray(LOBE_Y),
                      jnp.asarray(LOBE_Z), jnp.asarray(LOBE_E))
    mid = jnp.maximum(aux0, 0)
    ret = R * INV_PI
    for li in range(LOBE_X.shape[1]):
        x = lx[mid, li]  # [...,3]
        y = ly[mid, li]
        z = lz[mid, li]
        e = le[mid, li]
        v = (x * (wo[..., 0] * wi[..., 0])[..., None]
             + y * (wo[..., 1] * wi[..., 1])[..., None]
             + z * (wo[..., 2] * wi[..., 2])[..., None])
        ret = ret + jnp.power(jnp.maximum(v, 0.0), e)
    return ret


# ---------------------------------------------------------------------------
# Per-lobe f / pdf over the whole lobe table ([...,L] lanes at once)
# ---------------------------------------------------------------------------

def _lobes_f(lo: LobeTable, wo, wi):
    """f for every lobe: wo/wi f32[...,1,3] broadcast over L. -> [...,L,3].
    Specular lobes contribute 0 (delta functions)."""
    wi_l = jnp.where(lo.flip[..., None], jnp.concatenate(
        [wi[..., :2], -wi[..., 2:3]], -1), wi)
    kinds = _kinds(lo)
    dists = _dists(lo)

    zero = jnp.zeros_like(lo.R)
    out = zero
    if BX_LAMBERTIAN in kinds:
        f_lam = lo.R * INV_PI
        out = jnp.where((lo.kind == BX_LAMBERTIAN)[..., None], f_lam, out)
    if BX_ORENNAYAR in kinds:
        # Oren-Nayar (reflection.cpp:132-156); A,B precomputed in p0,p1.
        sin_i = jnp.sqrt(jnp.maximum(1e-12, 1.0 - wi_l[..., 2] ** 2))
        sin_o = jnp.sqrt(jnp.maximum(1e-12, 1.0 - wo[..., 2] ** 2))
        both = (sin_i > 1e-4) & (sin_o > 1e-4)
        inv_si = 1.0 / jnp.maximum(sin_i, 1e-7)
        inv_so = 1.0 / jnp.maximum(sin_o, 1e-7)
        cphi_i, sphi_i = wi_l[..., 0] * inv_si, wi_l[..., 1] * inv_si
        cphi_o, sphi_o = wo[..., 0] * inv_so, wo[..., 1] * inv_so
        dcos = cphi_i * cphi_o + sphi_i * sphi_o
        maxcos = jnp.where(both, jnp.maximum(0.0, dcos), 0.0)
        ci, co = jnp.abs(wi_l[..., 2]), jnp.abs(wo[..., 2])
        big_i = ci > co
        sinalpha = jnp.where(big_i, sin_o, sin_i)
        tanbeta = jnp.where(big_i, sin_i / jnp.maximum(ci, 1e-7),
                            sin_o / jnp.maximum(co, 1e-7))
        f_on = lo.R * INV_PI * \
            (lo.p[..., 0] + lo.p[..., 1] * maxcos * sinalpha * tanbeta)[..., None]
        out = jnp.where((lo.kind == BX_ORENNAYAR)[..., None], f_on, out)
    if BX_MICROFACET in kinds or BX_FRESNELBLEND in kinds:
        wh_raw = wi_l + wo
        wh_ok = vm.length_sq(wh_raw) > 1e-12
        wh = vm.normalize(wh_raw)
        costh_h = vm.dot(wi_l, wh)
        d_val = _dist_d(lo.aux1, lo.p, wh, dists)
        same_h = (wo[..., 2] * wi_l[..., 2]) > 0.0
    if BX_MICROFACET in kinds:
        # Microfacet (reflection.cpp:157-175)
        F = _fresnel_eval(lo.aux0, lo.eta, lo.k, costh_h)
        g_val = _microfacet_g(wo, wi_l, wh)
        denom = 4.0 * jnp.maximum(jnp.abs(wi_l[..., 2]) * jnp.abs(wo[..., 2]), 1e-7)
        f_mf = lo.R * F * (d_val * g_val / denom)[..., None]
        f_mf = jnp.where((wh_ok & same_h)[..., None], f_mf, 0.0)
        out = jnp.where((lo.kind == BX_MICROFACET)[..., None], f_mf, out)
    if BX_FRESNELBLEND in kinds:
        # FresnelBlend (reflection.cpp:199-218): Rd=lo.R, Rs=lo.k.
        rd, rs = lo.R, lo.k
        pw = lambda c: 1.0 - jnp.power(1.0 - 0.5 * jnp.abs(c), 5)
        diffuse = (28.0 / (23.0 * jnp.pi)) * rd * (1.0 - rs) * \
            (pw(wi_l[..., 2]) * pw(wo[..., 2]))[..., None]
        schlick = rs + jnp.power(jnp.maximum(1.0 - costh_h, 0.0), 5)[..., None] * (1.0 - rs)
        spec = (d_val / (4.0 * jnp.maximum(vm.absdot(wi_l, wh), 1e-7) *
                         jnp.maximum(jnp.maximum(jnp.abs(wi_l[..., 2]),
                                                 jnp.abs(wo[..., 2])), 1e-7)))[..., None] * schlick
        f_fb = diffuse + jnp.where(wh_ok[..., None], spec, 0.0)
        f_fb = jnp.where(same_h[..., None], f_fb, 0.0)
        out = jnp.where((lo.kind == BX_FRESNELBLEND)[..., None], f_fb, out)
    if BX_LAFORTUNE in kinds:
        f_laf = _lafortune_f(lo.aux0, lo.R, wo, wi_l)
        out = jnp.where((lo.kind == BX_LAFORTUNE)[..., None], f_laf, out)
    return out


def _lobes_pdf(lo: LobeTable, wo, wi):
    """pdf for every non-specular lobe. -> [...,L]."""
    wi_l = jnp.where(lo.flip[..., None], jnp.concatenate(
        [wi[..., :2], -wi[..., 2:3]], -1), wi)
    kinds = _kinds(lo)
    dists = _dists(lo)
    same_h = (wo[..., 2] * wi_l[..., 2]) > 0.0
    out = jnp.zeros_like(lo.p[..., 0])
    if any(k in kinds for k in (BX_LAMBERTIAN, BX_ORENNAYAR, BX_LAFORTUNE)):
        cos_pdf = jnp.where(same_h, jnp.abs(wi_l[..., 2]) * INV_PI, 0.0)
        out = jnp.where((lo.kind == BX_LAMBERTIAN) |
                        (lo.kind == BX_ORENNAYAR) |
                        (lo.kind == BX_LAFORTUNE), cos_pdf, out)
    if BX_MICROFACET in kinds or BX_FRESNELBLEND in kinds:
        dpdf = _dist_pdf(lo.aux1, lo.p, wo, wi_l, dists)
    if BX_MICROFACET in kinds:
        out = jnp.where(lo.kind == BX_MICROFACET,
                        jnp.where(same_h, dpdf, 0.0), out)
    if BX_FRESNELBLEND in kinds:
        fb_pdf = jnp.where(same_h,
                           0.5 * (jnp.abs(wi_l[..., 2]) * INV_PI + dpdf), 0.0)
        out = jnp.where(lo.kind == BX_FRESNELBLEND, fb_pdf, out)
    return out


def _lobe_sample(lo_kind, lo_flags, lo_flip, lo_R, lo_eta, lo_k, lo_p,
                 lo_aux0, lo_aux1, wo, u1, u2, kinds=_ALL_KINDS,
                 dists=_ALL_DISTS):
    """Sample wi for ONE selected lobe per lane (params already gathered).

    Returns (wi, pdf, f_specular) where f_specular is the delta-weighted
    value for specular kinds (others recompute f at BSDF level). Only the
    per-kind samplers for `kinds` are traced.
    """
    diffuseish = any(k in kinds for k in
                     (BX_LAMBERTIAN, BX_ORENNAYAR, BX_LAFORTUNE))
    is_sr = lo_kind == BX_SPECREFL
    is_st = lo_kind == BX_SPECTRANS
    is_mf = lo_kind == BX_MICROFACET
    is_fb = lo_kind == BX_FRESNELBLEND

    wi = jnp.zeros_like(wo)
    if diffuseish:
        # Cosine hemisphere, flip to wo's side (reflection.cpp:219-230).
        wi_cos = mc.cosine_sample_hemisphere(u1, u2)
        wi_cos = jnp.where((wo[..., 2] < 0.0)[..., None],
                           wi_cos * jnp.asarray([1.0, 1.0, -1.0]), wi_cos)
        wi = wi_cos
    if BX_MICROFACET in kinds:
        wh = _dist_sample_wh(lo_aux1, lo_p, wo, u1, u2, dists)
        wi_mf = -wo + 2.0 * vm.dot(wo, wh)[..., None] * wh
        wi = jnp.where(is_mf[..., None], wi_mf, wi)
    if BX_FRESNELBLEND in kinds:
        # Half cosine, half microfacet (reflection.cpp:333-347).
        use_cos = u1 < 0.5
        u1_fb = jnp.where(use_cos, 2.0 * u1, 2.0 * (u1 - 0.5))
        wi_fb_cos = mc.cosine_sample_hemisphere(u1_fb, u2)
        wi_fb_cos = jnp.where((wo[..., 2] < 0.0)[..., None],
                              wi_fb_cos * jnp.asarray([1.0, 1.0, -1.0]),
                              wi_fb_cos)
        wh_fb = _dist_sample_wh(lo_aux1, lo_p, wo, u1_fb, u2, dists)
        wi_fb_mf = -wo + 2.0 * vm.dot(wo, wh_fb)[..., None] * wh_fb
        wi_fb = jnp.where(use_cos[..., None], wi_fb_cos, wi_fb_mf)
        wi = jnp.where(is_fb[..., None], wi_fb, wi)
    if BX_SPECREFL in kinds:
        wi_sr = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)
        wi = jnp.where(is_sr[..., None], wi_sr, wi)
    etai_d, etat_d = lo_eta[..., 0], lo_eta[..., 1]
    entering = wo[..., 2] > 0.0
    ei = jnp.where(entering, etai_d, etat_d)
    et = jnp.where(entering, etat_d, etai_d)
    tir = jnp.zeros(wo.shape[:-1], bool)
    if BX_SPECTRANS in kinds:
        # Specular transmission (reflection.cpp:104-127).
        sini2 = jnp.maximum(0.0, 1.0 - wo[..., 2] ** 2)
        eta_r = ei / jnp.maximum(et, 1e-7)
        sint2 = eta_r * eta_r * sini2
        tir = sint2 >= 1.0
        cost = jnp.sqrt(jnp.maximum(1e-12, 1.0 - sint2))
        cost = jnp.where(entering, -cost, cost)
        wi_st = jnp.stack([eta_r * -wo[..., 0], eta_r * -wo[..., 1], cost], -1)
        wi = jnp.where(is_st[..., None], wi_st, wi)

    # pdfs
    pdf = jnp.zeros(wo.shape[:-1], jnp.float32)
    if diffuseish:
        pdf = jnp.abs(wi[..., 2]) * INV_PI
    if BX_MICROFACET in kinds or BX_FRESNELBLEND in kinds:
        dpdf = _dist_pdf(lo_aux1, lo_p, wo, wi, dists)
        if BX_MICROFACET in kinds:
            pdf = jnp.where(is_mf, dpdf, pdf)
        if BX_FRESNELBLEND in kinds:
            pdf = jnp.where(is_fb,
                            0.5 * (jnp.abs(wi[..., 2]) * INV_PI + dpdf), pdf)
    pdf = jnp.where(is_sr | is_st, 1.0, pdf)
    same_h = (wo[..., 2] * wi[..., 2]) > 0.0
    pdf = jnp.where((is_mf | is_fb) & ~same_h, 0.0, pdf)
    pdf = jnp.where(is_st & tir, 0.0, pdf)

    # Specular f values (delta-weighted).
    f_spec = jnp.zeros_like(lo_R)
    abs_ci = jnp.maximum(jnp.abs(wi[..., 2]), 1e-7)
    if BX_SPECREFL in kinds:
        F_sr = _fresnel_eval(lo_aux0, lo_eta, lo_k, wo[..., 2])
        f_sr = F_sr * lo_R / abs_ci[..., None]
        f_spec = jnp.where(is_sr[..., None], f_sr, f_spec)
    if BX_SPECTRANS in kinds:
        F_st = fresnel_dielectric(wo[..., 2], etai_d, etat_d)
        f_st = ((et * et) / jnp.maximum(ei * ei, 1e-12) *
                (1.0 - F_st) / abs_ci)[..., None] * lo_R
        f_st = jnp.where(tir[..., None], 0.0, f_st)
        f_spec = jnp.where(is_st[..., None], f_st, f_spec)

    # BRDFToBTDF wrapper: flip the returned wi.
    wi = jnp.where(lo_flip[..., None],
                   jnp.concatenate([wi[..., :2], -wi[..., 2:3]], -1), wi)
    return wi, pdf, f_spec


# ---------------------------------------------------------------------------
# BSDF-level API (reflection.cpp:402-509)
# ---------------------------------------------------------------------------

def _matches(lobe_flags, mask):
    """MatchesFlags: (type & flags) == type, and lobe exists."""
    return (jnp.bitwise_and(lobe_flags, mask) == lobe_flags) & (lobe_flags > 0)


def num_components(b: BsdfBatch, mask):
    return jnp.sum(_matches(b.lobes.flags, mask).astype(jnp.int32), axis=-1)


def rho_approx(b: BsdfBatch, mask=ALL & ~SPECULAR):
    """Approximate hemispherical reflectance: sum of lobe R over matching
    non-specular components. Exact for Lambertian (reflection.cpp rho
    closed form); an approximation of the reference's 16-sample MC estimate
    (core/reflection.cpp:355-392) for glossy lobes — used by IGI VirtualLight
    creation and photon-map diffuse shortcuts, where R is the intended
    albedo scale of every lobe kind."""
    match = _matches(b.lobes.flags, jnp.asarray(mask)[..., None])
    return jnp.sum(jnp.where(match[..., None], b.lobes.R, 0.0), axis=-2)


def f(b: BsdfBatch, wo_w, wi_w, mask=ALL):
    """BSDF::f with geometric-normal sidedness (reflection.cpp:480-494)."""
    wo = world_to_local(b, wo_w)[..., None, :]
    wi = world_to_local(b, wi_w)[..., None, :]
    reflect_side = (vm.dot(wi_w, b.ng) * vm.dot(wo_w, b.ng)) > 0.0
    side_mask = jnp.where(reflect_side, mask & ~TRANSMISSION, mask & ~REFLECTION)
    match = _matches(b.lobes.flags, side_mask[..., None])
    vals = _lobes_f(b.lobes, wo, wi)
    return jnp.sum(jnp.where(match[..., None], vals, 0.0), axis=-2)


def pdf(b: BsdfBatch, wo_w, wi_w, mask=ALL):
    """BSDF::Pdf: mean pdf over matching components."""
    wo = world_to_local(b, wo_w)[..., None, :]
    wi = world_to_local(b, wi_w)[..., None, :]
    match = _matches(b.lobes.flags, jnp.asarray(mask)[..., None])
    pdfs = _lobes_pdf(b.lobes, wo, wi)
    n = jnp.sum(match.astype(jnp.float32), axis=-1)
    total = jnp.sum(jnp.where(match, pdfs, 0.0), axis=-1)
    return jnp.where(n > 0, total / jnp.maximum(n, 1.0), 0.0)


def sample_f(b: BsdfBatch, wo_w, u1, u2, u3, mask=ALL):
    """BSDF::Sample_f (reflection.cpp:402-457).

    Returns dict(wi_w, f, pdf, sampled_flags, valid).
    """
    lo = b.lobes
    L = lo.kind.shape[-1]
    mask_arr = jnp.asarray(mask)
    match = _matches(lo.flags, mask_arr[..., None])  # [...,L]
    ncomp = jnp.sum(match.astype(jnp.int32), axis=-1)
    any_match = ncomp > 0

    # which = min(floor(u3 * n), n-1); select the which-th matching lobe.
    which = jnp.minimum((u3 * ncomp.astype(jnp.float32)).astype(jnp.int32),
                        jnp.maximum(ncomp - 1, 0))
    cum = jnp.cumsum(match.astype(jnp.int32), axis=-1) - 1  # rank per lobe
    sel_onehot = match & (cum == which[..., None])

    # One-hot masked sums, NOT take_along_axis: a select+reduce over the
    # tiny L minor axis fuses into the surrounding elementwise code, where
    # a gather would be an op of its own. Exactly one lobe is
    # selected, so the sums reproduce the gathered row bit-exactly (empty
    # selection -> zeros; callers mask by `valid`).
    def gath(a):
        if a.dtype == jnp.bool_:
            return jnp.any(a & sel_onehot, axis=-1)
        if a.ndim == sel_onehot.ndim:    # [...,L]
            return jnp.sum(jnp.where(sel_onehot, a, 0), axis=-1,
                           dtype=a.dtype)
        return jnp.sum(jnp.where(sel_onehot[..., None], a, 0), axis=-2,
                       dtype=a.dtype)    # [...,L,C]

    wo = world_to_local(b, wo_w)
    wi_l, pdf_sel, f_spec = _lobe_sample(
        gath(lo.kind), gath(lo.flags), gath(lo.flip), gath(lo.R),
        gath(lo.eta), gath(lo.k), gath(lo.p), gath(lo.aux0), gath(lo.aux1),
        wo, u1, u2, _kinds(lo), _dists(lo))
    sampled_flags = gath(lo.flags)
    is_spec = jnp.bitwise_and(sampled_flags, SPECULAR) > 0

    wi_w = local_to_world(b, wi_l)

    # Overall pdf: add other matching lobes' pdfs when not specular.
    pdfs_all = _lobes_pdf(lo, wo[..., None, :], wi_l[..., None, :])
    not_sel = match & ~sel_onehot
    pdf_total = pdf_sel + jnp.where(
        is_spec, 0.0, jnp.sum(jnp.where(not_sel, pdfs_all, 0.0), axis=-1))
    pdf_total = pdf_total / jnp.maximum(ncomp.astype(jnp.float32), 1.0)

    # f: recompute over matching lobes with sidedness, unless specular.
    reflect_side = (vm.dot(wi_w, b.ng) * vm.dot(wo_w, b.ng)) > 0.0
    side_mask = jnp.where(reflect_side, mask_arr & ~TRANSMISSION,
                          mask_arr & ~REFLECTION)
    match_side = _matches(lo.flags, side_mask[..., None])
    f_all = _lobes_f(lo, wo[..., None, :], wi_l[..., None, :])
    f_sum = jnp.sum(jnp.where(match_side[..., None], f_all, 0.0), axis=-2)
    f_val = jnp.where(is_spec[..., None], f_spec, f_sum)

    valid = any_match & (pdf_sel > 0.0)
    # BSDF eta of the sampled lobe (etat/etai for dielectrics, 1 else) —
    # needed by specular ray-differential propagation (whitted.cpp:117).
    eta_cols = gath(lo.eta)
    eta_bsdf = jnp.where(
        gath(lo.kind) == BX_SPECTRANS,
        eta_cols[..., 1] / jnp.maximum(eta_cols[..., 0], 1e-6), 1.0)
    return dict(wi=wi_w, f=f_val, pdf=jnp.where(valid, pdf_total, 0.0),
                flags=sampled_flags, specular=is_spec, valid=valid,
                eta=eta_bsdf)

"""BSDF unit tests: sampling/pdf consistency, energy conservation,
reciprocity — the kernel-level test strategy of SURVEY.md section 4."""
import numpy as np
import jax.numpy as jnp

from prt.bsdf import bsdf as B
from prt.core import rng


def _single_lobe_batch(n, kind, flags, R=(1.0, 1.0, 1.0), eta=(1.0, 1.5, 1.0),
                       k=(0.0, 0.0, 0.0), p=(20.0, 0.0, 0.0, 0.0),
                       aux0=0, aux1=0, flip=False):
    L = 4
    mk = lambda v, dt=jnp.float32: jnp.asarray(v, dt)
    lobes = B.LobeTable(
        kind=jnp.full((n, L), -1, jnp.int32).at[:, 0].set(kind),
        flags=jnp.zeros((n, L), jnp.int32).at[:, 0].set(flags),
        flip=jnp.zeros((n, L), bool).at[:, 0].set(flip),
        R=jnp.zeros((n, L, 3)).at[:, 0].set(mk(R)),
        eta=jnp.ones((n, L, 3)).at[:, 0].set(mk(eta)),
        k=jnp.zeros((n, L, 3)).at[:, 0].set(mk(k)),
        p=jnp.zeros((n, L, 4)).at[:, 0].set(mk(p)),
        aux0=jnp.zeros((n, L), jnp.int32).at[:, 0].set(aux0),
        aux1=jnp.zeros((n, L), jnp.int32).at[:, 0].set(aux1),
    )
    z = jnp.asarray([0.0, 0.0, 1.0])
    x = jnp.asarray([1.0, 0.0, 0.0])
    y = jnp.asarray([0.0, 1.0, 0.0])
    rep = lambda v: jnp.broadcast_to(v, (n, 3))
    return B.BsdfBatch(nn=rep(z), sn=rep(x), tn=rep(y), ng=rep(z),
                       lobes=lobes)


def _wo(n, theta=0.7):
    w = jnp.asarray([np.sin(theta), 0.0, np.cos(theta)], jnp.float32)
    return jnp.broadcast_to(w, (n, 3))


def test_lambertian_f_value():
    n = 4
    b = _single_lobe_batch(n, B.BX_LAMBERTIAN, B.REFLECTION | B.DIFFUSE,
                           R=(0.8, 0.6, 0.4))
    wo = _wo(n)
    wi = _wo(n, 0.3)
    f = np.asarray(B.f(b, wo, wi))
    assert np.allclose(f[0], np.array([0.8, 0.6, 0.4]) / np.pi, atol=1e-6)


def test_sample_pdf_consistency_microfacet():
    """Sampled pdf matches pdf() evaluated at the sampled direction."""
    n = 4096
    b = _single_lobe_batch(n, B.BX_MICROFACET, B.REFLECTION | B.GLOSSY,
                           p=(30.0, 0, 0, 0), aux0=B.FR_NOOP,
                           aux1=B.DIST_BLINN)
    wo = _wo(n)
    i = jnp.arange(n)
    out = B.sample_f(b, wo, rng.uniform(i, 1), rng.uniform(i, 2),
                     rng.uniform(i, 3))
    pdf2 = B.pdf(b, wo, out["wi"])
    valid = np.asarray(out["valid"]) & (np.asarray(out["pdf"]) > 1e-5)
    a = np.asarray(out["pdf"])[valid]
    c = np.asarray(pdf2)[valid]
    assert np.allclose(a, c, rtol=1e-3, atol=1e-5)


def test_cosine_weighted_albedo_lambertian():
    """MC estimate of rho_dh for Lambertian R: E[f |cos| / pdf] = R."""
    n = 20000
    b = _single_lobe_batch(n, B.BX_LAMBERTIAN, B.REFLECTION | B.DIFFUSE,
                           R=(0.7, 0.7, 0.7))
    wo = _wo(n)
    i = jnp.arange(n)
    out = B.sample_f(b, wo, rng.uniform(i, 4), rng.uniform(i, 5),
                     rng.uniform(i, 6))
    cos_i = np.abs(np.asarray(out["wi"])[:, 2])
    est = np.asarray(out["f"])[:, 0] * cos_i / np.maximum(
        np.asarray(out["pdf"]), 1e-9)
    assert abs(est.mean() - 0.7) < 0.01


def test_microfacet_energy_bounded():
    """rho estimate for a NoOp-Fresnel Blinn microfacet must be <= ~1."""
    n = 30000
    b = _single_lobe_batch(n, B.BX_MICROFACET, B.REFLECTION | B.GLOSSY,
                           p=(20.0, 0, 0, 0), aux0=B.FR_NOOP,
                           aux1=B.DIST_BLINN)
    wo = _wo(n, 0.4)
    i = jnp.arange(n)
    out = B.sample_f(b, wo, rng.uniform(i, 7), rng.uniform(i, 8),
                     rng.uniform(i, 9))
    cos_i = np.abs(np.asarray(out["wi"])[:, 2])
    ok = np.asarray(out["pdf"]) > 1e-6
    est = np.where(ok, np.asarray(out["f"])[:, 0] * cos_i /
                   np.maximum(np.asarray(out["pdf"]), 1e-9), 0.0)
    assert est.mean() <= 1.05


def test_specular_reflection_direction_and_fresnel():
    n = 4
    b = _single_lobe_batch(n, B.BX_SPECREFL, B.REFLECTION | B.SPECULAR,
                           R=(1.0, 1.0, 1.0), eta=(1.0, 1.5, 1.0),
                           aux0=B.FR_DIELECTRIC)
    wo = _wo(n, 0.5)
    i = jnp.arange(n)
    out = B.sample_f(b, wo, rng.uniform(i, 1), rng.uniform(i, 2),
                     rng.uniform(i, 3))
    wi = np.asarray(out["wi"])[0]
    wo0 = np.asarray(wo)[0]
    assert np.allclose(wi, [-wo0[0], -wo0[1], wo0[2]], atol=1e-6)
    # Fresnel at normal-ish incidence ~ ((1.5-1)/(1.5+1))^2 = 0.04 at 0 deg;
    # at 0.5 rad a bit higher. f = F/|cos|.
    F = np.asarray(out["f"])[0, 0] * abs(wi[2])
    assert 0.03 < F < 0.12


def test_specular_transmission_snell_and_tir():
    n = 2
    b = _single_lobe_batch(n, B.BX_SPECTRANS, B.TRANSMISSION | B.SPECULAR,
                           R=(1.0, 1.0, 1.0), eta=(1.0, 1.5, 1.0))
    # From outside at 0.5 rad: refraction.
    wo = _wo(n, 0.5)
    i = jnp.arange(n)
    out = B.sample_f(b, wo, rng.uniform(i, 1), rng.uniform(i, 2),
                     rng.uniform(i, 3))
    wi = np.asarray(out["wi"])[0]
    # Snell: sin_t = sin_i / 1.5.
    assert abs(abs(wi[0]) - np.sin(0.5) / 1.5) < 1e-5
    assert wi[2] < 0  # transmitted to other hemisphere
    # From inside beyond critical angle (sin c = 1/1.5 -> c ~ 0.7297): TIR.
    theta = 1.0
    wo_in = jnp.broadcast_to(
        jnp.asarray([np.sin(theta), 0.0, -np.cos(theta)], jnp.float32), (n, 3))
    out2 = B.sample_f(b, wo_in, rng.uniform(i, 1), rng.uniform(i, 2),
                      rng.uniform(i, 3))
    assert not bool(np.asarray(out2["valid"])[0])


def test_oren_nayar_reduces_to_lambertian_at_sigma0():
    n = 8
    b_on = _single_lobe_batch(n, B.BX_ORENNAYAR, B.REFLECTION | B.DIFFUSE,
                              R=(0.5, 0.5, 0.5), p=(1.0, 0.0, 0.0, 0.0))
    b_lam = _single_lobe_batch(n, B.BX_LAMBERTIAN, B.REFLECTION | B.DIFFUSE,
                               R=(0.5, 0.5, 0.5))
    wo = _wo(n, 0.6)
    wi = _wo(n, 0.2)
    assert np.allclose(np.asarray(B.f(b_on, wo, wi)),
                       np.asarray(B.f(b_lam, wo, wi)), atol=1e-6)


def test_reciprocity_orennayar():
    n = 8
    b = _single_lobe_batch(n, B.BX_ORENNAYAR, B.REFLECTION | B.DIFFUSE,
                           R=(0.5, 0.5, 0.5), p=(0.9, 0.3, 0.0, 0.0))
    wo = _wo(n, 0.6)
    th, ph_ = 0.9, 2.0
    wi = jnp.broadcast_to(jnp.asarray(
        [np.sin(th) * np.cos(ph_), np.sin(th) * np.sin(ph_), np.cos(th)],
        jnp.float32), (n, 3))
    assert np.allclose(np.asarray(B.f(b, wo, wi)),
                       np.asarray(B.f(b, wi, wo)), atol=1e-5)


def test_mixture_two_lobes_pdf_averaged():
    """plastic-like: lambertian + microfacet; BSDF::Pdf = mean of both."""
    n = 16
    L = 4
    lobes = B.LobeTable(
        kind=jnp.full((n, L), -1, jnp.int32).at[:, 0].set(B.BX_LAMBERTIAN)
        .at[:, 1].set(B.BX_MICROFACET),
        flags=jnp.zeros((n, L), jnp.int32)
        .at[:, 0].set(B.REFLECTION | B.DIFFUSE)
        .at[:, 1].set(B.REFLECTION | B.GLOSSY),
        flip=jnp.zeros((n, L), bool),
        R=jnp.zeros((n, L, 3)).at[:, :2].set(0.5),
        eta=jnp.ones((n, L, 3)),
        k=jnp.zeros((n, L, 3)),
        p=jnp.zeros((n, L, 4)).at[:, 1, 0].set(10.0),
        aux0=jnp.full((n, L), B.FR_NOOP, jnp.int32),
        aux1=jnp.zeros((n, L), jnp.int32),
    )
    z = jnp.asarray([0.0, 0.0, 1.0])
    x = jnp.asarray([1.0, 0.0, 0.0])
    y = jnp.asarray([0.0, 1.0, 0.0])
    rep = lambda v: jnp.broadcast_to(v, (n, 3))
    b = B.BsdfBatch(nn=rep(z), sn=rep(x), tn=rep(y), ng=rep(z), lobes=lobes)
    wo = _wo(n, 0.5)
    wi = _wo(n, 0.45)
    # Single-lobe pdfs:
    pdf_cos = abs(np.asarray(wi)[0, 2]) / np.pi
    total = np.asarray(B.pdf(b, wo, wi))[0]
    # mean of cosine pdf and blinn pdf; blinn pdf > 0 here.
    assert total > pdf_cos / 2  # at least the cosine half
    nc = np.asarray(B.num_components(b, B.ALL))[0]
    assert nc == 2

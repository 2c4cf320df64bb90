"""Monte Carlo warps, heuristics, and 1D distributions.

Equivalent of /root/reference/core/mc.{h,cpp}: sampling warps
(uniform hemisphere/sphere/disk/cone/triangle, concentric disk, cosine
hemisphere, core/mc.cpp:54-161 & core/mc.h:38-47), Henyey-Greenstein phase
sampling (core/mc.cpp:162-182), the balance/power MIS heuristics
(core/mc.h:51-59), and the step-function Distribution1D
(core/mc.cpp:31-53) rebuilt as cumsum + vectorized searchsorted.
All functions map over arbitrary batch shapes.
"""
from __future__ import annotations

import jax.numpy as jnp

from . import vecmath as vm

INV_PI = jnp.float32(1.0 / jnp.pi)
INV_TWOPI = jnp.float32(1.0 / (2.0 * jnp.pi))


def uniform_sample_hemisphere(u1, u2):
    """core/mc.cpp:54-63 — z = u1, uniform in phi."""
    z = u1
    r = jnp.sqrt(jnp.maximum(1e-12, 1.0 - z * z))
    phi = 2.0 * jnp.pi * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def uniform_hemisphere_pdf():
    return INV_TWOPI


def uniform_sample_sphere(u1, u2):
    """core/mc.cpp:68-77."""
    z = 1.0 - 2.0 * u1
    r = jnp.sqrt(jnp.maximum(1e-12, 1.0 - z * z))
    phi = 2.0 * jnp.pi * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def uniform_sphere_pdf():
    return jnp.float32(1.0 / (4.0 * jnp.pi))


def uniform_sample_disk(u1, u2):
    """core/mc.cpp:82-88."""
    r = jnp.sqrt(u1)
    theta = 2.0 * jnp.pi * u2
    return r * jnp.cos(theta), r * jnp.sin(theta)


def concentric_sample_disk(u1, u2):
    """Shirley-Chiu concentric map (core/mc.cpp:89-131), branchless."""
    sx = 2.0 * u1 - 1.0
    sy = 2.0 * u2 - 1.0
    zero = (sx == 0.0) & (sy == 0.0)
    abs_sx, abs_sy = jnp.abs(sx), jnp.abs(sy)
    cond = abs_sx > abs_sy
    r = jnp.where(cond, abs_sx, abs_sy)
    # 8-sector square-to-disk map: theta/(pi/4) in [0,8) by quadrant.
    safe = lambda n, d: n / jnp.where(jnp.abs(d) < 1e-20, 1e-20, d)
    a = jnp.where(cond, safe(sy, sx), safe(sx, sy))
    theta = jnp.where(cond,
                      jnp.where(sx >= 0, a, 4.0 + a),
                      jnp.where(sy >= 0, 2.0 - a, 6.0 - a))
    theta = theta * (jnp.pi / 4.0)
    dx = jnp.where(zero, 0.0, r * jnp.cos(theta))
    dy = jnp.where(zero, 0.0, r * jnp.sin(theta))
    return dx, dy


def cosine_sample_hemisphere(u1, u2):
    """core/mc.h:38-44 — concentric disk + project up."""
    x, y = concentric_sample_disk(u1, u2)
    z = jnp.sqrt(jnp.maximum(1e-12, 1.0 - x * x - y * y))
    return jnp.stack([x, y, z], axis=-1)


def cosine_hemisphere_pdf(costheta):
    return costheta * INV_PI


def uniform_sample_cone(u1, u2, costhetamax):
    """core/mc.cpp:140-149 — uniform in the cone around +z."""
    costheta = vm.lerp(u1, 1.0, costhetamax)
    sintheta = jnp.sqrt(jnp.maximum(1e-12, 1.0 - costheta * costheta))
    phi = u2 * 2.0 * jnp.pi
    return jnp.stack(
        [jnp.cos(phi) * sintheta, jnp.sin(phi) * sintheta, costheta], axis=-1
    )


def uniform_sample_cone_frame(u1, u2, costhetamax, x, y, z):
    """core/mc.cpp:150-158 — cone sample in an explicit frame."""
    costheta = vm.lerp(u1, 1.0, costhetamax)
    sintheta = jnp.sqrt(jnp.maximum(1e-12, 1.0 - costheta * costheta))
    phi = u2 * 2.0 * jnp.pi
    return (jnp.cos(phi) * sintheta)[..., None] * x + \
           (jnp.sin(phi) * sintheta)[..., None] * y + costheta[..., None] * z


def uniform_cone_pdf(costhetamax):
    """core/mc.cpp:159-161."""
    return 1.0 / (2.0 * jnp.pi * jnp.maximum(1.0 - costhetamax, 1e-8))


def uniform_sample_triangle(u1, u2):
    """core/mc.cpp:132-139 — returns barycentric (b0, b1)."""
    su1 = jnp.sqrt(u1)
    return 1.0 - su1, u2 * su1


def sample_hg(w, g, u1, u2):
    """Henyey-Greenstein direction sampling (core/mc.cpp:162-176)."""
    g_safe = jnp.where(jnp.abs(g) < 1e-3, jnp.sign(g) * 1e-3 + (g == 0) * 1e-3, g)
    iso = jnp.abs(g) < 1e-3
    cost_iso = 1.0 - 2.0 * u1
    sqr = (1.0 - g_safe * g_safe) / (1.0 - g_safe + 2.0 * g_safe * u1)
    cost_hg = (1.0 + g_safe * g_safe - sqr * sqr) / (2.0 * g_safe)
    costheta = jnp.where(iso, cost_iso, cost_hg)
    sintheta = jnp.sqrt(jnp.maximum(1e-12, 1.0 - costheta * costheta))
    phi = 2.0 * jnp.pi * u2
    _, v1, v2 = vm.coordinate_system(w)
    return vm.spherical_direction_frame(sintheta, costheta, phi, v1, v2, w)


def hg_pdf(costheta, g):
    """Phase function value = pdf (core/volume.cpp PhaseHG)."""
    denom = 1.0 + g * g + 2.0 * g * costheta
    return (1.0 / (4.0 * jnp.pi)) * (1.0 - g * g) / jnp.maximum(
        denom * jnp.sqrt(jnp.maximum(denom, 1e-12)), 1e-12)


def balance_heuristic(nf, f_pdf, ng, g_pdf):
    """core/mc.h:51-54."""
    return (nf * f_pdf) / jnp.maximum(nf * f_pdf + ng * g_pdf, 1e-20)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """core/mc.h:55-59 — beta=2."""
    f = nf * f_pdf
    g = ng * g_pdf
    return (f * f) / jnp.maximum(f * f + g * g, 1e-20)


# ---------------------------------------------------------------------------
# Distribution1D: step-function CDF sampling (core/mc.cpp:31-53), vectorized.
# Represented as (func f32[N], cdf f32[N+1], func_int f32[]).
# ---------------------------------------------------------------------------

def distribution1d_build(func):
    """Build normalized CDF arrays from nonnegative weights f32[..., N]."""
    n = func.shape[-1]
    cdf = jnp.concatenate(
        [jnp.zeros(func.shape[:-1] + (1,), func.dtype), jnp.cumsum(func, axis=-1) / n],
        axis=-1,
    )
    func_int = cdf[..., -1]
    safe_int = jnp.where(func_int > 0, func_int, 1.0)
    cdf = cdf / safe_int[..., None]
    return func, cdf, func_int


def distribution1d_sample(func, cdf, func_int, u):
    """SampleContinuous semantics: returns (x in [0,1), pdf, index)."""
    n = func.shape[-1]
    idx = jnp.clip(jnp.searchsorted(cdf, u, side="right") - 1, 0, n - 1)
    c0 = jnp.take(cdf, idx)
    c1 = jnp.take(cdf, idx + 1)
    du = (u - c0) / jnp.maximum(c1 - c0, 1e-20)
    x = (idx.astype(jnp.float32) + du) / n
    pdf = jnp.take(func, idx) / jnp.maximum(func_int, 1e-20)
    return x, pdf, idx


def distribution1d_sample_discrete(func, cdf, func_int, u):
    """Pick index i with prob func[i]/sum; returns (i, pmf)."""
    n = func.shape[-1]
    idx = jnp.clip(jnp.searchsorted(cdf, u, side="right") - 1, 0, n - 1)
    pmf = jnp.take(func, idx) / jnp.maximum(func_int * n, 1e-20)
    return idx, pmf


# ---------------------------------------------------------------------------
# Phase functions (/root/reference/core/volume.cpp:28-56). All take
# costheta = dot(w, w') and return the phase value (sr^-1).
# ---------------------------------------------------------------------------

_INV_4PI = 1.0 / (4.0 * jnp.pi)


def phase_isotropic(costheta):
    """PhaseIsotropic (volume.cpp:28-30)."""
    return jnp.full_like(jnp.asarray(costheta, jnp.float32), _INV_4PI)


def phase_rayleigh(costheta):
    """PhaseRayleigh (volume.cpp:31-34)."""
    return 3.0 / (16.0 * jnp.pi) * (1.0 + costheta * costheta)


def phase_mie_hazy(costheta):
    """PhaseMieHazy (volume.cpp:35-38)."""
    return (0.5 + 4.5 * jnp.power(
        jnp.maximum(0.5 * (1.0 + costheta), 0.0), 8.0)) * _INV_4PI


def phase_mie_murky(costheta):
    """PhaseMieMurky (volume.cpp:39-42)."""
    return (0.5 + 16.5 * jnp.power(
        jnp.maximum(0.5 * (1.0 + costheta), 0.0), 32.0)) * _INV_4PI


def phase_schlick(costheta, g):
    """PhaseSchlick (volume.cpp:49-56): k = 1.55 g - 0.55 g^3 approximation
    of Henyey-Greenstein with an analytically invertible CDF."""
    k = 1.55 * g - 0.55 * g * g * g
    kcos = k * costheta
    return _INV_4PI * (1.0 - k * k) / jnp.maximum(
        (1.0 - kcos) * (1.0 - kcos), 1e-12)

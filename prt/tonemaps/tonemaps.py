"""Tone-mapping operators + the imaging pipeline.

Replacement for /root/reference/tonemaps/*.cpp and
ApplyImagingPipeline (core/film.cpp:30-136). The ToneMap::Map contract is
preserved: input is y = 683 * luminance, output is a per-pixel scale applied
to RGB (core/film.cpp:90-115). All batched jnp over f32[h,w].
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import rng, spectrum as spec


def contrast(y, max_display_y=100.0, display_adaptation_y=50.0):
    """TVI contrast-preserving scale (tonemaps/contrast.cpp:37-52)."""
    ywa = jnp.exp(jnp.mean(jnp.where(y > 0, jnp.log(jnp.maximum(y, 1e-12)),
                                     0.0)))
    s = jnp.power((1.219 + jnp.power(display_adaptation_y, 0.4)) /
                  (1.219 + jnp.power(ywa, 0.4)), 2.5)
    return jnp.broadcast_to(s, y.shape)


def maxwhite(y, max_display_y=100.0):
    """scale = maxDisplayY / maxY (tonemaps/maxwhite.cpp:30-41)."""
    my = jnp.max(y)
    s = jnp.where(my > 0, max_display_y / my, 1.0)
    return jnp.broadcast_to(s, y.shape)


def nonlinear(y, max_display_y=100.0, max_y=0.0):
    """Reinhard-style operator (tonemaps/nonlinear.cpp:32-50)."""
    ywa = jnp.exp(jnp.mean(jnp.where(y > 0, jnp.log(jnp.maximum(y, 1e-12)),
                                     0.0))) / 683.0
    inv_y2 = jnp.where(max_y <= 0.0, 1.0 / jnp.maximum(ywa * ywa, 1e-12),
                       1.0 / jnp.maximum(max_y * max_y, 1e-12))
    ys = y / 683.0
    return (max_display_y / 683.0) * (1.0 + ys * inv_y2) / (1.0 + ys)


def _jnd_c(y):
    """The C() just-noticeable-difference curve (tonemaps/highcontrast.cpp
    C())."""
    return jnp.where(
        y < 0.0034, y / 0.0014,
        jnp.where(y < 1.0, 2.4483 + jnp.log10(jnp.maximum(y, 1e-9) / 0.0034) / 0.4027,
                  jnp.where(y < 7.2444, 16.563 + (y - 1.0) / 0.4027,
                            32.0693 + jnp.log10(jnp.maximum(y, 1e-9) / 7.2444) / 0.0556)))


def highcontrast(y, max_display_y=100.0, n_widths=8):
    """Local-adaptation operator (tonemaps/highcontrast.cpp:51-110).

    The reference grows a pyramid-lookup radius until local contrast
    exceeds 0.5; we evaluate a fixed ladder of widths (box blurs via
    separable convolution) and select the first exceeding — same operator,
    static control flow.
    """
    h, w = y.shape
    cy_min = _jnd_c(jnp.min(y))
    cy_max = _jnd_c(jnp.max(y))

    def blur(img, radius):
        r = max(1, int(radius))
        k = jnp.ones((2 * r + 1,), jnp.float32) / (2 * r + 1)
        img2 = jax.lax.conv_general_dilated(
            img[None, None], k[None, None, :, None], (1, 1), "SAME")[0, 0]
        img2 = jax.lax.conv_general_dilated(
            img2[None, None], k[None, None, None, :], (1, 1), "SAME")[0, 0]
        return img2

    max_width_px = max(2, int(32))
    widths = [max(1, int(max_width_px * (i + 1) / n_widths))
              for i in range(n_widths)]
    blurs = [blur(y, wd) for wd in widths]
    yadapt = blurs[-1]
    chosen = jnp.zeros_like(y, bool)
    max_lc = 0.5
    for i in range(n_widths - 1):
        b0 = blurs[i]
        b1 = blurs[i + 1]
        lc = jnp.abs((b0 - b1) / jnp.maximum(b0, 1e-9))
        take = (lc > max_lc) & ~chosen
        yadapt = jnp.where(take, b0, yadapt)
        chosen = chosen | take

    t_val = max_display_y * (_jnd_c(yadapt) - cy_min) / \
        jnp.maximum(cy_max - cy_min, 1e-9)
    return t_val / jnp.maximum(yadapt, 1e-9)


TONEMAPS = {"contrast": contrast, "maxwhite": maxwhite,
            "nonlinear": nonlinear, "highcontrast": highcontrast}


def bloom(rgb, radius=0.2, weight=0.1):
    """Bloom pass (core/film.cpp:38-89): (1-d/r)^8 distance-weighted splat
    as a convolution."""
    h, w = rgb.shape[:2]
    br = max(1, int(radius * max(h, w)))
    ys, xs = jnp.meshgrid(jnp.arange(-br, br + 1), jnp.arange(-br, br + 1),
                          indexing="ij")
    dist = jnp.sqrt(ys.astype(jnp.float32) ** 2 + xs.astype(jnp.float32) ** 2)
    kern = jnp.maximum(0.0, 1.0 - dist / br) ** 8
    kern = kern / jnp.sum(kern)
    blurred = jax.lax.conv_general_dilated(
        rgb.transpose(2, 0, 1)[:, None], kern[None, None],
        window_strides=(1, 1), padding="SAME")[:, 0].transpose(1, 2, 0)
    return (1.0 - weight) * rgb + weight * blurred


def apply_imaging_pipeline(rgb, tonemap: str | None = None,
                           max_display_y=100.0, bloom_radius=0.0,
                           bloom_weight=0.2, gamma=1.0, dither=0.5,
                           max_display_value=255.0, seed=0, **tm_kwargs):
    """ApplyImagingPipeline (core/film.cpp:30-136): bloom -> tonemap scale
    on 683*luminance -> gamut desaturation -> gamma -> display scale +
    dither. Returns f32 in [0, max_display_value]."""
    out = rgb
    if bloom_radius > 0.0:
        out = bloom(out, bloom_radius, bloom_weight)
    if tonemap is not None:
        y = spec.luminance(out) * 683.0
        scale = TONEMAPS[tonemap](y, max_display_y, **tm_kwargs)
        out = out * scale[..., None]
        # Scale to [0,1] display range (film.cpp:108-115 divides by
        # maxDisplayY/683 implicitly via displayTo01).
        out = out * (683.0 / max_display_y)
    # Out-of-gamut desaturation by max-channel scale (core/film.cpp:116-122).
    m = jnp.max(out, axis=-1, keepdims=True)
    out = jnp.where(m > 1.0, out / jnp.maximum(m, 1e-9), out)
    if gamma != 1.0:
        out = jnp.power(jnp.maximum(out, 0.0), 1.0 / gamma)
    out = out * max_display_value
    if dither > 0.0:
        h, w = out.shape[:2]
        ys = jnp.broadcast_to(jnp.arange(h)[:, None], (h, w))
        xs = jnp.broadcast_to(jnp.arange(w)[None, :], (h, w))
        noise = rng.uniform(ys, xs, seed) * 2.0 - 1.0
        out = out + dither * noise[..., None]
    return jnp.clip(out, 0.0, max_display_value)

"""RGB spectra as ``f32[..., 3]`` arrays.

Replacement for Spectrum (/root/reference/core/color.{h,cpp},
COLOR_SAMPLES=3). Arithmetic is plain jnp; here we keep the conversion
constants and reductions the reference exposes: XYZ weights
(core/color.cpp:35-43), FromXYZ (core/color.cpp:44-50), luminance y().
"""
from __future__ import annotations

import jax.numpy as jnp

# XYZWeight vectors for RGB -> XYZ (reference core/color.cpp:35-43).
XWEIGHT = jnp.asarray([0.412453, 0.357580, 0.180423], jnp.float32)
YWEIGHT = jnp.asarray([0.212671, 0.715160, 0.072169], jnp.float32)
ZWEIGHT = jnp.asarray([0.019334, 0.119193, 0.950227], jnp.float32)

# FromXYZ matrix (reference core/color.cpp:44-50).
XYZ_TO_RGB = jnp.asarray(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ],
    jnp.float32,
)


def to_xyz(rgb):
    """Spectrum::XYZ (core/color.h)."""
    x = jnp.sum(rgb * XWEIGHT, axis=-1)
    y = jnp.sum(rgb * YWEIGHT, axis=-1)
    z = jnp.sum(rgb * ZWEIGHT, axis=-1)
    return jnp.stack([x, y, z], axis=-1)


def from_xyz(xyz):
    return jnp.einsum("ij,...j->...i", XYZ_TO_RGB, xyz)


def luminance(rgb):
    """Spectrum::y() — the luminance channel of XYZ."""
    return jnp.sum(rgb * YWEIGHT, axis=-1)


def is_black(rgb):
    return jnp.all(rgb == 0.0, axis=-1)


def safe_sqrt(rgb):
    return jnp.sqrt(jnp.maximum(rgb, 0.0))


def exp(rgb):
    return jnp.exp(rgb)


def clamp(rgb, lo=0.0, hi=jnp.inf):
    return jnp.clip(rgb, lo, hi)

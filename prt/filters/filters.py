"""Reconstruction filters as pure batched Evaluate(x, y) functions.

Replacement for /root/reference/filters/*.cpp (box, triangle,
gaussian, mitchell, sinc). Params dict carries xwidth/ywidth plus per-kind
extras; all formulas match the reference exactly.
"""
from __future__ import annotations

import jax.numpy as jnp

FILTER_BOX = "box"
FILTER_TRIANGLE = "triangle"
FILTER_GAUSSIAN = "gaussian"
FILTER_MITCHELL = "mitchell"
FILTER_SINC = "sinc"

DEFAULT_WIDTHS = {
    FILTER_BOX: (0.5, 0.5),
    FILTER_TRIANGLE: (2.0, 2.0),
    FILTER_GAUSSIAN: (2.0, 2.0),
    FILTER_MITCHELL: (2.0, 2.0),
    FILTER_SINC: (4.0, 4.0),
}


def evaluate(kind: str, x, y, xwidth: float, ywidth: float,
             alpha: float = 2.0, b: float = 1.0 / 3.0, c: float = 1.0 / 3.0,
             tau: float = 3.0):
    """Filter::Evaluate(x, y). x/y are offsets from the sample position."""
    if kind == FILTER_BOX:
        return jnp.ones_like(x)
    if kind == FILTER_TRIANGLE:
        return (jnp.maximum(0.0, xwidth - jnp.abs(x)) *
                jnp.maximum(0.0, ywidth - jnp.abs(y)))
    if kind == FILTER_GAUSSIAN:
        # e^{-a d^2} - e^{-a w^2}, clamped (filters/gaussian.cpp:48-55).
        expx = jnp.exp(-alpha * xwidth * xwidth)
        expy = jnp.exp(-alpha * ywidth * ywidth)
        gx = jnp.maximum(0.0, jnp.exp(-alpha * x * x) - expx)
        gy = jnp.maximum(0.0, jnp.exp(-alpha * y * y) - expy)
        return gx * gy
    if kind == FILTER_MITCHELL:
        return _mitchell1d(x / xwidth, b, c) * _mitchell1d(y / ywidth, b, c)
    if kind == FILTER_SINC:
        return _sinc1d(x / xwidth, tau) * _sinc1d(y / ywidth, tau)
    raise ValueError(f"unknown filter {kind}")


def _mitchell1d(x, b, c):
    """filters/mitchell.cpp:48-57."""
    x = jnp.abs(2.0 * x)
    big = ((-b - 6 * c) * x * x * x + (6 * b + 30 * c) * x * x +
           (-12 * b - 48 * c) * x + (8 * b + 24 * c)) * (1.0 / 6.0)
    small = ((12 - 9 * b - 6 * c) * x * x * x +
             (-18 + 12 * b + 6 * c) * x * x + (6 - 2 * b)) * (1.0 / 6.0)
    return jnp.where(x > 2.0, 0.0, jnp.where(x > 1.0, big, small))


def _sinc1d(x, tau):
    """Lanczos-windowed sinc (filters/sinc.cpp:41-56)."""
    x = jnp.abs(x)
    s = jnp.sin(jnp.pi * x * tau) / jnp.maximum(jnp.pi * x * tau, 1e-9)
    lanczos = jnp.sin(jnp.pi * x) / jnp.maximum(jnp.pi * x, 1e-9)
    val = s * lanczos
    val = jnp.where(x < 1e-5, 1.0, val)
    return jnp.where(x > 1.0, 0.0, val)

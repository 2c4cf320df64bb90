"""Host-side MIP pyramid construction.

Replacement for the MIPMap constructor
(/root/reference/core/mipmap.h:93-161): non-power-of-two images are
resampled up to the next power of two with the Lanczos-windowed sinc
(core/mipmap.h:115-141), then the pyramid is built by 2x2 box reduction
down to 1x1. Pure numpy; runs once at scene build.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..textures.graph import lanczos_np


def _round_up_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def _resample_axis(img: np.ndarray, new_n: int, axis: int) -> np.ndarray:
    """1D Lanczos resample along axis (filter width 2, matching the
    reference's ResampleWeights 4-tap kernel)."""
    old_n = img.shape[axis]
    if old_n == new_n:
        return img
    filterwidth = 2.0
    out_idx = np.arange(new_n)
    center = (out_idx + 0.5) * old_n / new_n
    first = np.floor(center - filterwidth + 0.5).astype(np.int64)
    offs = np.arange(4)
    idx = first[:, None] + offs[None, :]          # [new_n, 4]
    pos = idx + 0.5
    w = lanczos_np((pos - center[:, None]) / filterwidth)
    wsum = w.sum(axis=1, keepdims=True)
    w = w / np.maximum(wsum, 1e-8)
    idx = np.clip(idx, 0, old_n - 1)
    moved = np.moveaxis(img, axis, 0)             # [old_n, ...]
    taps = moved[idx]                             # [new_n, 4, ...]
    extra = (1,) * (taps.ndim - 2)
    res = (taps * w.reshape(w.shape + extra)).sum(axis=1)
    return np.moveaxis(res, 0, axis)


def build_pyramid(rgb: np.ndarray) -> Tuple[np.ndarray, ...]:
    """f32[h,w,3] -> tuple of pow2 levels down to 1x1."""
    img = np.asarray(rgb, np.float32)
    h, w = img.shape[:2]
    ph, pw = _round_up_pow2(h), _round_up_pow2(w)
    if (ph, pw) != (h, w):
        img = _resample_axis(img, pw, 1)
        img = _resample_axis(img, ph, 0)
    levels = [img]
    while img.shape[0] > 1 or img.shape[1] > 1:
        # Rectangular pyramids: an axis already at 1 stops reducing
        # (mipmap.h nLevels = 1 + log2(max(w,h))).
        fh = 2 if img.shape[0] > 1 else 1
        fw = 2 if img.shape[1] > 1 else 1
        nh, nw = img.shape[0] // fh, img.shape[1] // fw
        img = img[: nh * fh, : nw * fw].reshape(nh, fh, nw, fw, -1).mean((1, 3))
        levels.append(img.astype(np.float32))
    return tuple(levels)

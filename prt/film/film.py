"""Image film: filtered sample splatting via scatter-add.

Replacement for ImageFilm (/root/reference/film/image.cpp).
AddSample's filter-table splat over the support window
(film/image.cpp:103-147) becomes a fixed-window scatter-add: each sample
contributes to a static window of pixel positions with filter weights
evaluated exactly (no 16x16 table quantization — we can afford the real
filter elementwise). WriteImage's XYZ->RGB + weight normalization
(film/image.cpp:157-212) becomes `develop`.

Performance: the accumulator is ONE f32[yres, xres, 5] buffer
(R,G,B, alpha, weightSum) so each splat window position is a single
scatter-add of a [N,5] payload into the flattened image (atomic adds on
a GPU, so their order varies from run to run) — fewer scatter ops than
the earlier 3-buffers x (2*ceil(w)+1)^2 layout (27 scatter ops for a box
filter). The window is also the tight floor(2w)+1 bound on pixels a filter
of width w can touch, so the default box filter does 4 scatters, not 27.

The film accumulator is a pytree so it shards over devices; merging shards
is a psum (the reference's manual exrassemble flow, automated).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..core.pytree import pytree_dataclass, static
from ..filters import filters as ftr


@pytree_dataclass
class Film:
    # f32[yres, xres, 5]: weighted R,G,B, weighted alpha, weight sum.
    data: jnp.ndarray
    xres: int = static(default=0)
    yres: int = static(default=0)
    # Crop window in NDC [x0,x1,y0,y1] (film/image.cpp:79-85).
    crop: tuple = static(default=(0.0, 1.0, 0.0, 1.0))

    # Legacy views (checkpoints, shard psum helpers, tests).
    @property
    def pixels(self):
        return self.data[..., 0:3]

    @property
    def alpha(self):
        return self.data[..., 3]

    @property
    def weight_sum(self):
        return self.data[..., 4]


def make_film(xres, yres, crop=(0.0, 1.0, 0.0, 1.0)) -> Film:
    return Film(data=jnp.zeros((yres, xres, 5), jnp.float32),
                xres=xres, yres=yres, crop=crop)


def from_planes(pixels, alpha, weight_sum, xres, yres,
                crop=(0.0, 1.0, 0.0, 1.0)) -> Film:
    """Assemble a Film from separate (pixels, alpha, weight) planes."""
    data = jnp.concatenate(
        [jnp.asarray(pixels, jnp.float32),
         jnp.asarray(alpha, jnp.float32)[..., None],
         jnp.asarray(weight_sum, jnp.float32)[..., None]], axis=-1)
    return Film(data=data, xres=xres, yres=yres, crop=crop)


def pixel_extent(film: Film):
    """Crop-window pixel bounds (xstart, xcount, ystart, ycount)."""
    x0, x1, y0, y1 = film.crop
    xstart = math.ceil(film.xres * x0)
    xcount = max(1, math.ceil(film.xres * x1) - xstart)
    ystart = math.ceil(film.yres * y0)
    ycount = max(1, math.ceil(film.yres * y1) - ystart)
    return xstart, xcount, ystart, ycount


def add_samples(film: Film, image_x, image_y, L, alpha,
                filter_kind: str, xwidth: float, ywidth: float,
                **filter_kw) -> Film:
    """Filtered splat of a sample batch (film/image.cpp:103-147 semantics:
    discrete pixel coords are continuous-0.5)."""
    dx = image_x - 0.5
    dy = image_y - 0.5

    H, W = film.data.shape[0], film.data.shape[1]
    if filter_kind == ftr.FILTER_BOX and xwidth <= 0.5 and ywidth <= 0.5:
        # A half-pixel box touches exactly the sample's own pixel
        # floor(image_x). DOCUMENTED DIVERGENCE (ADVICE r3): at exactly-
        # integral image_x the reference (image.cpp AddSample,
        # x0=Ceil2Int(dx-0.5)..x1=Floor2Int(dx+0.5)) splats the sample
        # into BOTH adjacent pixels' (Lw, w) accumulators, while this
        # fast path credits only floor(image_x). The case is measure-zero
        # for jittered samplers but systematic for zero-offset
        # deterministic patterns; both are valid box-filter estimators,
        # and we keep the single-scatter (1 op vs 4) intentionally.
        px = jnp.floor(image_x).astype(jnp.int32)
        py = jnp.floor(image_y).astype(jnp.int32)
        inside = (px >= 0) & (px < W) & (py >= 0) & (py < H)
        w = jnp.where(inside, 1.0, 0.0)
        idx = jnp.clip(py, 0, H - 1) * W + jnp.clip(px, 0, W - 1)
        payload = jnp.concatenate(
            [w[..., None] * L, (w * alpha)[..., None], w[..., None]],
            axis=-1)
        flat = film.data.reshape(H * W, 5).at[idx].add(payload)
        return Film(data=flat.reshape(H, W, 5), xres=film.xres,
                    yres=film.yres, crop=film.crop)

    x0 = jnp.ceil(dx - xwidth).astype(jnp.int32)
    y0 = jnp.ceil(dy - ywidth).astype(jnp.int32)
    # Tight pixel-count bound: integers in [dx-w, dx+w] number at most
    # floor(2w)+1 (2 for the default half-pixel box, 5 for width-2 filters).
    nx = int(math.floor(2.0 * xwidth)) + 1
    ny = int(math.floor(2.0 * ywidth)) + 1

    flat = film.data.reshape(H * W, 5)

    for j in range(ny):
        for i in range(nx):
            px = x0 + i
            py = y0 + j
            fx = px.astype(jnp.float32) - dx
            fy = py.astype(jnp.float32) - dy
            w = ftr.evaluate(filter_kind, fx, fy, xwidth, ywidth, **filter_kw)
            inside = (jnp.abs(fx) <= xwidth) & (jnp.abs(fy) <= ywidth) & \
                (px >= 0) & (px < W) & (py >= 0) & (py < H)
            w = jnp.where(inside, w, 0.0)
            idx = jnp.clip(py, 0, H - 1) * W + jnp.clip(px, 0, W - 1)
            payload = jnp.concatenate(
                [w[..., None] * L, (w * alpha)[..., None], w[..., None]],
                axis=-1)
            flat = flat.at[idx].add(payload)
    return Film(data=flat.reshape(H, W, 5), xres=film.xres,
                yres=film.yres, crop=film.crop)


def develop(film: Film, premultiply_alpha: bool = True):
    """WriteImage normalization (film/image.cpp:157-212): weight divide (the
    reference converts through XYZ and back with the same matrices — a
    no-op for in-gamut RGB, so we divide directly). Returns (rgb, alpha)."""
    w = jnp.maximum(film.data[..., 4], 1e-10)[..., None]
    rgb = film.data[..., 0:3] / w
    alpha = jnp.clip(film.data[..., 3:4] / w, 0.0, 1.0)[..., 0]
    if premultiply_alpha:
        pass  # stored unpremultiplied; EXR writer applies if requested
    return rgb, alpha


@jax.jit
def to_half(rgb, alpha):
    """Final-image transport quantization (RenderOptions.half_readback):
    clip-to-f16 on device, matching the HALF precision of the reference's
    EXR output (core/exrio.cpp) while halving host-transfer bytes."""
    return (jnp.clip(rgb, 0.0, 65504.0).astype(jnp.float16),
            alpha.astype(jnp.float16))


def merge(films):
    """Sum-merge accumulator shards (tools/exrassemble.cpp, automated)."""
    out = films[0]
    for f in films[1:]:
        out = Film(data=out.data + f.data,
                   xres=out.xres, yres=out.yres, crop=out.crop)
    return out

"""Deterministic, order-invariant sample generation.

Replacement for /root/reference/samplers/*.cpp. The reference's
stateful `Sampler::GetNextSample` loop becomes a pure function of
(pixel, sample index): every camera-sample dimension (image/lens/time) and
every integrator dimension is derived from counter-based hashes or
per-pixel-scrambled low-discrepancy sequences, so any shard of the sample
space can be generated independently on any device.

Kinds:
  stratified  — jittered strata (samplers/stratified.cpp:51-131); image
                strata are the (sx,sy) sub-grid of spp = xs*ys, lens/time
                use shuffled strata realized as scrambled per-pixel orders.
  random      — pure hash uniforms (samplers/random.cpp).
  lowdiscrepancy — per-pixel scrambled (0,2)-sequences
                (samplers/lowdiscrepancy.cpp:76-128).
  bestcandidate — the baked 4096-entry 5D best-candidate table
                (samplers/bestcandidate.cpp:60-156 semantics; table
                generated by bc_gen.py, the samplepat tool analogue):
                the image tiles into sqrt(T/spp)-pixel squares, each
                covered by the whole table; a pixel's s-th sample is the
                s-th table entry landing in it (host-precomputed map);
                time/lens take the entry's values toroidally shifted per
                tile. Cells the blue-noise pattern left short of spp
                entries fall back to (0,2)-sequence samples.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core import rng


class SamplerConfig(NamedTuple):
    kind: str = "stratified"          # stratified|random|lowdiscrepancy|bestcandidate
    xsamples: int = 2
    ysamples: int = 2
    jitter: bool = True
    pixelsamples: int = 4             # LD / random / bestcandidate


def round_size(cfg: SamplerConfig, n: int) -> int:
    """Sampler::RoundSize — LD rounds to pow2 (lowdiscrepancy.cpp:44-46)."""
    if cfg.kind in ("lowdiscrepancy", "bestcandidate"):
        p = 1
        while p < n:
            p *= 2
        return p
    return n


def samples_per_pixel(cfg: SamplerConfig) -> int:
    if cfg.kind == "stratified":
        return cfg.xsamples * cfg.ysamples
    if cfg.kind in ("lowdiscrepancy", "bestcandidate"):
        return round_size(cfg, cfg.pixelsamples)
    return cfg.pixelsamples


def _pixel_hash(px, py, seed=0):
    return rng.hash_u32(px, py, seed, 0xC0FFEE)


def camera_samples(cfg: SamplerConfig, px, py, s_idx, seed=0):
    """Camera-sample dimensions for lanes (px, py, sample index).

    Returns dict(image_x, image_y, lens_u, lens_v, time).
    """
    ph = _pixel_hash(px, py, seed)
    fx = px.astype(jnp.float32)
    fy = py.astype(jnp.float32)

    if cfg.kind == "stratified":
        xs, ys = cfg.xsamples, cfg.ysamples
        sx = (s_idx % xs).astype(jnp.float32)
        sy = (s_idx // xs).astype(jnp.float32)
        if cfg.jitter:
            jx = rng.uniform(ph, s_idx, 0)
            jy = rng.uniform(ph, s_idx, 1)
        else:
            jx = jy = jnp.full(px.shape, 0.5, jnp.float32)
        image_x = fx + (sx + jx) / xs
        image_y = fy + (sy + jy) / ys
        # Lens/time: per-pixel-shuffled strata (decorrelated from image).
        perm_l = _strat_shuffled(ph, s_idx, xs * ys, 2)
        perm_t = _strat_shuffled(ph, s_idx, xs * ys, 3)
        if cfg.jitter:
            lens_u = (perm_l + rng.uniform(ph, s_idx, 4)) / (xs * ys)
            lens_v = (perm_t + rng.uniform(ph, s_idx, 5)) / (xs * ys)
            time = (perm_l + rng.uniform(ph, s_idx, 6)) / (xs * ys)
        else:
            lens_u = (perm_l + 0.5) / (xs * ys)
            lens_v = (perm_t + 0.5) / (xs * ys)
            time = (perm_l + 0.5) / (xs * ys)
        return dict(image_x=image_x, image_y=image_y, lens_u=lens_u,
                    lens_v=lens_v, time=time)

    if cfg.kind == "random":
        return dict(
            image_x=fx + rng.uniform(ph, s_idx, 0),
            image_y=fy + rng.uniform(ph, s_idx, 1),
            lens_u=rng.uniform(ph, s_idx, 2),
            lens_v=rng.uniform(ph, s_idx, 3),
            time=rng.uniform(ph, s_idx, 4),
        )

    if cfg.kind == "bestcandidate":
        spp = samples_per_pixel(cfg)
        tw, emap, efall, tab = _bc_tables(spp)
        cx = (px % tw).astype(jnp.int32)
        cy = (py % tw).astype(jnp.int32)
        cell = cy * tw + cx
        si = jnp.clip(s_idx, 0, emap.shape[1] - 1)
        e = emap[cell, si]
        fall = efall[cell, si]
        row = tab[e]
        # Per-tile toroidal shifts for the non-image dims
        # (bestcandidate.cpp:121-136 sampleOffsets + WRAP).
        th = rng.hash_u32((px // tw).astype(jnp.int32),
                          (py // tw).astype(jnp.int32), seed, 0xBC)
        zero = jnp.zeros_like(fx, dtype=jnp.int32)

        def wrap(v):
            return jnp.where(v > 1.0, v - 1.0, v)

        tm_bc = wrap(row[..., 2] + rng.uniform(th, zero, 0))
        lu_bc = wrap(row[..., 3] + rng.uniform(th, zero, 1))
        lv_bc = wrap(row[..., 4] + rng.uniform(th, zero, 2))
        ix_f, iy_f = rng.ld_shuffled_2d(s_idx, ph, 0)
        lu_f, lv_f = rng.ld_shuffled_2d(s_idx, ph, 1)
        tm_f = rng.ld_shuffled_1d(s_idx, ph, 2)
        # Entry image position lands inside this pixel by construction
        # (cell = floor(table_xy * tw)).
        ex = (px - cx).astype(jnp.float32) + row[..., 0] * tw
        ey = (py - cy).astype(jnp.float32) + row[..., 1] * tw
        return dict(
            image_x=jnp.where(fall, fx + ix_f, ex),
            image_y=jnp.where(fall, fy + iy_f, ey),
            lens_u=jnp.where(fall, lu_f, lu_bc),
            lens_v=jnp.where(fall, lv_f, lv_bc),
            time=jnp.where(fall, tm_f, tm_bc))

    # Low-discrepancy: scrambled (0,2)-sequences.
    ix, iy = rng.ld_shuffled_2d(s_idx, ph, 0)
    lu, lv = rng.ld_shuffled_2d(s_idx, ph, 1)
    tm = rng.ld_shuffled_1d(s_idx, ph, 2)
    return dict(image_x=fx + ix, image_y=fy + iy, lens_u=lu, lens_v=lv,
                time=tm)


_BC_CACHE = {}


def _bc_tables(spp: int):
    """Host-precomputed (tile width, cell->entry map, fallback mask,
    table) for the best-candidate sampler at a given spp."""
    got = _BC_CACHE.get(spp)
    if got is not None:
        return got
    import math
    import numpy as np
    from . import bc_gen
    t = bc_gen.load_table()
    n = len(t)
    tw = max(int(round(math.sqrt(n / max(spp, 1)))), 1)
    cells = np.minimum((t[:, 0:2] * tw).astype(np.int64), tw - 1)
    cell_id = cells[:, 1] * tw + cells[:, 0]
    emap = np.zeros((tw * tw, spp), np.int32)
    efall = np.ones((tw * tw, spp), bool)
    fill = np.zeros(tw * tw, np.int32)
    for e, c in enumerate(cell_id):
        k = fill[c]
        if k < spp:
            emap[c, k] = e
            efall[c, k] = False
            fill[c] += 1
    got = (tw, jnp.asarray(emap), jnp.asarray(efall),
           jnp.asarray(t.astype(np.float32)))
    _BC_CACHE[spp] = got
    return got


def _strat_shuffled(ph, s_idx, n, dim):
    """Pseudo-random permutation value: hash-based Feistel-lite shuffle of
    s_idx within [0, n) keyed on (pixel, dim)."""
    k = rng.hash_u32(ph, dim, 0x5EED)
    x = s_idx.astype(jnp.uint32)
    for r in range(3):
        x = (x + k) % jnp.uint32(max(n, 1))
        x = (x * jnp.uint32(2654435761) + rng.hash_u32(k, r)) % jnp.uint32(max(n, 1))
    return x.astype(jnp.float32)


def integrator_1d(cfg: SamplerConfig, px, py, s_idx, bounce, purpose, seed=0):
    """One integrator-requested 1D sample (Sample::oneD analogue)."""
    ph = _pixel_hash(px, py, seed)
    dim = rng.hash_u32(bounce, purpose, 0x1D)
    if cfg.kind in ("lowdiscrepancy", "bestcandidate", "stratified"):
        return rng.ld_shuffled_1d(s_idx, ph, dim)
    return rng.uniform(ph, s_idx, dim)


def integrator_2d(cfg: SamplerConfig, px, py, s_idx, bounce, purpose, seed=0):
    """One integrator-requested 2D sample (Sample::twoD analogue)."""
    ph = _pixel_hash(px, py, seed)
    dim = rng.hash_u32(bounce, purpose, 0x2D)
    if cfg.kind in ("lowdiscrepancy", "bestcandidate", "stratified"):
        return rng.ld_shuffled_2d(s_idx, ph, dim)
    return rng.uniform(ph, s_idx, dim, 0), rng.uniform(ph, s_idx, dim, 1)

"""Camera ray generation: perspective, orthographic, environment.

Replacement for /root/reference/cameras/*.cpp and the
ProjectiveCamera scaffolding (core/camera.cpp:50-78). The raster->camera
matrix chain is assembled on the host at scene build (build_projective);
`generate_rays` is pure batched device math over f32[N] raster coordinates,
including thin-lens depth of field (cameras/perspective.cpp:60-77) and
shutter-time lerp. Ray weight is always 1 (cameras/perspective.cpp:81).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core import mc, transform as tf, vecmath as vm
from ..scene.data import (
    CAMERA_ENVIRONMENT, CAMERA_ORTHOGRAPHIC, CAMERA_PERSPECTIVE, CameraData,
)


def default_screen_window(xres: int, yres: int, frameaspect=None):
    """Screen window from frame aspect ratio (core/api.cpp camera defaults)."""
    aspect = frameaspect if frameaspect is not None else xres / yres
    if aspect > 1.0:
        return [-aspect, aspect, -1.0, 1.0]
    return [-1.0, 1.0, -1.0 / aspect, 1.0 / aspect]


def build_projective(kind, cam2world, cam2screen, screen, xres, yres,
                     hither=1e-3, yon=1e30, shutteropen=0.0, shutterclose=1.0,
                     lensradius=0.0, focaldistance=1e30) -> CameraData:
    """Host-side matrix chain mirroring core/camera.cpp:60-78."""
    s0, s1, s2, s3 = screen
    screen2raster = (
        np.diag([xres, yres, 1.0, 1.0]) @
        np.diag([1.0 / (s1 - s0), 1.0 / (s2 - s3), 1.0, 1.0]) @
        np.array([[1, 0, 0, -s0], [0, 1, 0, -s3], [0, 0, 1, 0], [0, 0, 0, 1.0]])
    ).astype(np.float32)
    raster2screen = np.linalg.inv(screen2raster)
    raster2cam = np.linalg.inv(np.asarray(cam2screen)) @ raster2screen
    c2w = np.asarray(cam2world, np.float32)
    return CameraData(
        kind=kind,
        cam2world=jnp.asarray(c2w),
        world2cam=jnp.asarray(np.linalg.inv(c2w).astype(np.float32)),
        raster2cam=jnp.asarray(raster2cam.astype(np.float32)),
        cam2screen=jnp.asarray(np.asarray(cam2screen, np.float32)),
        lens_radius=jnp.float32(lensradius),
        focal_distance=jnp.float32(focaldistance),
        shutter_open=jnp.float32(shutteropen),
        shutter_close=jnp.float32(shutterclose),
        cliphither=float(hither),
        clipyon=float(yon),
    )


def build_environment(cam2world, xres, yres, hither=1e-3, yon=1e30,
                      shutteropen=0.0, shutterclose=1.0) -> CameraData:
    c2w = np.asarray(cam2world, np.float32)
    return CameraData(
        kind=CAMERA_ENVIRONMENT,
        cam2world=jnp.asarray(c2w),
        world2cam=jnp.asarray(np.linalg.inv(c2w).astype(np.float32)),
        raster2cam=jnp.eye(4, dtype=jnp.float32),
        cam2screen=jnp.eye(4, dtype=jnp.float32),
        lens_radius=jnp.float32(0.0),
        focal_distance=jnp.float32(1e30),
        shutter_open=jnp.float32(shutteropen),
        shutter_close=jnp.float32(shutterclose),
        cliphither=float(hither),
        clipyon=float(yon),
    )


def generate_rays(cam: CameraData, image_x, image_y, lens_u, lens_v, time_u,
                  xres: int, yres: int):
    """Batched GenerateRay. Returns (o, d, mint, maxt, time) world-space.

    image_x/image_y are continuous raster coordinates (pixel + jitter).
    """
    n = image_x.shape[0]
    zeros = jnp.zeros((n,), jnp.float32)

    if cam.kind == CAMERA_ENVIRONMENT:
        # cameras/environment.cpp:47-61 — note the y-up spherical convention.
        theta = jnp.pi * image_y / yres
        phi = 2.0 * jnp.pi * image_x / xres
        st, ct = jnp.sin(theta), jnp.cos(theta)
        d_cam = jnp.stack([st * jnp.cos(phi), ct, st * jnp.sin(phi)], axis=-1)
        o_cam = jnp.zeros((n, 3), jnp.float32)
        o_w = tf.apply_point(cam.cam2world, o_cam)
        d_w = tf.apply_vector(cam.cam2world, d_cam)
        mint = jnp.full((n,), cam.cliphither, jnp.float32)
        maxt = jnp.full((n,), min(cam.clipyon, 1e30), jnp.float32)
    else:
        p_ras = jnp.stack([image_x, image_y, zeros], axis=-1)
        p_cam = tf.apply_point(cam.raster2cam, p_ras)
        if cam.kind == CAMERA_PERSPECTIVE:
            o_cam = jnp.zeros((n, 3), jnp.float32)
            d_cam = p_cam
        else:  # orthographic (cameras/orthographic.cpp:48-79)
            o_cam = p_cam
            d_cam = jnp.broadcast_to(
                jnp.asarray([0.0, 0.0, 1.0], jnp.float32), (n, 3))

        # Thin-lens DOF (cameras/perspective.cpp:60-77).
        has_lens = cam.lens_radius > 0.0
        lu, lv = mc.concentric_sample_disk(lens_u, lens_v)
        lu = lu * cam.lens_radius
        lv = lv * cam.lens_radius
        dz = jnp.where(jnp.abs(d_cam[..., 2]) < 1e-12, 1e-12, d_cam[..., 2])
        ft = (cam.focal_distance - cam.cliphither) / dz
        p_focus = o_cam + ft[..., None] * d_cam
        scale = (cam.focal_distance - cam.cliphither) / jnp.maximum(
            cam.focal_distance, 1e-12)
        o_lens = o_cam + jnp.stack([lu * scale, lv * scale, zeros], axis=-1)
        d_lens = p_focus - o_lens
        o_cam = jnp.where(has_lens, o_lens, o_cam)
        d_cam = jnp.where(has_lens, d_lens, d_cam)

        d_cam = vm.normalize(d_cam)
        dz = jnp.where(jnp.abs(d_cam[..., 2]) < 1e-12, 1e-12, d_cam[..., 2])
        mint = jnp.zeros((n,), jnp.float32)
        maxt = (min(cam.clipyon, 1e30) - cam.cliphither) / dz
        o_w = tf.apply_point(cam.cam2world, o_cam)
        d_w = tf.apply_vector(cam.cam2world, d_cam)

    time = vm.lerp(time_u, cam.shutter_open, cam.shutter_close)
    return o_w, d_w, mint, maxt, time

"""Photon mapping (integrators/photonmap.cpp): emission sampling power,
direct-map density estimation vs exact direct lighting, caustic
classification under a glass sphere, and indirect agreement with the path
tracer in a closed box."""
import numpy as np
import jax.numpy as jnp

from prt import render as R
from prt.cameras import cameras as cam
from prt.core import transform as tf
from prt.integrators import photonmap as pm
from prt.lights import emission
from prt.samplers import samplers as smp
from prt.scene.build import SceneBuilder


def _floor_scene(xres=24, yres=24, extra=None):
    b = SceneBuilder()
    mat = b.matte(kd=(0.6, 0.6, 0.6))
    s = 20.0
    P = np.asarray([[-s, 0, -s], [-s, 0, s], [s, 0, s], [s, 0, -s]],
                   np.float32)
    b.add_trianglemesh(np.eye(4), [[0, 1, 2], [0, 2, 3]], P, material=mat)
    b.add_point_light(np.asarray(tf.translate([0, 4, 0])),
                      intensity=(100.0,) * 3)
    if extra:
        extra(b)
    c2w = np.asarray(tf.look_at([0, 3, -4], [0, 0, 0], [0, 1, 0]))
    b.set_camera(cam.build_projective(
        0, c2w, np.asarray(tf.perspective(50.0, 1e-2, 1000.0)),
        cam.default_screen_window(xres, yres), xres, yres))
    return b.build()


def test_emission_power_point_light():
    """E[Le/pdf] over emission samples = total power (4*pi*I for a point
    light, point.cpp:70-77)."""
    scene = _floor_scene()
    rng_ = np.random.default_rng(11)
    N = 8192
    us = [jnp.asarray(rng_.random(N, np.float32)) for _ in range(5)]
    lid = jnp.zeros((N,), jnp.int32)
    em = emission.sample_emission(scene, lid, *us)
    power = float((np.asarray(em["Le"])[:, 0] /
                   np.maximum(np.asarray(em["pdf"]), 1e-20)).mean())
    np.testing.assert_allclose(power, 4 * np.pi * 100.0, rtol=1e-3)


def test_direct_map_matches_exact_direct():
    """Rendering with directwithphotons must match the analytic direct
    lighting (whitted) on a diffuse floor — validates shooting energy,
    grid-hash lookup, the density-estimate normalization, and the
    sparsification rescale end-to-end."""
    xres = yres = 20
    scene = _floor_scene(xres, yres)
    scfg = smp.SamplerConfig(kind="lowdiscrepancy", pixelsamples=4)
    common = dict(xres=xres, yres=yres, sampler=scfg,
                  chunk_size=xres * yres * 4)
    img_w, _ = R.render(scene, R.RenderOptions(integrator="whitted",
                                               **common))
    prm = pm.PhotonParams(caustic=0, direct=120000, indirect=0,
                          batch=32768, max_dist=0.25,
                          direct_with_photons=True, final_gather=False)
    img_p, _ = R.render(scene, R.RenderOptions(integrator="photonmap",
                                               photon=prm, **common))
    m = img_w.mean(-1) > 1e-4
    rel = np.abs(img_p - img_w)[m] / np.maximum(img_w[m], 1e-3)
    assert rel.mean() < 0.08, rel.mean()
    assert abs(img_p[m].mean() / img_w[m].mean() - 1.0) < 0.05


def test_caustic_photons_under_glass_sphere():
    """Photons refracted through a glass sphere are specular-path photons
    and must land concentrated beneath it (photonmap.cpp:236-246)."""
    def extra(b):
        glass = b.glass(index=1.5)
        b.add_sphere(np.asarray(tf.translate([0, 1.0, 0])), radius=0.8,
                     material=glass)

    scene = _floor_scene(extra=extra)
    prm = pm.PhotonParams(caustic=4000, direct=0, indirect=0,
                          batch=32768, max_dist=0.1, max_shot=500000)
    maps = pm.build_maps(scene, prm, seed=0)
    assert maps.caustic.count > 1000, maps.caustic.count
    p = np.asarray(maps.caustic.p)[: maps.caustic.count]
    al = np.asarray(maps.caustic.alpha)[: maps.caustic.count].mean(-1)
    horiz = np.sqrt(p[:, 0] ** 2 + p[:, 2] ** 2)
    # Light above the sphere focuses transmitted photons under it.
    # ALPHA-weighted fraction: bucket sparsification (photon_grid.py)
    # RR-thins dense spots but scales the kept photons' alpha, so the
    # power distribution — the estimator-level invariant — is preserved
    # while raw point counts are not.
    frac_near = float(al[horiz < 1.2].sum() / max(al.sum(), 1e-9))
    assert frac_near > 0.5, frac_near


def _box_scene(xres, yres):
    """Closed diffuse box (indirect bounces cannot escape)."""
    b = SceneBuilder()
    white = b.matte(kd=(0.6, 0.6, 0.6))
    red = b.matte(kd=(0.6, 0.15, 0.15))
    s = 1.0
    # 6 walls, normals inward.
    quads = [
        ([[-s, -s, -s], [-s, -s, s], [s, -s, s], [s, -s, -s]], white),  # floor
        ([[-s, s, -s], [s, s, -s], [s, s, s], [-s, s, s]], white),      # ceil
        ([[-s, -s, s], [-s, s, s], [s, s, s], [s, -s, s]], white),      # back
        ([[-s, -s, -s], [s, -s, -s], [s, s, -s], [-s, s, -s]], white),  # front
        ([[-s, -s, -s], [-s, s, -s], [-s, s, s], [-s, -s, s]], red),    # left
        ([[s, -s, -s], [s, -s, s], [s, s, s], [s, s, -s]], red),        # right
    ]
    for P, m in quads:
        b.add_trianglemesh(np.eye(4), [[0, 1, 2], [0, 2, 3]],
                           np.asarray(P, np.float32), material=m)
    b.add_point_light(np.asarray(tf.translate([0, 0.7, 0])),
                      intensity=(1.0,) * 3)
    c2w = np.asarray(tf.look_at([0, 0, -0.9], [0, 0, 1], [0, 1, 0]))
    b.set_camera(cam.build_projective(
        0, c2w, np.asarray(tf.perspective(70.0, 1e-2, 100.0)),
        cam.default_screen_window(xres, yres), xres, yres))
    return b.build()


def test_photonmap_agrees_with_path_tracer():
    """In a closed diffuse box, photonmap (exact direct sampling + indirect
    map) must agree with the path tracer in the mean."""
    xres = yres = 16
    scene = _box_scene(xres, yres)
    common = dict(xres=xres, yres=yres, chunk_size=xres * yres * 16)
    img_path, _ = R.render(scene, R.RenderOptions(
        integrator="path", max_depth=6,
        sampler=smp.SamplerConfig(kind="lowdiscrepancy", pixelsamples=16),
        **common))
    prm = pm.PhotonParams(caustic=0, direct=0, indirect=60000,
                          batch=32768, max_dist=0.2, final_gather=False)
    img_pm, _ = R.render(scene, R.RenderOptions(
        integrator="photonmap", photon=prm, max_depth=3,
        sampler=smp.SamplerConfig(kind="lowdiscrepancy", pixelsamples=4),
        **common))
    # Means agree within MC + density-estimation tolerance.
    ratio = img_pm.mean() / img_path.mean()
    assert abs(ratio - 1.0) < 0.15, ratio

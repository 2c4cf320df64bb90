"""Wavefront path regeneration (stream compaction; SURVEY.md step 3,
VERDICT round-1 item 7) must reproduce the scan integrator exactly:
random streams are keyed on (pixel, sample, bounce), never lane position,
so regeneration changes scheduling but not any sample's estimate."""
import numpy as np
import pytest

from prt.scene.parser import load_scene_string
from prt import render as R
from prt.integrators import path_wavefront
from prt.utils.stats import StatsRegistry


CORNELL = """
Film "image" "integer xresolution" [40] "integer yresolution" [40]
Camera "perspective" "float fov" [55]
Sampler "lowdiscrepancy" "integer pixelsamples" [2]
SurfaceIntegrator "path" "integer maxdepth" [4]
WorldBegin
AttributeBegin
  AreaLightSource "area" "color L" [8 8 8]
  Translate 0 1.9 3
  Shape "sphere" "float radius" [0.3]
AttributeEnd
Material "matte" "color Kd" [0.7 0.7 0.7]
Translate 0 0 3
Shape "sphere" "float radius" [1000] "float zmin" [-1002] "float zmax" [-998]
AttributeBegin
  Material "matte" "color Kd" [0.2 0.6 0.3]
  Translate 0 -0.5 0
  Shape "sphere" "float radius" [0.7]
AttributeEnd
AttributeBegin
  Material "mirror"
  Translate 1.2 -0.3 -0.5
  Shape "sphere" "float radius" [0.45]
AttributeEnd
WorldEnd
"""


def _scene():
    scene, opts = load_scene_string(CORNELL)
    return scene, opts


def test_wavefront_matches_scan_exactly():
    scene, opts = _scene()
    opts = opts._replace(integrator="path", filter_kind="box",
                         filter_xwidth=0.5, filter_ywidth=0.5,
                         chunk_size=1024)
    rgb_scan, alpha_scan = R.render(scene, opts._replace(driver="scan"))
    stats = StatsRegistry()
    rgb_wf, alpha_wf = path_wavefront.render(scene, opts, stats=stats)
    assert np.isfinite(rgb_wf).all()
    # Same per-sample estimates; only the scatter-add order differs.
    np.testing.assert_allclose(rgb_wf, rgb_scan, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(alpha_wf, alpha_scan, atol=1e-5)
    # Regeneration must beat the scan driver's dead-lane occupancy: with
    # maxdepth 4 the scan runs 5 full-width passes regardless of liveness.
    segs = stats.get("Wavefront", "Path segments traced")
    passes = stats.get("Wavefront", "Passes")
    assert segs > 0 and passes > 0
    occupancy = segs / (passes * 1024)
    assert occupancy > 0.5, occupancy


def test_wavefront_small_lane_pool():
    """Lane pool smaller than the sample count: cursor drains the whole
    space and every sample still lands once (weights match full render)."""
    scene, opts = _scene()
    opts = opts._replace(integrator="path", filter_kind="box",
                         filter_xwidth=0.5, filter_ywidth=0.5)
    big = path_wavefront.render(scene, opts._replace(chunk_size=4096))[0]
    small = path_wavefront.render(scene, opts._replace(chunk_size=640))[0]
    np.testing.assert_allclose(small, big, atol=2e-4, rtol=2e-4)


def test_wavefront_accepts_volumes():
    """A Volume statement no longer forces the scan driver (the old
    fallback raised here); full parity is checked by
    test_wavefront_matches_scan_volume_scene."""
    scene, opts = _scene()
    vol_scene, vol_opts = load_scene_string(CORNELL.replace(
        "WorldEnd",
        'Volume "homogeneous" "color sigma_a" [0.1 0.1 0.1] '
        '"point p0" [-5 -5 0] "point p1" [5 5 6]\nWorldEnd'))
    rgb, alpha = path_wavefront.render(
        vol_scene, vol_opts._replace(chunk_size=1024))
    assert np.isfinite(rgb).all()


VOLUME_BOX = """
Film "image" "integer xresolution" [32] "integer yresolution" [32]
Camera "perspective" "float fov" [55]
Sampler "lowdiscrepancy" "integer pixelsamples" [2]
SurfaceIntegrator "path" "integer maxdepth" [3]
VolumeIntegrator "single" "float stepsize" [0.2]
WorldBegin
LightSource "point" "color I" [14 14 14] "point from" [0 1.6 2]
Volume "homogeneous" "color sigma_a" [0.12 0.1 0.08]
  "color sigma_s" [0.25 0.25 0.3] "color Le" [0.01 0.01 0.012]
  "point p0" [-2 -2 1] "point p1" [2 2 5]
Material "matte" "color Kd" [0.7 0.6 0.5]
Translate 0 0 3
Shape "sphere" "float radius" [0.8]
WorldEnd
"""


def test_wavefront_matches_scan_volume_scene():
    """Volume scenes no longer fall back: the wavefront composes
    Scene::Li's L = T*Lo + Lv inline (VERDICT r2 item 6) with the same
    random streams as the scan driver, so the images match exactly."""
    scene, opts = load_scene_string(VOLUME_BOX)
    assert scene.volumes is not None and scene.volumes.count == 1
    opts = opts._replace(integrator="path", filter_kind="box",
                         filter_xwidth=0.5, filter_ywidth=0.5,
                         chunk_size=512)
    rgb_scan, alpha_scan = R.render(scene, opts._replace(driver="scan"))
    rgb_wf, alpha_wf = path_wavefront.render(scene, opts)
    assert np.isfinite(rgb_wf).all()
    np.testing.assert_allclose(rgb_wf, rgb_scan, atol=3e-4, rtol=3e-4)
    np.testing.assert_allclose(alpha_wf, alpha_scan, atol=1e-5)


def test_phase_functions_normalize():
    """PhaseRayleigh/MieHazy/MieMurky/Schlick (volume.cpp:28-56) must each
    integrate to 1 over the sphere."""
    import jax.numpy as jnp
    from prt.core import mc
    n = 200000
    rng_ = np.random.default_rng(0)
    cos_t = jnp.asarray(rng_.uniform(-1, 1, n), jnp.float32)
    for fn in (mc.phase_isotropic, mc.phase_rayleigh, mc.phase_mie_hazy,
               mc.phase_mie_murky,
               lambda c: mc.phase_schlick(c, 0.4),
               lambda c: mc.phase_schlick(c, -0.6)):
        # Integral over sphere = 2*pi * E_{cos~U(-1,1)}[p] * 2.
        est = float(jnp.mean(fn(cos_t))) * 4.0 * np.pi
        assert abs(est - 1.0) < 2e-2, (fn, est)


DELTA_INF = """
Film "image" "integer xresolution" [32] "integer yresolution" [32]
Camera "perspective" "float fov" [55]
Sampler "lowdiscrepancy" "integer pixelsamples" [2]
SurfaceIntegrator "directlighting"
WorldBegin
LightSource "infinite" "color L" [0.4 0.5 0.6]
LightSource "distant" "point from" [3 6 -4] "point to" [0 0 0]
    "color L" [2 2 2]
Material "matte" "color Kd" [0.7 0.6 0.5]
Translate 0 0 3
Shape "sphere" "float radius" [1000] "float zmin" [-1002] "float zmax" [-998]
AttributeBegin
  Material "mirror"
  Translate 0 -0.3 0
  Shape "sphere" "float radius" [0.6]
AttributeEnd
WorldEnd
"""


@pytest.mark.parametrize("strategy", ["all", "one", "weighted"])
def test_wavefront_directlighting_matches_scan(strategy):
    """VERDICT r3 item 2: the single-dispatch regenerating pool must serve
    directlighting (all strategies) with per-sample parity vs the scan
    integrator (integrators/directlighting.py)."""
    scene, opts = load_scene_string(CORNELL)
    opts = opts._replace(integrator="directlighting", filter_kind="box",
                         filter_xwidth=0.5, filter_ywidth=0.5,
                         chunk_size=1024, direct_strategy=strategy)
    rgb_scan, alpha_scan = R.render(scene, opts._replace(driver="scan"))
    rgb_wf, alpha_wf = path_wavefront.render(scene, opts)
    assert np.isfinite(rgb_wf).all()
    np.testing.assert_allclose(rgb_wf, rgb_scan, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(alpha_wf, alpha_scan, atol=1e-5)


def test_wavefront_directlighting_delta_and_infinite():
    """Static per-light kind specialization (delta lights skip the
    BSDF-strategy ray; infinite lights resolve strategy 2 by any-hit) must
    not change the estimate: wavefront == scan on a distant+infinite
    scene with a specular chain."""
    scene, opts = load_scene_string(DELTA_INF)
    opts = opts._replace(filter_kind="box", filter_xwidth=0.5,
                         filter_ywidth=0.5, chunk_size=512)
    rgb_scan, _ = R.render(scene, opts._replace(driver="scan"))
    rgb_wf, _ = path_wavefront.render(scene, opts)
    assert np.isfinite(rgb_wf).all()
    assert float(np.abs(rgb_wf).sum()) > 0.0
    np.testing.assert_allclose(rgb_wf, rgb_scan, atol=2e-4, rtol=2e-4)


def test_wavefront_photonmap_matches_scan():
    """Photonmap mode (r5): the pool must reproduce the scan driver's
    photonmap estimates per sample — photon_radiance's RNG streams are
    functions of (pixel, sample, depth) only, so the regenerating drive
    cannot change them. Uses a small map build + final gather."""
    from prt.integrators import photonmap as pm
    scene, opts = load_scene_string(CORNELL)
    prm = pm.PhotonParams(caustic=500, direct=4000, indirect=4000,
                          max_dist=0.4, final_gather=True,
                          gather_samples=2, batch=8192, max_shot=32768)
    opts = opts._replace(integrator="photonmap", photon=prm,
                         filter_kind="box", filter_xwidth=0.5,
                         filter_ywidth=0.5, chunk_size=1024)
    rgb_scan, alpha_scan = R.render(scene, opts._replace(driver="scan"))
    aux = pm.build_maps(scene, prm, opts.seed)
    rgb_wf, alpha_wf = path_wavefront.render(scene, opts, aux=aux)
    assert np.isfinite(rgb_wf).all()
    assert float(np.abs(rgb_wf).sum()) > 0.0
    np.testing.assert_allclose(rgb_wf, rgb_scan, atol=3e-4, rtol=3e-4)
    np.testing.assert_allclose(alpha_wf, alpha_scan, atol=1e-5)


def test_wavefront_whitted_matches_scan():
    """Whitted mode: all-lights no-MIS direct lighting + specular-only
    continuation with propagated ray differentials."""
    scene, opts = load_scene_string(CORNELL)
    opts = opts._replace(integrator="whitted", filter_kind="box",
                         filter_xwidth=0.5, filter_ywidth=0.5,
                         chunk_size=1024)
    rgb_scan, alpha_scan = R.render(scene, opts._replace(driver="scan"))
    rgb_wf, alpha_wf = path_wavefront.render(scene, opts)
    assert np.isfinite(rgb_wf).all()
    np.testing.assert_allclose(rgb_wf, rgb_scan, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(alpha_wf, alpha_scan, atol=1e-5)

"""Golden-image parity vs the reference renderer (BASELINE.md protocol
step 1; VERDICT round-1 item 3).

scenes/config{1..4}.pbrt are the BASELINE.json configs (procedural
meshes, reduced resolutions) and scenes/golden{1..4}.exr are the
REFERENCE renderer's outputs, produced by building pbrt-v1 in this image
(hand-written parser replacing flex/bison, OpenEXR 3.x port — see
tools/build_reference.md) and running `bin/pbrt configN.pbrt`.

The two renderers use different (counter-based vs global-MT19937) sample
sequences, so images are compared after a 4x4 box downsample that
averages most sampling noise out (SURVEY.md section 7: golden tests must
compare converged images, not sample-exact values). Tolerances are set
~2x above the observed agreement at these sample counts.
"""
import os

import numpy as np
import pytest

from prt.io.exr import read_exr

SCENES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")


def _downsample(x, k=4):
    h, w = x.shape[:2]
    return x[:h // k * k, :w // k * k].reshape(
        h // k, k, w // k, k, -1).mean((1, 3))


def _compare(i, spp=None, tol_rel=0.08, tol_mean=0.05):
    from prt.scene.parser import load_scene
    from prt import render as R
    scene, opts = load_scene(os.path.join(SCENES, f"config{i}.pbrt"))
    if spp is not None:
        opts = opts._replace(
            sampler=opts.sampler._replace(kind="lowdiscrepancy",
                                          pixelsamples=spp))
    rgb, _alpha = R.render(scene, opts)
    ref, _ = read_exr(os.path.join(SCENES, f"golden{i}.exr"))
    assert np.isfinite(rgb).all()
    # Global energy parity.
    assert abs(rgb.mean() - ref.mean()) <= tol_mean * max(ref.mean(), 1e-3)
    # Blurred per-region parity on lit regions.
    dr = _downsample(ref)
    dm = _downsample(rgb)
    lit = dr.mean(-1) > 0.02
    rel = (np.abs(dr - dm).mean(-1)[lit] /
           np.maximum(dr.mean(-1)[lit], 1e-3)).mean()
    assert rel < tol_rel, f"config{i}: blurred rel err {rel:.4f}"


# Tolerances are ~2x the agreement measured 2026-08-21 against freshly
# rebuilt reference goldens at the raised sample counts (config2 8->32
# spp, config4 4->16 spp; VERDICT r3 item 6): observed blurred-rel
# 1.1% / 1.9% / 9.9% / 0.4% for configs 1-4.


def test_golden1_whitted_sphere():
    _compare(1, tol_rel=0.025, tol_mean=0.015)


def test_golden2_grid_mesh_arealight():
    _compare(2, tol_rel=0.04, tol_mean=0.015)


def test_golden3_path_cornell():
    # golden3 re-rendered at 256 spp this round (VERDICT r4 item 3:
    # tighten bands by averaging reference noise out of the golden); we
    # render 64 spp, so the residual is OUR glass-caustic noise alone.
    # Observed blurred-rel 7.2% on 2026-08-21.
    _compare(3, spp=64, tol_rel=0.10, tol_mean=0.03)


def test_golden4_kdtree_textured_env():
    _compare(4, tol_rel=0.02, tol_mean=0.01)


# GI-integrator parity (VERDICT r3 item 6: photonmap/exphotonmap/igi/
# irradiancecache previously had NO image test vs the reference).
# Observed blurred-rel 2026-08-21: 5.2% / 5.4% / 20.5% / 9.7%; igi's
# wide band is structural (each renderer draws different virtual-light
# sets, so the blurred images differ by correlated splotches even though
# the means agree to ~5%).


def test_golden6_photonmap():
    _compare(6, tol_rel=0.10, tol_mean=0.05)


def test_golden7_exphotonmap():
    _compare(7, tol_rel=0.10, tol_mean=0.05)


def test_golden8_igi():
    # r5: nsets raised 4 -> 64 in config8 (both renderers) so the
    # different virtual-light realizations average out, and the golden
    # re-rendered at 32 spp; the r4 "structural" 30% band tightened.
    _compare(8, spp=16, tol_rel=0.15, tol_mean=0.05)


def test_golden9_irradiancecache():
    # r5: maxerror tightened 0.2 -> 0.1 in config9 (both renderers:
    # denser caches agree better) and the golden re-rendered at 32 spp.
    _compare(9, spp=16, tol_rel=0.10, tol_mean=0.04)


def test_golden10_bidirectional():
    # Bidirectional golden (VERDICT r4 item 4 / r5 item 3). The scene is
    # constructed so the reference's bidirectional BUGS are inert: light
    # I == (1,1,1) (bidirectional.cpp:106 overwrites the sampled Le with
    # lightWeight/lightPdf, dropping the spectrum) and no emitter is
    # camera-visible (the reference drops that term). Golden at 128 spp,
    # ours at the scene's 8 spp; observed blurred-rel 5.7%.
    _compare(10, tol_rel=0.12, tol_mean=0.04)

"""Operability: CLI, stats registry, progress, checkpoint/resume,
ReportUnused (VERDICT round-1 item 10; reference analogues
core/util.cpp:186-285/396-448, film/image.cpp:142-146,
core/paramset.cpp:242, renderer/pbrt.cpp:28-51)."""
import io
import os
import sys

import numpy as np
import pytest

from prt.utils.stats import StatsRegistry, _suffixed
from prt.utils.progress import ProgressReporter
from prt.utils import errors


SCENE = """
Film "image" "integer xresolution" [32] "integer yresolution" [24]
    "string filename" ["out.exr"] "integer writefrequency" [256]
Camera "perspective" "float fov" [60]
Sampler "lowdiscrepancy" "integer pixelsamples" [1]
SurfaceIntegrator "whitted"
WorldBegin
LightSource "point" "point from" [0 0 0] "color I" [10 10 10]
AttributeBegin
  Translate 0 0 3
  Shape "sphere" "float radius" [1]
AttributeEnd
WorldEnd
"""


def _load(text):
    from prt.scene.parser import load_scene_string
    return load_scene_string(text)


def test_stats_registry_format():
    s = StatsRegistry()
    s.add("Camera", "Rays traced", 1_500_000)
    s.add("Camera", "Rays traced", 500_000)
    s.add_ratio("Grid", "Tests per ray", 10, 4)
    assert s.get("Camera", "Rays traced") == 2_000_000
    tbl = s.format_table()
    assert "2.000M" in tbl and "Camera" in tbl and "2.50x" in tbl
    assert _suffixed(3_200_000_000) == "3.200B"
    assert _suffixed(999) == "999"
    s2 = StatsRegistry()
    s2.add("Camera", "Rays traced", 1)
    s2.merge(s)
    assert s2.get("Camera", "Rays traced") == 2_000_001


def test_progress_reporter():
    buf = io.StringIO()
    rep = ProgressReporter(4, "Rendering", out=buf)
    for _ in range(4):
        rep.update()
    rep.done()
    out = buf.getvalue()
    assert "Rendering" in out and "+" in out and out.endswith("\n")


def test_report_unused_warns(capsys):
    before = errors.counts["warning"]
    _load(SCENE.replace('"float radius" [1]',
                        '"float radius" [1] "float typotypo" [2]'))
    assert errors.counts["warning"] > before
    err = capsys.readouterr().err
    assert "typotypo" in err


def test_unknown_directive_warns(capsys):
    before = errors.counts["warning"]
    _load(SCENE + '\nBogusDirective "float x" [1]\n')
    assert errors.counts["warning"] > before
    assert "BogusDirective" in capsys.readouterr().err


def test_film_params_flow_to_options():
    scene, opts = _load(SCENE)
    assert opts.filename == "out.exr"
    assert opts.writefrequency == 256
    assert opts.xres == 32 and opts.yres == 24


def test_checkpoint_resume_matches_straight_render(tmp_path):
    from prt import render as R
    scene, opts = _load(SCENE)
    opts = opts._replace(chunk_size=256,
                         filename=str(tmp_path / "partial.exr"))
    stats = StatsRegistry()
    rgb_ref, alpha_ref = R.render(scene, opts, stats=stats)
    assert stats.get("Camera", "Samples taken") >= 32 * 24
    assert os.path.exists(opts.filename)  # writefrequency partial image

    # Interrupted render: checkpoint written mid-way, then resume.
    ckpt = str(tmp_path / "film.ckpt.npz")
    film = __import__("prt.film.film", fromlist=["film"])
    f0 = film.make_film(opts.xres, opts.yres, opts.crop)
    # Render the first half of the chunks manually via the public pieces.
    import math
    spp = 1
    total = 32 * 24 * spp
    n_chunks = math.ceil(total / opts.chunk_size)
    half = n_chunks // 2
    import jax.numpy as jnp
    fcur = f0
    for c in range(half):
        base = c * opts.chunk_size
        lin = np.arange(base, base + opts.chunk_size)
        valid = lin < total
        lin = np.minimum(lin, total - 1)
        s_idx = lin % spp
        pix = lin // spp
        px = (pix % 32).astype(np.int32)
        py = (pix // 32).astype(np.int32)
        fcur = R.render_chunk(scene, opts, fcur, jnp.asarray(px),
                              jnp.asarray(py),
                              jnp.asarray(s_idx, jnp.int32),
                              jnp.asarray(valid))
    R.save_checkpoint(ckpt, fcur, half)
    rgb_res, alpha_res = R.render(scene, opts, checkpoint_path=ckpt,
                                  resume=True)
    np.testing.assert_allclose(rgb_res, rgb_ref, atol=1e-5)
    np.testing.assert_allclose(alpha_res, alpha_ref, atol=1e-5)


def test_cli_end_to_end(tmp_path):
    scene_file = tmp_path / "scene.pbrt"
    scene_file.write_text(SCENE)
    out = tmp_path / "cli.exr"
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import pbrt as cli
    rc = cli.main([str(scene_file), "-o", str(out), "--quiet"])
    assert rc == 0 and out.exists()
    from prt.io import exr
    rgb, _alpha = exr.read_exr(str(out))
    assert rgb.shape == (24, 32, 3)
    assert np.isfinite(rgb).all()

"""Global-illumination integrators (igi, bidirectional, irradiancecache)
agree with the path tracer in expectation on a closed diffuse box —
the reference's only correctness bar for these plugins (no test suite
exists upstream; SURVEY.md section 4)."""
import numpy as np

from prt import render as R
from prt.integrators import igi as igi_mod
from prt.integrators import irradiancecache as ic_mod
from prt.samplers import samplers as smp
from prt.scene.parser import load_scene_string

from test_photonmap import _box_scene

_XRES = _YRES = 16
_COMMON = dict(xres=_XRES, yres=_YRES, chunk_size=_XRES * _YRES * 16)


def _path_reference(scene, spp=16, depth=6):
    img, _ = R.render(scene, R.RenderOptions(
        integrator="path", max_depth=depth,
        sampler=smp.SamplerConfig(kind="lowdiscrepancy", pixelsamples=spp),
        **_COMMON))
    return img


def test_igi_agrees_with_path():
    scene = _box_scene(_XRES, _YRES)
    ref = _path_reference(scene)
    prm = igi_mod.IgiParams(nlights=128, nsets=4, mindist=0.08)
    img, _ = R.render(scene, R.RenderOptions(
        integrator="igi", igi=prm, max_depth=3,
        sampler=smp.SamplerConfig(kind="lowdiscrepancy", pixelsamples=4),
        **_COMMON))
    assert not np.isnan(img).any()
    ratio = img.mean() / ref.mean()
    assert abs(ratio - 1.0) < 0.12, ratio


def test_bidirectional_agrees_with_path():
    scene = _box_scene(_XRES, _YRES)
    ref = _path_reference(scene, depth=4, spp=32)
    img, _ = R.render(scene, R.RenderOptions(
        integrator="bidirectional",
        sampler=smp.SamplerConfig(kind="lowdiscrepancy", pixelsamples=32),
        **_COMMON))
    assert not np.isnan(img).any()
    ratio = img.mean() / ref.mean()
    assert abs(ratio - 1.0) < 0.12, ratio


def test_irradiancecache_agrees_with_path():
    scene = _box_scene(_XRES, _YRES)
    ref = _path_reference(scene)
    prm = ic_mod.IrradParams(nsamples=256, probe_stride=2, maxerror=0.3,
                             maxindirectdepth=4)
    img, _ = R.render(scene, R.RenderOptions(
        integrator="irradiancecache", irrad=prm, max_depth=3,
        sampler=smp.SamplerConfig(kind="lowdiscrepancy", pixelsamples=4),
        **_COMMON))
    assert not np.isnan(img).any()
    ratio = img.mean() / ref.mean()
    assert abs(ratio - 1.0) < 0.12, ratio


def test_parser_gi_integrators():
    """SurfaceIntegrator directives for the new plugins parse into the
    right RenderOptions."""
    base = '''
Film "image" "integer xresolution" [8] "integer yresolution" [8]
SurfaceIntegrator {integ}
WorldBegin
LightSource "point" "point from" [0 2 0] "color I" [4 4 4]
Material "matte" "color Kd" [0.5 0.5 0.5]
Shape "sphere" "float radius" [1]
WorldEnd
'''
    _, o = load_scene_string(base.format(
        integ='"igi" "integer nlights" [32] "float mindist" [0.2]'))
    assert o.integrator == "igi" and o.igi.nlights == 32
    assert abs(o.igi.mindist - 0.2) < 1e-6
    _, o = load_scene_string(base.format(integ='"bidirectional"'))
    assert o.integrator == "bidirectional"
    _, o = load_scene_string(base.format(
        integ='"irradiancecache" "integer nsamples" [64]'))
    assert o.integrator == "irradiancecache" and o.irrad.nsamples == 64
    _, o = load_scene_string(base.format(
        integ='"photonmap" "integer causticphotons" [123]'))
    assert o.integrator == "photonmap" and o.photon.caustic == 123

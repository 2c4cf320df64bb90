"""Extended photon map (integrators/exphotonmap.cpp): radiance-photon
precomputation, the importance-sampled final gather, and cross-integrator
agreement with the plain photon map / path tracer in a closed box."""
import numpy as np
import jax.numpy as jnp

from prt import render as R
from prt.integrators import exphotonmap as xpm
from prt.integrators import photonmap as pm
from prt.samplers import samplers as smp
from prt.scene.parser import load_scene_string


BOX = """
Film "image" "integer xresolution" [20] "integer yresolution" [20]
Camera "perspective" "float fov" [55]
Sampler "lowdiscrepancy" "integer pixelsamples" [4]
SurfaceIntegrator "exphotonmap" "integer causticphotons" [0]
    "integer indirectphotons" [4000] "integer directphotons" [4000]
    "float maxdist" [0.45] "integer finalgathersamples" [8]
WorldBegin
AttributeBegin
  AreaLightSource "area" "color L" [14 14 14]
  Translate 0 1.9 3
  Shape "sphere" "float radius" [0.35]
AttributeEnd
Material "matte" "color Kd" [0.7 0.7 0.7]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-4 -1 -1  -4 -1 7  4 -1 7  4 -1 -1]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-4 -1 6  -4 3 6  4 3 6  4 -1 6]
AttributeBegin
  Material "matte" "color Kd" [0.25 0.55 0.3]
  Translate 0 -0.4 3
  Shape "sphere" "float radius" [0.6]
AttributeEnd
WorldEnd
"""


def _scene():
    return load_scene_string(BOX)


def test_radiance_photons_built():
    scene, opts = _scene()
    assert opts.integrator == "exphotonmap"
    prm = opts.photon._replace(batch=4096, max_shot=40000)
    aux = xpm.build_aux(scene, prm, seed=0)
    assert aux.radiance.count > 50
    # Lo at radiance photons on a lit diffuse floor must be finite,
    # non-negative, and nonzero somewhere.
    lo = np.asarray(aux.radiance.payload[1])
    assert np.isfinite(lo).all() and (lo >= 0).all() and lo.max() > 0


def test_exphotonmap_matches_path_tracer():
    """Converged exphotonmap (radiance photons + MIS final gather) must
    agree with the unbiased path tracer on mean image energy in a simple
    diffuse scene (the reference's own validation was visual parity)."""
    scene, opts = _scene()
    opts = opts._replace(
        photon=opts.photon._replace(batch=4096, max_shot=80000),
        chunk_size=20 * 20 * 4)
    img_x, _ = R.render(scene, opts)
    opts_p = opts._replace(integrator="path", max_depth=6)
    img_path, _ = R.render(scene, opts_p)
    assert np.isfinite(img_x).all()
    lit = img_path.mean(-1) > 0.02
    assert lit.sum() > 40
    ratio = img_x.mean(-1)[lit].mean() / img_path.mean(-1)[lit].mean()
    # Biased estimator + kernel estimates: generous but meaningful bounds.
    assert 0.7 < ratio < 1.35, ratio


def test_exphotonmap_no_finalgather_matches_photonmap():
    """With finalgather off both integrators estimate indirect from the
    photon maps directly; same scene, similar energy."""
    scene, opts = _scene()
    prm = opts.photon._replace(batch=4096, max_shot=60000,
                               final_gather=False)
    opts_x = opts._replace(photon=prm, chunk_size=20 * 20 * 4)
    img_x, _ = R.render(scene, opts_x)
    prm_p = pm.PhotonParams(caustic=0, direct=4000, indirect=4000,
                            max_dist=0.45, final_gather=False,
                            batch=4096, max_shot=60000)
    opts_p = opts._replace(integrator="photonmap", photon=prm_p,
                           chunk_size=20 * 20 * 4)
    img_p, _ = R.render(scene, opts_p)
    lit = img_p.mean(-1) > 0.02
    ratio = img_x.mean(-1)[lit].mean() / img_p.mean(-1)[lit].mean()
    assert 0.75 < ratio < 1.3, ratio

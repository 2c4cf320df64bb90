"""Scene-description parser tests (grammar semantics of core/pbrtparse.y +
api.cpp state machine)."""
import numpy as np

from prt.scene.parser import load_scene_string
from prt.scene import data as D

SCENE = """
# config-1-like scene
Film "image" "integer xresolution" [32] "integer yresolution" [32]
Sampler "stratified" "integer xsamples" [2] "integer ysamples" [2]
PixelFilter "box" "float xwidth" [0.5] "float ywidth" [0.5]
SurfaceIntegrator "whitted" "integer maxdepth" [3]
LookAt 0 0 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [45]
WorldBegin
LightSource "point" "color I" [30 30 30] "point from" [2 2 -3]
AttributeBegin
  Material "matte" "color Kd" [0.8 0.2 0.2]
  Shape "sphere" "float radius" [1.0]
AttributeEnd
AttributeBegin
  Translate 0 -2 0
  Material "plastic"
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-5 0 -5  5 0 -5  5 0 5  -5 0 5]
AttributeEnd
WorldEnd
"""


def test_parse_basic_scene():
    scene, opts = load_scene_string(SCENE)
    assert opts.xres == 32 and opts.yres == 32
    assert opts.integrator == "whitted"
    assert opts.max_depth == 3
    assert opts.filter_kind == "box"
    assert opts.sampler.kind == "stratified"
    assert scene.quadrics.count == 1
    assert scene.triangles.count == 2
    assert scene.lights.count == 1
    assert int(scene.lights.kind[0]) == D.LIGHT_POINT
    # Light position from "from" param.
    assert np.allclose(np.asarray(scene.lights.l2w[0])[:3, 3], [2, 2, -3])
    assert scene.materials.count == 2
    # Camera: looks from -4 toward origin.
    c2w = np.asarray(scene.camera.cam2world)
    assert np.allclose(c2w[:3, 3], [0, 0, -4], atol=1e-5)


def test_attribute_stack_restores_state():
    s = """
WorldBegin
AttributeBegin
  Translate 5 0 0
  Material "mirror"
  Shape "sphere" "float radius" [2]
AttributeEnd
Shape "sphere" "float radius" [1]
WorldEnd
"""
    scene, _ = load_scene_string(s)
    o2w = np.asarray(scene.quadrics.o2w)
    assert np.allclose(o2w[0][:3, 3], [5, 0, 0])
    assert np.allclose(o2w[1][:3, 3], [0, 0, 0])


def test_area_light_attached():
    s = """
WorldBegin
AttributeBegin
  AreaLightSource "area" "color L" [5 5 5]
  Shape "trianglemesh" "integer indices" [0 1 2]
    "point P" [0 5 0  1 5 0  0 5 1]
AttributeEnd
WorldEnd
"""
    scene, _ = load_scene_string(s)
    assert scene.lights.count == 1
    assert int(scene.lights.kind[0]) == D.LIGHT_AREA
    assert int(scene.triangles.area_light[0]) == 0
    assert abs(float(scene.lights.area_total_area[0]) - 0.5) < 1e-5


def test_object_instancing():
    s = """
WorldBegin
ObjectBegin "ball"
  Shape "sphere" "float radius" [1]
ObjectEnd
Translate 3 0 0
ObjectInstance "ball"
Translate -6 0 0
ObjectInstance "ball"
WorldEnd
"""
    scene, _ = load_scene_string(s)
    assert scene.quadrics.count == 2
    o2w = np.asarray(scene.quadrics.o2w)
    assert np.allclose(o2w[0][:3, 3], [3, 0, 0])
    assert np.allclose(o2w[1][:3, 3], [-3, 0, 0])


def test_heightfield_tessellated():
    s = """
WorldBegin
Shape "heightfield" "integer nu" [3] "integer nv" [3]
  "float Pz" [0 0 0 0 1 0 0 0 0]
WorldEnd
"""
    scene, _ = load_scene_string(s)
    assert scene.triangles.count == 8  # 2x2 cells x 2 tris


def test_loopsubdiv_tessellated():
    s = """
WorldBegin
Shape "loopsubdiv" "integer nlevels" [2]
  "integer indices" [0 1 2  0 2 3  0 3 1  1 3 2]
  "point P" [0 0 1  1 0 -1  -1 1 -1  -1 -1 -1]
WorldEnd
"""
    scene, _ = load_scene_string(s)
    # Tetrahedron: 4 faces x 4^2 = 64 triangles after 2 levels.
    assert scene.triangles.count == 64

"""Ray-transform instancing (VERDICT r3 item 5): ObjectInstance mesh
objects share ONE prototype BLAS + per-instance transforms
(/root/reference/core/primitive.cpp:66-85 semantics) instead of geometry
duplication; renders must match the duplication path exactly and memory
must stay O(prototype + instances)."""
import numpy as np

from prt.scene.parser import load_scene_string
from prt import render as R


HEAD = """
Film "image" "integer xresolution" [48] "integer yresolution" [48]
LookAt 0 1.5 -5  0 0 0  0 1 0
Camera "perspective" "float fov" [50]
Sampler "lowdiscrepancy" "integer pixelsamples" [2]
SurfaceIntegrator "directlighting"
WorldBegin
LightSource "distant" "point from" [2 5 -3] "point to" [0 0 0]
    "color L" [2.5 2.4 2.2]
LightSource "infinite" "color L" [0.2 0.25 0.3]
Material "matte" "color Kd" [0.7 0.6 0.5]
# ground
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-6 -0.5 -6  6 -0.5 -6  6 -0.5 6  -6 -0.5 6]
"""

# A small pyramid prototype (4 side faces + base).
PYRAMID = """
ObjectBegin "pyr"
  Material "matte" "color Kd" [0.3 0.5 0.8]
  Shape "trianglemesh" "integer indices" [0 1 4  1 2 4  2 3 4  3 0 4  0 2 1  0 3 2]
    "point P" [-0.4 -0.5 -0.4  0.4 -0.5 -0.4  0.4 -0.5 0.4
               -0.4 -0.5 0.4  0 0.45 0]
ObjectEnd
"""

PLACEMENTS = [(-1.6, 0.0), (-0.5, 0.6), (0.7, -0.4), (1.7, 0.5),
              (0.1, -1.4), (-1.0, -1.0)]


def _instanced_text():
    s = HEAD + PYRAMID
    for x, z in PLACEMENTS:
        s += ("AttributeBegin\n"
              f"  Translate {x} 0 {z}\n"
              "  Rotate 25 0 1 0\n"
              '  ObjectInstance "pyr"\n'
              "AttributeEnd\n")
    return s + "WorldEnd\n"


def _duplicated_text():
    # Same geometry with instancing disabled by attaching an (unused but
    # eligibility-breaking) area light? No — simply inline the shapes.
    s = HEAD
    for x, z in PLACEMENTS:
        s += ("AttributeBegin\n"
              f"  Translate {x} 0 {z}\n"
              "  Rotate 25 0 1 0\n"
              '  Material "matte" "color Kd" [0.3 0.5 0.8]\n'
              '  Shape "trianglemesh" "integer indices" '
              "[0 1 4  1 2 4  2 3 4  3 0 4  0 2 1  0 3 2]\n"
              '    "point P" [-0.4 -0.5 -0.4  0.4 -0.5 -0.4  0.4 -0.5 0.4'
              "  -0.4 -0.5 0.4  0 0.45 0]\n"
              "AttributeEnd\n")
    return s + "WorldEnd\n"


def test_instanced_matches_duplication():
    sc_i, opts = load_scene_string(_instanced_text())
    sc_d, _ = load_scene_string(_duplicated_text())
    opts = opts._replace(filter_kind="box", filter_xwidth=0.5,
                         filter_ywidth=0.5, chunk_size=48 * 48, driver="scan")
    assert sc_i.instances is not None and sc_i.instances.count == \
        len(PLACEMENTS)
    # Prototype stored once: main triangle table holds only the ground.
    assert sc_i.triangles.count == 2
    assert sc_i.instances.n_tris == 6
    assert sc_d.triangles.count == 2 + 6 * len(PLACEMENTS)
    rgb_i, a_i = R.render(sc_i, opts)
    rgb_d, a_d = R.render(sc_d, opts)
    assert np.isfinite(rgb_i).all()
    assert float(np.abs(rgb_i).sum()) > 0.0
    np.testing.assert_allclose(rgb_i, rgb_d, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(a_i, a_d, atol=1e-5)


def test_instance_memory_is_o_proto_plus_n():
    """50 instances of the prototype: the instance table's geometry stays
    the prototype's 6 triangles; only transforms grow."""
    s = HEAD + PYRAMID
    rng = np.random.default_rng(0)
    for i in range(50):
        x, z = rng.uniform(-3, 3, 2)
        s += (f"AttributeBegin\n  Translate {x:.3f} 0 {z:.3f}\n"
              '  ObjectInstance "pyr"\nAttributeEnd\n')
    s += "WorldEnd\n"
    sc, _ = load_scene_string(s)
    assert sc.instances.count == 50
    assert sc.instances.n_tris == 6          # prototype NOT duplicated
    assert sc.triangles.count == 2           # ground only
    assert sc.instances.inst_o2w.shape == (50, 4, 4)


def test_wavefront_serves_instanced_scenes():
    """The regenerating-pool driver must handle the instanced aggregate."""
    from prt.integrators import path_wavefront
    sc_i, opts = load_scene_string(_instanced_text())
    opts = opts._replace(filter_kind="box", filter_xwidth=0.5,
                         filter_ywidth=0.5, chunk_size=1024)
    rgb_scan, _ = R.render(sc_i, opts._replace(driver="scan"))
    rgb_wf, _ = path_wavefront.render(sc_i, opts)
    np.testing.assert_allclose(rgb_wf, rgb_scan, atol=2e-4, rtol=2e-4)


def test_instance_transform_gradient():
    """d(hit distance)/d(instance translation) flows through the
    instanced winner recompute (instances.recompute_t): traversal is
    detached, geometry is differentiable."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from prt.accel import instances as inst_mod

    sc0, _ = load_scene_string(_instanced_text())
    inst = sc0.instances

    # Rays straight down onto the first pyramid instance's faces.
    n = 64
    g = np.linspace(-0.2, 0.2, 8)
    gx, gz = np.meshgrid(g, g)
    x0, z0 = PLACEMENTS[0]
    o = jnp.asarray(np.stack([gx.ravel() + x0, np.full(n, 3.0),
                              gz.ravel() + z0], -1), jnp.float32)
    d = jnp.tile(jnp.asarray([[0.0, -1.0, 0.0]], jnp.float32), (n, 1))
    mint = jnp.full((n,), 1e-3)
    maxt = jnp.full((n,), 1e30)

    def loss_of_dy(dy):
        o2w = inst.inst_o2w.at[:, 1, 3].add(dy)
        w2o = inst.inst_w2o.at[:, 1, 3].add(-dy)
        it = dataclasses.replace(inst, inst_o2w=o2w, inst_w2o=w2o)
        sc = dataclasses.replace(sc0, instances=it)
        t, code, hit = inst_mod.intersect(it, o, d, mint, maxt)
        t_d, ok = inst_mod.recompute_t(it, code, o, d, mint, hit)
        use = hit & ok & (t_d < 1e6)
        return jnp.sum(jnp.where(use, t_d, 0.0))

    g_ad = float(jax.grad(loss_of_dy)(0.0))
    eps = 1e-3
    fd = (float(loss_of_dy(eps)) - float(loss_of_dy(-eps))) / (2 * eps)
    # Raising the instance by dy shortens every down-ray's t by ~dy.
    assert fd < 0, fd
    assert abs(g_ad - fd) < 0.05 * abs(fd), (g_ad, fd)


def test_mirrored_instance_matches_duplication():
    """A handedness-swapping (mirror) instance transform must orient
    normals like the duplication path, which folds swaps_handedness from
    the full ctm (ADVICE r4; reference core/api.cpp shape build)."""
    place = "  Translate -1.2 0 0\n  Scale -1 1 1\n  Rotate 25 0 1 0\n"
    s_i = HEAD + PYRAMID + ("AttributeBegin\n" + place +
                            '  ObjectInstance "pyr"\nAttributeEnd\n') + \
        "WorldEnd\n"
    s_d = HEAD + ("AttributeBegin\n" + place +
                  '  Material "matte" "color Kd" [0.3 0.5 0.8]\n'
                  '  Shape "trianglemesh" "integer indices" '
                  "[0 1 4  1 2 4  2 3 4  3 0 4  0 2 1  0 3 2]\n"
                  '    "point P" [-0.4 -0.5 -0.4  0.4 -0.5 -0.4  '
                  "0.4 -0.5 0.4  -0.4 -0.5 0.4  0 0.45 0]\n"
                  "AttributeEnd\n") + "WorldEnd\n"
    sc_i, opts = load_scene_string(s_i)
    sc_d, _ = load_scene_string(s_d)
    opts = opts._replace(filter_kind="box", filter_xwidth=0.5,
                         filter_ywidth=0.5, chunk_size=48 * 48,
                         driver="scan")
    assert sc_i.instances is not None and sc_i.instances.count == 1
    assert float(np.asarray(sc_i.instances.inst_sign)[0]) == -1.0
    rgb_i, _ = R.render(sc_i, opts)
    rgb_d, _ = R.render(sc_d, opts)
    assert float(np.abs(rgb_i).sum()) > 0.0
    np.testing.assert_allclose(rgb_i, rgb_d, atol=2e-3, rtol=2e-3)


def test_instanced_shading_geometry_matches_main():
    """Instanced hits carry full shading geometry: interpolated shading
    normals AND dndu/dndv (VERDICT r4: instanced dn was zero where the
    reference transforms it, core/primitive.cpp:75-85)."""
    import jax.numpy as jnp
    from prt.accel import intersect as isect

    # A two-triangle patch with bent vertex normals and uvs.
    mesh = ('Shape "trianglemesh" "integer indices" [0 1 2  0 2 3]\n'
            '  "point P" [-1 0 -1  1 0 -1  1 0 1  -1 0 1]\n'
            '  "float uv" [0 0  1 0  1 1  0 1]\n'
            '  "normal N" [-0.4 1 -0.4  0.4 1 -0.4  0.4 1 0.4  '
            "-0.4 1 0.4]\n")
    head = ('Film "image" "integer xresolution" [16] '
            '"integer yresolution" [16]\n'
            "LookAt 0 3 0  0 0 0  0 0 1\n"
            'Camera "perspective" "float fov" [40]\n'
            "WorldBegin\n"
            'LightSource "distant" "color L" [1 1 1]\n')
    tail = "WorldEnd\n"
    inst = (head + 'ObjectBegin "patch"\n' + mesh + "ObjectEnd\n" +
            "AttributeBegin\n  Translate 0.2 0 0.1\n  Rotate 30 0 1 0\n"
            '  ObjectInstance "patch"\nAttributeEnd\n' + tail)
    dup = (head + "AttributeBegin\n  Translate 0.2 0 0.1\n"
           "  Rotate 30 0 1 0\n" + mesh + "AttributeEnd\n" + tail)
    sc_i, _ = load_scene_string(inst)
    sc_d, _ = load_scene_string(dup)

    n = 32
    xs = np.linspace(-0.5, 0.7, n).astype(np.float32)
    o = jnp.asarray(np.stack([xs, np.full(n, 3.0, np.float32),
                              xs * 0.3], -1))
    d = jnp.tile(jnp.asarray([[0.0, -1.0, 0.0]], jnp.float32), (n, 1))
    mint = jnp.full((n,), 1e-3)
    maxt = jnp.full((n,), 1e30)

    out = []
    for sc in (sc_i, sc_d):
        t, pid, hit = isect.intersect_ids(sc, o, d, mint, maxt)
        dg = isect.hit_geometry(sc, jnp.maximum(pid, 0), o, d, t)
        out.append((np.asarray(hit), {k: np.asarray(dg[k])
                                      for k in ("sn", "dndu", "dndv",
                                                "u", "v", "p")}))
    (hit_i, g_i), (hit_d, g_d) = out
    assert (hit_i == hit_d).all() and hit_i.any()
    m = hit_i
    for k in ("sn", "dndu", "dndv", "u", "v", "p"):
        np.testing.assert_allclose(g_i[k][m], g_d[k][m], atol=1e-4,
                                   rtol=1e-3, err_msg=k)
    # The bent normals make dn genuinely nonzero.
    assert np.abs(g_i["dndu"][m]).max() > 0.1


def test_instanced_emissive_matches_duplication():
    """Emissive mesh prototypes instance WITHOUT geometry duplication
    (AREA_GEOM_INST): each placement is its own light, geometry and area
    CDF are shared in object space (VERDICT r5 item 5)."""
    head = ('Film "image" "integer xresolution" [48] '
            '"integer yresolution" [48]\n'
            "LookAt 0 1.2 -4  0 0 0  0 1 0\n"
            'Camera "perspective" "float fov" [52]\n'
            'Sampler "lowdiscrepancy" "integer pixelsamples" [8]\n'
            'SurfaceIntegrator "directlighting"\n'
            "WorldBegin\n"
            'Material "matte" "color Kd" [0.7 0.6 0.5]\n'
            'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]\n'
            '  "point P" [-6 -0.5 -6  6 -0.5 -6  6 -0.5 6  -6 -0.5 6]\n')
    lamp = ('  AreaLightSource "area" "color L" [6 5 4]\n'
            '  Material "matte" "color Kd" [0.2 0.2 0.2]\n'
            '  Shape "trianglemesh" "integer indices" [0 1 2  0 2 3]\n'
            '    "point P" [-0.3 0 -0.3  0.3 0 -0.3  0.3 0 0.3'
            "  -0.3 0 0.3]\n")
    places = [(-1.2, 0.9, 0.0, 35.0), (0.2, 1.1, -0.5, -20.0),
              (1.4, 0.8, 0.6, 80.0)]

    def place(x, y, z, rot):
        return (f"AttributeBegin\n  Translate {x} {y} {z}\n"
                f"  Rotate {rot} 0 1 0\n  Rotate 180 1 0 0\n")

    s_i = head + 'ObjectBegin "lamp"\n' + lamp + "ObjectEnd\n"
    for x, y, z, r in places:
        s_i += place(x, y, z, r) + '  ObjectInstance "lamp"\nAttributeEnd\n'
    s_i += "WorldEnd\n"
    s_d = head
    for x, y, z, r in places:
        s_d += place(x, y, z, r) + lamp + "AttributeEnd\n"
    s_d += "WorldEnd\n"

    sc_i, opts = load_scene_string(s_i)
    sc_d, _ = load_scene_string(s_d)
    # Geometry shared: the prototype's 2 triangles once, 3 LIGHTS.
    assert sc_i.instances is not None and sc_i.instances.count == 3
    assert sc_i.instances.n_tris == 2
    assert sc_i.triangles.count == 2               # floor only
    assert sc_i.lights.count == 3
    assert sc_d.triangles.count == 2 + 2 * 3
    import numpy as _np
    assert (_np.asarray(sc_i.instances.inst_area_light) >= 0).all()
    opts = opts._replace(filter_kind="box", filter_xwidth=0.5,
                         filter_ywidth=0.5, chunk_size=48 * 48 * 8,
                         driver="scan")
    rgb_i, a_i = R.render(sc_i, opts)
    rgb_d, a_d = R.render(sc_d, opts)
    assert np.isfinite(rgb_i).all()
    assert float(rgb_i.sum()) > 0.0
    # Different light-table layouts draw different sample sequences per
    # light, so compare converged-ish images, not samples.
    d = np.abs(rgb_i - rgb_d).mean() / max(rgb_d.mean(), 1e-6)
    assert d < 0.03, d
    # Camera-visible emission parity on the lamp pixels themselves.
    np.testing.assert_allclose(rgb_i.max(), rgb_d.max(), rtol=0.01)


def test_instanced_quadrics_fold_transforms():
    """Quadric prototypes instance by TRANSFORM FOLDING: each placement
    adds one analytic-quadric row (kind + 2 transforms + params) — the
    same O(1) storage as the reference's InstancePrimitive — so a shared
    BLAS would save nothing. Image parity with inline duplication and
    O(instances) rows, no mesh geometry."""
    head = ('Film "image" "integer xresolution" [48] '
            '"integer yresolution" [48]\n'
            "LookAt 0 1.5 -5  0 0 0  0 1 0\n"
            'Camera "perspective" "float fov" [50]\n'
            'Sampler "lowdiscrepancy" "integer pixelsamples" [2]\n'
            'SurfaceIntegrator "directlighting"\n'
            "WorldBegin\n"
            'LightSource "distant" "point from" [2 5 -3] "point to" [0 0 0]'
            ' "color L" [2.5 2.4 2.2]\n'
            'Material "matte" "color Kd" [0.7 0.6 0.5]\n'
            'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]\n'
            '  "point P" [-6 -0.5 -6  6 -0.5 -6  6 -0.5 6  -6 -0.5 6]\n')
    ball = ('  Material "matte" "color Kd" [0.3 0.5 0.8]\n'
            '  Shape "sphere" "float radius" [0.35]\n')
    places = [(-1.5, 0.0), (-0.4, 0.5), (0.8, -0.3), (1.6, 0.4)]

    s_i = head + 'ObjectBegin "ball"\n' + ball + "ObjectEnd\n"
    s_d = head
    for x, z in places:
        blk = (f"AttributeBegin\n  Translate {x} 0 {z}\n"
               "  Rotate 30 0 1 0\n")
        s_i += blk + '  ObjectInstance "ball"\nAttributeEnd\n'
        s_d += blk + ball + "AttributeEnd\n"
    s_i += "WorldEnd\n"
    s_d += "WorldEnd\n"
    sc_i, opts = load_scene_string(s_i)
    sc_d, _ = load_scene_string(s_d)
    # One analytic row per instance; nothing tessellated, no BLAS protos.
    assert sc_i.quadrics.count == len(places)
    assert sc_i.triangles.count == 2
    assert sc_i.instances is None or sc_i.instances.count == 0
    opts = opts._replace(filter_kind="box", filter_xwidth=0.5,
                         filter_ywidth=0.5, chunk_size=48 * 48,
                         driver="scan")
    rgb_i, _ = R.render(sc_i, opts)
    rgb_d, _ = R.render(sc_d, opts)
    assert float(np.abs(rgb_i).sum()) > 0.0
    np.testing.assert_allclose(rgb_i, rgb_d, atol=2e-5, rtol=2e-5)

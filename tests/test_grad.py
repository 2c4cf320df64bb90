"""Differentiability: jax.grad through the renderer vs central finite
differences (BASELINE.json config 5 / north star). Gradients w.r.t. material
albedo (texture constants), light intensity, and sphere translation."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from prt.core import transform as tf
from prt.scene.build import SceneBuilder
from prt.cameras import cameras as cam
from prt.samplers.samplers import SamplerConfig
from prt import render as R
from prt.parallel.shard import render_loss_fn


def _scene(kd=(0.6, 0.3, 0.2), inten=30.0, cx=0.0):
    b = SceneBuilder()
    mat = b.matte(kd=kd)
    b.add_sphere(np.asarray(tf.translate([cx, 0.0, 0.0])), 1.0, material=mat)
    b.add_point_light(np.asarray(tf.translate([2.0, 2.0, -3.0])),
                      intensity=(inten,) * 3)
    c2w = np.asarray(tf.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0]))
    xres = yres = 16
    b.set_camera(cam.build_projective(
        0, c2w, np.asarray(tf.perspective(45.0, 1e-2, 100.0)),
        cam.default_screen_window(xres, yres), xres, yres))
    return b.build()


_OPTS = R.RenderOptions(
    xres=16, yres=16,
    sampler=SamplerConfig(kind="stratified", xsamples=1, ysamples=1,
                          jitter=False),
    filter_kind="box", filter_xwidth=0.5, filter_ywidth=0.5,
    integrator="whitted", max_depth=0, chunk_size=256)


def _batch():
    lin = np.arange(256)
    return (jnp.asarray(lin % 16, jnp.int32), jnp.asarray(lin // 16, jnp.int32),
            jnp.zeros(256, jnp.int32))


def test_grad_albedo_matches_fd():
    px, py, si = _batch()
    target = jnp.zeros((16, 16, 3), jnp.float32)
    scene = _scene()

    def loss_of_scene(sc):
        return render_loss_fn(sc, _OPTS, px, py, si, target)

    g = jax.grad(loss_of_scene, allow_int=True)(scene)
    # Albedo lives in textures.fparams (constant node 0 holds Kd).
    g_kd = np.asarray(g.textures.fparams)[0, 0]  # d loss / d Kd red
    eps = 1e-3
    fp = np.asarray(scene.textures.fparams)
    up = fp.copy(); up[0, 0] += eps
    dn = fp.copy(); dn[0, 0] -= eps
    sc_up = dataclasses.replace(scene, textures=dataclasses.replace(
        scene.textures, fparams=jnp.asarray(up)))
    sc_dn = dataclasses.replace(scene, textures=dataclasses.replace(
        scene.textures, fparams=jnp.asarray(dn)))
    fd = (float(loss_of_scene(sc_up)) - float(loss_of_scene(sc_dn))) / (2 * eps)
    assert abs(g_kd - fd) < 0.02 * max(abs(fd), 1e-3), (g_kd, fd)


def test_grad_light_intensity_matches_fd():
    px, py, si = _batch()
    target = jnp.zeros((16, 16, 3), jnp.float32)
    scene = _scene()

    def loss_of_scene(sc):
        return render_loss_fn(sc, _OPTS, px, py, si, target)

    g = jax.grad(loss_of_scene, allow_int=True)(scene)
    g_I = np.asarray(g.lights.spectrum)[0, 0]
    eps = 1e-2
    sp = np.asarray(scene.lights.spectrum)
    up = sp.copy(); up[0, 0] += eps
    dn = sp.copy(); dn[0, 0] -= eps
    sc_up = dataclasses.replace(scene, lights=dataclasses.replace(
        scene.lights, spectrum=jnp.asarray(up)))
    sc_dn = dataclasses.replace(scene, lights=dataclasses.replace(
        scene.lights, spectrum=jnp.asarray(dn)))
    fd = (float(loss_of_scene(sc_up)) - float(loss_of_scene(sc_dn))) / (2 * eps)
    assert abs(g_I - fd) < 0.02 * max(abs(fd), 1e-4), (g_I, fd)


def test_grad_sphere_translation_interior():
    """Translation gradient at interior pixels (shading change, silhouette
    excluded — edge gradients need reparameterization, round 2)."""
    px, py, si = _batch()
    scene0 = _scene()
    # Target: the same scene shifted — gradient should point toward it.
    opts = _OPTS
    rgb_t, _ = R.render(_scene(cx=0.05), opts)
    target = jnp.asarray(rgb_t)

    def loss_of_cx(cx):
        sc = _scene()
        o2w = jnp.asarray(np.eye(4, dtype=np.float32)).at[0, 3].set(cx)
        w2o = jnp.asarray(np.eye(4, dtype=np.float32)).at[0, 3].set(-cx)
        quad = dataclasses.replace(
            sc.quadrics, o2w=o2w[None], w2o=w2o[None])
        sc = dataclasses.replace(sc, quadrics=quad)
        return render_loss_fn(sc, opts, px, py, si, target)

    g = float(jax.grad(loss_of_cx)(0.0))
    eps = 1e-2
    fd = (float(loss_of_cx(eps)) - float(loss_of_cx(-eps))) / (2 * eps)
    # Both should be negative (moving toward the target reduces loss) and
    # agree in magnitude up to the silhouette terms FD sees but AD doesn't.
    assert g < 0 and fd < 0
    assert abs(g - fd) < 0.5 * abs(fd) + 1e-3, (g, fd)


def test_grad_silhouette_matches_fd():
    """Silhouette/visibility gradient (VERDICT r2-r4 open item): a black
    occluder quad in front of a bright infinite background — the loss
    changes ONLY through which pixels the silhouette covers, which the
    interior (detached-sampling) estimator cannot see. Edge sampling
    (prt.diff.silhouette) must recover it to FD accuracy."""
    from prt.diff.silhouette import render_loss_with_silhouette

    xres = yres = 64

    def occluder_scene(cx):
        b = SceneBuilder()
        dark = b.matte(kd=(0.0, 0.0, 0.0))
        s = 0.6
        # Tilted ~15 degrees in-plane: axis-aligned edges cross all pixel
        # centers simultaneously, making the POINT-SAMPLED loss a stair
        # function of cx whose secant diverges from the continuous
        # derivative the estimator computes.
        c15, s15 = np.cos(0.26), np.sin(0.26)
        sq = np.asarray([[-s, -s], [s, -s], [s, s], [-s, s]], np.float32)
        rot = sq @ np.asarray([[c15, s15], [-s15, c15]], np.float32)
        quad = np.concatenate([rot, np.ones((4, 1), np.float32)], axis=1)
        b.add_trianglemesh(np.eye(4), [[0, 1, 2], [0, 2, 3]], quad,
                           material=dark)
        b.add_infinite_light(np.eye(4), L=(1.0, 1.0, 1.0))
        c2w = np.asarray(tf.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0]))
        b.set_camera(cam.build_projective(
            0, c2w, np.asarray(tf.perspective(45.0, 1e-2, 100.0)),
            cam.default_screen_window(xres, yres), xres, yres))
        sc = b.build()
        # theta enters through the mesh vertex positions.
        verts = sc.triangles.verts + jnp.asarray([1.0, 0.0, 0.0]) * cx
        return dataclasses.replace(
            sc, triangles=dataclasses.replace(sc.triangles, verts=verts))

    spp = 4   # jittered sub-pixel samples smooth the loss in cx
    opts = _OPTS._replace(
        xres=xres, yres=yres, chunk_size=xres * yres * spp,
        sampler=SamplerConfig(kind="lowdiscrepancy", pixelsamples=spp))
    lin = np.arange(xres * yres * spp)
    px = jnp.asarray((lin // spp) % xres, jnp.int32)
    py = jnp.asarray((lin // spp) // xres, jnp.int32)
    si = jnp.asarray(lin % spp, jnp.int32)

    rgb_t, _ = R.render(occluder_scene(0.2), opts._replace(driver="scan"))
    target = jnp.asarray(rgb_t)

    def loss_of_cx(cx):
        return render_loss_with_silhouette(
            occluder_scene(cx), opts, px, py, si, target,
            n_edge_samples=4096, seed=3)

    g = float(jax.grad(loss_of_cx)(0.0))
    eps = 1e-1
    fd = (float(loss_of_cx(eps)) - float(loss_of_cx(-eps))) / (2 * eps)
    # The interior gradient alone is ~0 here (flat radiance both sides);
    # everything must come from the boundary term.
    assert fd < -1e-3, fd     # loss decreases toward the target
    assert g < 0, (g, fd)
    # r5: stratified (edge, u) sampling tightened this from 0.25.
    assert abs(g - fd) < 0.10 * abs(fd), (g, fd)


def test_grad_texture_texel_matches_fd():
    """Image-texture texel gradient (VERDICT r3 item 8): d loss / d texel
    flows through the MIPMap lookup chain (textures/graph.py)."""
    import tempfile, os
    from prt.io.exr import write_exr
    from prt.scene.parser import load_scene_string

    tex = np.full((4, 4, 3), 0.5, np.float32)
    with tempfile.TemporaryDirectory() as td:
        write_exr(os.path.join(td, "t.exr"), tex, np.ones((4, 4), np.float32))
        txt = ("Film \"image\" \"integer xresolution\" [16] "
               "\"integer yresolution\" [16]\n"
               "LookAt 0 0 -4  0 0 0  0 1 0\n"
               "Camera \"perspective\" \"float fov\" [45]\n"
               "Sampler \"stratified\" \"integer xsamples\" [1] "
               "\"integer ysamples\" [1] \"bool jitter\" [\"false\"]\n"
               "SurfaceIntegrator \"whitted\" \"integer maxdepth\" [0]\n"
               "WorldBegin\n"
               "LightSource \"point\" \"point from\" [2 2 -3] "
               "\"color I\" [30 30 30]\n"
               "Texture \"tx\" \"color\" \"imagemap\" "
               "\"string filename\" [\"t.exr\"]\n"
               "Material \"matte\" \"texture Kd\" \"tx\"\n"
               "Shape \"trianglemesh\" \"integer indices\" [0 1 2 0 2 3]\n"
               "  \"point P\" [-1 -1 0  1 -1 0  1 1 0  -1 1 0]\n"
               "  \"float uv\" [0 0  1 0  1 1  0 1]\n"
               "WorldEnd\n")
        scene, _ = load_scene_string(txt, basedir=td)

    opts = _OPTS
    px, py, si = _batch()
    target = jnp.zeros((16, 16, 3), jnp.float32)

    def loss_of_scene(sc):
        return render_loss_fn(sc, opts, px, py, si, target)

    g = jax.grad(loss_of_scene, allow_int=True)(scene)
    # Level-0 texel (1,1) red channel.
    lv0 = np.asarray(scene.images[0].levels[0])
    g_tex = np.asarray(g.images[0].levels[0])[1, 1, 0]
    eps = 1e-3

    def with_texel(v):
        import dataclasses as dc
        lv = lv0.copy(); lv[1, 1, 0] = v
        img = dc.replace(scene.images[0],
                         levels=(jnp.asarray(lv),) +
                         scene.images[0].levels[1:])
        return dc.replace(scene, images=(img,) + scene.images[1:])

    fd = (float(loss_of_scene(with_texel(lv0[1, 1, 0] + eps))) -
          float(loss_of_scene(with_texel(lv0[1, 1, 0] - eps)))) / (2 * eps)
    assert abs(fd) > 1e-6, fd     # the texel is actually sampled
    assert abs(g_tex - fd) < 0.03 * max(abs(fd), 1e-4), (g_tex, fd)


def test_grad_camera_translation_matches_fd():
    """Camera-parameter gradient: d loss / d cam2world translation."""
    px, py, si = _batch()
    scene0 = _scene()
    rgb_t, _ = R.render(_scene(), _OPTS._replace(driver="scan"))
    # Target: same scene viewed from a slightly shifted camera.
    c2w_t = np.asarray(scene0.camera.cam2world).copy()
    c2w_t[0, 3] += 0.05
    sc_t = dataclasses.replace(scene0, camera=dataclasses.replace(
        scene0.camera, cam2world=jnp.asarray(c2w_t)))
    rgb_t, _ = R.render(sc_t, _OPTS._replace(driver="scan"))
    target = jnp.asarray(rgb_t)

    def loss_of_dx(dx):
        c2w = jnp.asarray(np.asarray(scene0.camera.cam2world))
        c2w = c2w.at[0, 3].add(dx)
        sc = dataclasses.replace(scene0, camera=dataclasses.replace(
            scene0.camera, cam2world=c2w))
        return render_loss_fn(sc, _OPTS, px, py, si, target)

    g = float(jax.grad(loss_of_dx)(0.0))
    eps = 1e-2
    fd = (float(loss_of_dx(eps)) - float(loss_of_dx(-eps))) / (2 * eps)
    assert fd < 0 and g < 0, (g, fd)
    assert abs(g - fd) < 0.3 * abs(fd) + 1e-4, (g, fd)


def test_grad_multibounce_path_matches_fd():
    """depth>=2 path gradient: albedo grad includes the indirect-bounce
    term (throughput products), not just direct shading."""
    from prt.samplers.samplers import SamplerConfig
    opts = _OPTS._replace(integrator="path", max_depth=2,
                          sampler=SamplerConfig(kind="lowdiscrepancy",
                                                pixelsamples=4),
                          chunk_size=1024)
    px = jnp.asarray(np.arange(1024) % 16 % 16, jnp.int32)
    lin = np.arange(1024)
    px = jnp.asarray((lin // 4) % 16, jnp.int32)
    py = jnp.asarray((lin // 4) // 16, jnp.int32)
    si = jnp.asarray(lin % 4, jnp.int32)
    target = jnp.zeros((16, 16, 3), jnp.float32)

    def loss_of_kd(kd_r):
        sc = _scene(kd=(0.6, 0.3, 0.2))
        fp = jnp.asarray(np.asarray(sc.textures.fparams))
        fp = fp.at[0, 0].set(kd_r)
        sc = dataclasses.replace(sc, textures=dataclasses.replace(
            sc.textures, fparams=fp))
        return render_loss_fn(sc, opts, px, py, si, target)

    g = float(jax.grad(loss_of_kd)(0.6))
    eps = 1e-3
    fd = (float(loss_of_kd(0.6 + eps)) - float(loss_of_kd(0.6 - eps))) / \
        (2 * eps)
    # Path RNG streams are deterministic in the seed and independent of
    # kd for lambertian sampling, so FD differentiates the same smooth
    # function AD does.
    assert abs(fd) > 1e-6
    assert abs(g - fd) < 0.05 * max(abs(fd), 1e-4), (g, fd)


def test_grad_through_bvh_recompute_10k_tris():
    """Translation gradient through the BVH path on a 10K-tri mesh
    (VERDICT r3 item 8): traversal is detached, the winner's t is
    recomputed differentiably (accel/bvh.py)."""
    from prt.scene.build import SceneBuilder

    def make(dx):
        # ~10K-tri sphere: subdivided octahedron, level 5 at build time is
        # heavy — use a UV sphere grid instead.
        n_u, n_v = 72, 36
        us = np.linspace(0, 2 * np.pi, n_u, endpoint=False)
        vs = np.linspace(1e-3, np.pi - 1e-3, n_v)
        U, V = np.meshgrid(us, vs)
        P = np.stack([np.cos(U) * np.sin(V), np.cos(V),
                      np.sin(U) * np.sin(V)], -1).reshape(-1, 3)
        idx = []
        for j in range(n_v - 1):
            for i in range(n_u):
                a = j * n_u + i
                b = j * n_u + (i + 1) % n_u
                c = (j + 1) * n_u + i
                d = (j + 1) * n_u + (i + 1) % n_u
                idx += [[a, b, c], [b, d, c]]
        idx = np.asarray(idx, np.int32)
        b = SceneBuilder()
        mat = b.matte(kd=(0.6, 0.3, 0.2))
        b.add_trianglemesh(np.eye(4), idx, P.astype(np.float32),
                           material=mat)
        b.add_point_light(np.asarray(tf.translate([2.0, 2.0, -3.0])),
                          intensity=(30.0,) * 3)
        c2w = np.asarray(tf.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0]))
        b.set_camera(cam.build_projective(
            0, c2w, np.asarray(tf.perspective(45.0, 1e-2, 100.0)),
            cam.default_screen_window(16, 16), 16, 16))
        sc = b.build()
        from prt.scene.data import BvhAccel
        assert isinstance(sc.accel, BvhAccel), type(sc.accel)
        verts = sc.triangles.verts + jnp.asarray([1.0, 0.0, 0.0]) * dx
        return dataclasses.replace(
            sc, triangles=dataclasses.replace(sc.triangles, verts=verts))

    # Direct differentiable-hit-distance check: rays through the sphere's
    # interior (no silhouette/facet discontinuities, which FD would see
    # but the interior estimator deliberately excludes). The BVH pallas
    # traversal is detached; d t / d translation flows through the
    # winner-triangle recompute (accel/bvh.py -> grid._test_prims).
    from prt.accel import intersect as isect

    n = 256
    # Asymmetric ray grid: a symmetric one makes d t / d dx cancel to 0.
    gx = np.linspace(0.08, 0.42, 16)
    gy = np.linspace(-0.3, 0.3, 16)
    ox, oy = np.meshgrid(gx, gy)
    o = jnp.asarray(np.stack([ox.ravel(), oy.ravel(),
                              np.full(n, -3.0)], -1), jnp.float32)
    d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (n, 1))
    mint = jnp.full((n,), 1e-3)
    maxt = jnp.full((n,), 1e30)

    eps = 1e-3

    def raw(dx):
        t, pid, hit = isect.intersect_ids(make(dx), o, d, mint, maxt)
        return t, hit & (t < 1e6)

    # The BVH is host-built from the UNSHIFTED verts (static accel,
    # moving geometry): rays landing within eps of a triangle edge can
    # lose their winner recompute when the verts move. Restrict the loss
    # to rays stable across the whole FD stencil so AD and FD
    # differentiate the same smooth function.
    mask = raw(-eps)[1] & raw(0.0)[1] & raw(eps)[1]
    assert int(mask.sum()) > 200, int(mask.sum())

    def loss_of_dx(dx):
        t, ok = raw(dx)
        return jnp.sum(jnp.where(mask & ok, t, 0.0))

    g = float(jax.grad(loss_of_dx)(0.0))
    fd = (float(loss_of_dx(eps)) - float(loss_of_dx(-eps))) / (2 * eps)
    assert abs(fd) > 1e-3, fd
    assert abs(g - fd) < 0.02 * abs(fd), (g, fd)


def _floor_camera_scene(cx, light="point", occluder_y=1.5):
    """Matte floor seen obliquely; an occluder quad OUTSIDE the camera
    frustum between the light and the floor, translated by cx. The loss
    changes only through where the occluder's SHADOW falls — a
    secondary-visibility boundary term (VERDICT r5 item 4)."""
    xres = yres = 48
    b = SceneBuilder()
    fl = b.matte(kd=(0.7, 0.7, 0.7))
    dark = b.matte(kd=(0.2, 0.2, 0.2))
    floor = np.asarray([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]],
                       np.float32)
    b.add_trianglemesh(np.eye(4), [[0, 1, 2], [0, 2, 3]], floor,
                       material=fl)
    s = 0.5
    quad = np.asarray([[-s, occluder_y, -s], [s, occluder_y, -s],
                       [s, occluder_y, s], [-s, occluder_y, s]],
                      np.float32)
    mid = b.add_trianglemesh(np.eye(4), [[0, 1, 2], [0, 2, 3]], quad,
                             material=dark)
    if light == "point":
        b.add_point_light(np.asarray(tf.translate([0.0, 4.0, 0.0])),
                          intensity=(25.0,) * 3)
    else:
        lq = np.asarray([[-0.6, 4.0, -0.6], [0.6, 4.0, -0.6],
                         [0.6, 4.0, 0.6], [-0.6, 4.0, 0.6]], np.float32)
        lid = b.add_trianglemesh(np.eye(4), [[0, 1, 2], [0, 2, 3]], lq,
                                 material=dark)
        b.add_area_light_mesh(lid, L=(14.0,) * 3)
    # Camera low and close, narrow fov: the occluder (y=1.5) and light
    # are out of frame; only the floor (and its shadow) is visible.
    c2w = np.asarray(tf.look_at([0, 0.8, -2.8], [0, 0, 0.3], [0, 1, 0]))
    b.set_camera(cam.build_projective(
        0, c2w, np.asarray(tf.perspective(32.0, 1e-2, 100.0)),
        cam.default_screen_window(xres, yres), xres, yres))
    sc = b.build()
    # theta translates the OCCLUDER's vertices only (indices 4..7).
    shift = jnp.zeros_like(sc.triangles.verts).at[4:8, 0].add(cx)
    return dataclasses.replace(
        sc, triangles=dataclasses.replace(
            sc.triangles, verts=sc.triangles.verts + shift))


def _shadow_fd_case(light, n_edge, tol, terms, spp=1):
    from prt.diff.silhouette import render_loss_with_silhouette
    xres = yres = 48
    kind = ("stratified" if spp == 1 else "lowdiscrepancy")
    sampler = (SamplerConfig(kind="stratified", xsamples=1, ysamples=1,
                             jitter=False) if spp == 1 else
               SamplerConfig(kind="lowdiscrepancy", pixelsamples=spp))
    opts = _OPTS._replace(xres=xres, yres=yres, sampler=sampler,
                          integrator="directlighting", max_depth=0,
                          chunk_size=xres * yres * spp)
    lin = np.arange(xres * yres * spp)
    px = jnp.asarray((lin // spp) % xres, jnp.int32)
    py = jnp.asarray((lin // spp) // xres, jnp.int32)
    si = jnp.asarray(lin % spp, jnp.int32)

    rgb_t, _ = R.render(_floor_camera_scene(0.25, light),
                        opts._replace(driver="scan"))
    target = jnp.asarray(rgb_t)

    def loss_of_cx(cx):
        return render_loss_with_silhouette(
            _floor_camera_scene(cx, light), opts, px, py, si, target,
            n_edge_samples=n_edge, seed=5, terms=terms)

    g = float(jax.grad(loss_of_cx)(0.0))
    eps = 5e-2
    fd = (float(loss_of_cx(eps)) - float(loss_of_cx(-eps))) / (2 * eps)
    assert fd < -1e-4, fd          # moving toward the target helps
    assert g < 0, (g, fd)
    assert abs(g - fd) < tol * abs(fd), (g, fd)


def test_grad_shadow_silhouette_point_matches_fd():
    """Point-light shadow boundary: the occluder is out of frame, so the
    ENTIRE gradient is the projected shadow curve's sweep (FD <= 10%,
    VERDICT r5 item 4)."""
    _shadow_fd_case("point", n_edge=4096, tol=0.10, terms=("shadow",))


def test_grad_shadow_silhouette_area_matches_fd():
    """Area-light shadow boundary via the light-plane estimator: the
    penumbra is smooth in the image, so the jump is sampled on the
    EMITTER surface with paired shadow rays."""
    _shadow_fd_case("area", n_edge=4096, tol=0.25, terms=("area",),
                    spp=4)


def test_grad_sphere_rim_matches_fd():
    """Sphere (quadric) rim silhouette: a dark sphere against a bright
    env — the loss moves only through the rim sweep (VERDICT r5 item 4:
    quadric rims were uncovered in r4)."""
    from prt.diff.silhouette import render_loss_with_silhouette
    xres = yres = 48

    def sphere_scene(cx):
        b = SceneBuilder()
        dark = b.matte(kd=(0.0, 0.0, 0.0))
        b.add_sphere(np.eye(4), 0.8, material=dark)
        b.add_infinite_light(np.eye(4), L=(1.0, 1.0, 1.0))
        c2w = np.asarray(tf.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0]))
        b.set_camera(cam.build_projective(
            0, c2w, np.asarray(tf.perspective(45.0, 1e-2, 100.0)),
            cam.default_screen_window(xres, yres), xres, yres))
        sc = b.build()
        o2w = jnp.asarray(np.asarray(sc.quadrics.o2w)).at[0, 0, 3].add(cx)
        w2o = jnp.asarray(np.asarray(sc.quadrics.w2o)).at[0, 0, 3].add(-cx)
        return dataclasses.replace(
            sc, quadrics=dataclasses.replace(sc.quadrics, o2w=o2w,
                                             w2o=w2o))

    opts = _OPTS._replace(xres=xres, yres=yres, integrator="whitted",
                          chunk_size=xres * yres)
    lin = np.arange(xres * yres)
    px = jnp.asarray(lin % xres, jnp.int32)
    py = jnp.asarray(lin // xres, jnp.int32)
    si = jnp.zeros(xres * yres, jnp.int32)
    rgb_t, _ = R.render(sphere_scene(0.15), opts._replace(driver="scan"))
    target = jnp.asarray(rgb_t)

    def loss_of_cx(cx):
        return render_loss_with_silhouette(
            sphere_scene(cx), opts, px, py, si, target,
            n_edge_samples=2048, seed=7, terms=("rim",))

    g = float(jax.grad(loss_of_cx)(0.0))
    eps = 5e-2
    fd = (float(loss_of_cx(eps)) - float(loss_of_cx(-eps))) / (2 * eps)
    assert fd < -1e-3 and g < 0, (g, fd)
    assert abs(g - fd) < 0.10 * abs(fd), (g, fd)


def test_train_step_sharded_silhouette_flag():
    """train_step_sharded(boundary=True) carries the visibility term:
    on the occluder scene the interior-only grad is ~0 while the
    boundary-augmented grad matches the FD sign and magnitude."""
    from jax.sharding import Mesh
    from prt.parallel import shard as sh
    from prt.diff.silhouette import mesh_edges

    sc = _floor_camera_scene(0.0, "point")
    xres = yres = 48
    sampler = SamplerConfig(kind="stratified", xsamples=1, ysamples=1,
                            jitter=False)
    opts = _OPTS._replace(xres=xres, yres=yres, sampler=sampler,
                          integrator="directlighting", max_depth=0,
                          chunk_size=xres * yres)
    rgb_t, _ = R.render(_floor_camera_scene(0.25, "point"),
                        opts._replace(driver="scan"))
    target = jnp.asarray(rgb_t)
    lin = np.arange(xres * yres)
    px = jnp.asarray(lin % xres, jnp.int32)
    py = jnp.asarray(lin // xres, jnp.int32)
    si = jnp.zeros(xres * yres, jnp.int32)
    mesh = sh.make_mesh(2)
    topo = mesh_edges(np.asarray(sc.triangles.idx))

    loss0, g0 = sh.train_step_sharded(sc, opts, target, px, py, si, mesh)
    loss1, g1 = sh.train_step_sharded(sc, opts, target, px, py, si, mesh,
                                      boundary=True, topology=topo,
                                      n_edge_samples=2048)
    assert abs(float(loss0) - float(loss1)) < 1e-5   # value unchanged
    gv0 = float(np.asarray(g0.triangles.verts)[4:8, 0].sum())
    gv1 = float(np.asarray(g1.triangles.verts)[4:8, 0].sum())
    assert abs(gv0) < 1e-3 * max(abs(gv1), 1e-9), (gv0, gv1)
    assert gv1 < 0, gv1           # toward the target (occluder at +0.25)

"""Correctness-sweep regression tests (round-2 VERDICT items):
multi-env-light double counting, bump mapping, integrator t_first plumbing,
and an Adam inverse-rendering recovery loop (BASELINE config 5 shape).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from prt import render as R
from prt.core import transform as tf
from prt.cameras import cameras as cam
from prt.integrators import common
from prt.scene.build import SceneBuilder
from prt.samplers import samplers as smp
from prt.textures.graph import TexNodeMeta


def _ground_plane(b, mat, s=5.0, y=0.0):
    P = np.asarray([[-s, y, -s], [-s, y, s], [s, y, s], [s, y, -s]],
                   np.float32)  # wound so the geometric normal faces +y
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return b.add_trianglemesh(np.eye(4), [[0, 1, 2], [0, 2, 3]], P,
                              uv=uv, material=mat)


def _down_ray_hits(scene, xs, zs, y0=2.0):
    from prt.accel import intersect as isect
    n = len(xs)
    o = jnp.stack([jnp.asarray(xs), jnp.full((n,), y0),
                   jnp.asarray(zs)], -1).astype(jnp.float32)
    d = jnp.broadcast_to(jnp.asarray([0.0, -1.0, 0.0], jnp.float32), (n, 3))
    t, pid, hit = isect.intersect_ids(scene, o, d, jnp.full((n,), 1e-3),
                                      jnp.full((n,), 1e30))
    assert bool(np.all(np.asarray(hit)))
    dg = isect.hit_geometry(scene, pid, o, d, t)
    return o, d, dg


def test_estimate_direct_no_multi_env_double_count():
    """With two env lights (pure red, pure green), EstimateDirect for the
    red light must contribute zero green: the BSDF-strategy escape has to
    use THIS light's Le, not the sum over all infinite lights
    (core/transport.cpp:181-188; r1 VERDICT weak #5)."""
    b = SceneBuilder()
    mat = b.matte(kd=(0.7, 0.7, 0.7))
    _ground_plane(b, mat)
    b.add_infinite_light(np.eye(4), L=(1.0, 0.0, 0.0))
    b.add_infinite_light(np.eye(4), L=(0.0, 1.0, 0.0))
    scene = b.build()

    n = 64
    rng = np.random.default_rng(0)
    o, d, dg = _down_ray_hits(scene, rng.uniform(-1, 1, n).astype(np.float32),
                              rng.uniform(-1, 1, n).astype(np.float32))
    bsdf = common.make_bsdf_at(scene, dg)
    lid = jnp.zeros((n,), jnp.int32)  # the red env light
    u = lambda k: jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    active = jnp.ones((n,), bool)
    Ld = common.estimate_direct(scene, lid, dg["p"], bsdf.nn, -d, bsdf,
                                u(0), u(1), u(2), u(3), u(4), u(5), active)
    Ld = np.asarray(Ld)
    assert Ld[..., 0].mean() > 0.0          # red contributes
    assert np.all(Ld[..., 1] < 1e-6)        # zero green leakage
    assert np.all(Ld[..., 2] < 1e-6)


def test_bump_mapping_perturbs_shading_normal():
    """A matte plane with an FBm bumpmap must produce spatially varying
    shading normals; a constant bumpmap must leave them untouched
    (core/material.cpp:29-71)."""
    def plane_scene(bump_kind):
        b = SceneBuilder()
        if bump_kind == "fbm":
            v = np.zeros(16, np.float32)
            v[0] = 6
            v[1] = 0.5
            bump = b.add_texture(TexNodeMeta(kind="fbm", mapping="3d"),
                                 fparams=v)
        elif bump_kind == "const":
            bump = b.constant_texture(0.25)
        else:
            bump = -1
        mat = b.add_material("matte", [b.constant_texture((0.6,) * 3),
                                       b.constant_texture(0.0)], bump=bump)
        _ground_plane(b, mat)
        b.add_point_light(np.asarray(tf.translate([0, 4, 0])),
                          intensity=(10.0,) * 3)
        return b.build()

    n = 128
    rng = np.random.default_rng(1)
    xs = rng.uniform(-3, 3, n).astype(np.float32)
    zs = rng.uniform(-3, 3, n).astype(np.float32)

    scene_f = plane_scene("fbm")
    assert scene_f.materials.has_bump
    _, d, dg = _down_ray_hits(scene_f, xs, zs)
    sn = np.asarray(common.make_bsdf_at(scene_f, dg).nn)
    np.testing.assert_allclose(np.linalg.norm(sn, axis=-1), 1.0, atol=1e-4)
    assert sn[:, 0].std() > 1e-3            # normals vary across the plane
    assert np.all(sn[:, 1] > 0.0)           # still upward facing

    # Constant displacement -> unchanged flat normals (derivative is zero).
    scene_c = plane_scene("const")
    _, d, dg = _down_ray_hits(scene_c, xs, zs)
    sn_c = np.asarray(common.make_bsdf_at(scene_c, dg).nn)
    np.testing.assert_allclose(
        sn_c, np.broadcast_to(np.asarray([0, 1, 0], np.float32), sn_c.shape),
        atol=1e-5)


def test_integrator_returns_camera_segment_t():
    """Every integrator returns the first-hit t so the driver's volume
    composition reuses it instead of re-intersecting (r1 VERDICT weak #6)."""
    from prt.integrators import whitted, path, directlighting, debug
    b = SceneBuilder()
    mat = b.matte()
    b.add_sphere(np.asarray(tf.translate([0, 0, 2.0])), 0.5, material=mat)
    b.add_point_light(np.asarray(tf.translate([2, 2, 0])), (5.0,) * 3)
    scene = b.build()

    n = 8
    o = jnp.zeros((n, 3), jnp.float32)
    d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], jnp.float32), (n, 3))
    mint = jnp.full((n,), 1e-3)
    maxt = jnp.full((n,), 1e30)
    cfg = smp.SamplerConfig()
    px = py = s_idx = jnp.zeros((n,), jnp.int32)
    for fn in (lambda: whitted.li(scene, o, d, mint, maxt, cfg, px, py,
                                  s_idx),
               lambda: path.li(scene, o, d, mint, maxt, cfg, px, py, s_idx),
               lambda: directlighting.li(scene, o, d, mint, maxt, cfg, px,
                                         py, s_idx),
               lambda: debug.li(scene, o, d, mint, maxt)):
        out = fn()
        t_first = np.asarray(out[2])
        np.testing.assert_allclose(t_first, 1.5, atol=1e-3)


def test_adam_recovers_albedo():
    """Inverse rendering (BASELINE config 5 shape): recover a matte sphere's
    albedo from a target image with an Adam loop, not just one step."""
    import optax
    from prt.parallel import shard

    def build(albedo):
        b = SceneBuilder()
        mat = b.matte(kd=albedo)
        b.add_sphere(np.asarray(tf.translate([0, 0, 2.0])), 0.6, material=mat)
        b.add_point_light(np.asarray(tf.translate([2, 3, -1])), (12.0,) * 3)
        xres = yres = 24
        c2w = np.eye(4, dtype=np.float32)
        b.set_camera(cam.build_projective(
            0, c2w, np.asarray(tf.perspective(45.0, 1e-2, 100.0)),
            cam.default_screen_window(xres, yres), xres, yres))
        return b.build()

    opts = R.RenderOptions(xres=24, yres=24, integrator="whitted",
                           sampler=smp.SamplerConfig(kind="lowdiscrepancy",
                                                     pixelsamples=1),
                           chunk_size=24 * 24)
    true_albedo = (0.8, 0.3, 0.5)
    target_img, _ = R.render(build(true_albedo), opts)
    target = jnp.asarray(target_img)

    scene = build((0.4, 0.6, 0.2))  # wrong initial albedo
    tex0 = scene.textures.fparams

    lin = np.arange(24 * 24)
    px = jnp.asarray(lin % 24, jnp.int32)
    py = jnp.asarray(lin // 24, jnp.int32)
    s_idx = jnp.zeros_like(px)

    def loss_fn(fp):
        sc = dataclasses.replace(
            scene, textures=dataclasses.replace(scene.textures, fparams=fp))
        return shard.render_loss_fn(sc, opts, px, py, s_idx, target)

    vg = jax.jit(jax.value_and_grad(loss_fn))
    opt = optax.adam(0.05)
    state = opt.init(tex0)
    fp = tex0
    l0 = None
    for i in range(80):
        loss, g = vg(fp)
        if l0 is None:
            l0 = float(loss)
        upd, state = opt.update(g, state)
        fp = optax.apply_updates(fp, upd)
    assert float(loss) < 0.05 * l0  # converged
    rec = np.asarray(fp[0, 0:3])    # the sphere's kd constant node
    np.testing.assert_allclose(rec, true_albedo, atol=0.05)

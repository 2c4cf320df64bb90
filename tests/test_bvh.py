"""Skip-link BVH: build invariants + traversal parity vs brute force."""
import numpy as np
import jax.numpy as jnp
import pytest

from prt.scene.parser import load_scene_string
from prt.accel import intersect as isect
from prt.accel import bvh as bvh_mod
from prt.accel.bvh_build import build_bvh
from prt.scene.data import BvhAccel
import dataclasses


def _random_mesh_scene(ntri=400, seed=0):
    rng = np.random.default_rng(seed)
    tris = []
    for _ in range(ntri):
        c = rng.uniform(-1, 1, 3)
        v = c + rng.uniform(-0.08, 0.08, (3, 3))
        tris.append(v)
    pts = np.concatenate(tris).reshape(-1, 3)
    idx = np.arange(3 * ntri)
    body = "Shape \"trianglemesh\" \"integer indices\" [" + \
        " ".join(str(i) for i in idx) + "] \"point P\" [" + \
        " ".join(f"{x:.5f}" for x in pts.ravel()) + "]\n"
    txt = ("Film \"image\" \"integer xresolution\" [16] "
           "\"integer yresolution\" [16]\n"
           "Camera \"perspective\" \"float fov\" [60]\n"
           "WorldBegin\n"
           "Material \"matte\" \"color Kd\" [0.5 0.5 0.5]\n" + body +
           "WorldEnd\n")
    scene, opts = load_scene_string(txt)
    return scene


def _rays(n, seed=1):
    rng = np.random.default_rng(seed)
    o = jnp.asarray(rng.uniform(-2.5, 2.5, (n, 3)), jnp.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d, jnp.float32)
    mint = jnp.full((n,), 1e-3)
    maxt = jnp.full((n,), 1e30)
    return o, d, mint, maxt


def test_build_invariants():
    scene = _random_mesh_scene(100)
    bvh = build_bvh(scene)
    nodes = np.asarray(bvh.nodes)
    nn = bvh.n_nodes
    skip = nodes[:, 6].astype(int)
    nprims = nodes[:, 7].astype(int)
    assert (skip > np.arange(nn)).all() and (skip <= nn).all()
    assert (nprims <= bvh.leaf_k).all()
    ids = np.asarray(bvh.prim_ids)
    assert sorted(ids[ids >= 0].tolist()) == list(range(100))
    # Leaf-inlined prim ids mirror prim_ids.
    row_ids = nodes[:, 80:88].astype(int)
    leaf_rows = nprims > 0
    got = sorted(int(row_ids[i, j]) for i in np.where(leaf_rows)[0]
                 for j in range(nprims[i]))
    assert got == list(range(100))


def test_traversal_matches_brute_force():
    scene = _random_mesh_scene(400)
    bvh = build_bvh(scene)
    scene_bvh = dataclasses.replace(scene, accel=bvh)
    o, d, mint, maxt = _rays(512)
    t_ref, id_ref, hit_ref = isect._brute_force(scene, o, d, mint, maxt)
    t_b, id_b, hit_b = bvh_mod.intersect(scene_bvh, o, d, mint, maxt)
    assert (np.asarray(hit_b) == np.asarray(hit_ref)).all()
    m = np.asarray(hit_ref)
    np.testing.assert_allclose(np.asarray(t_b)[m], np.asarray(t_ref)[m],
                               rtol=2e-5, atol=2e-5)
    assert (np.asarray(id_b)[m] == np.asarray(id_ref)[m]).all()


def test_any_hit_agrees():
    scene = _random_mesh_scene(400, seed=3)
    scene_bvh = dataclasses.replace(scene, accel=build_bvh(scene))
    o, d, mint, _ = _rays(512, seed=4)
    maxt = jnp.full((512,), 1.5)
    _, _, hit_ref = isect._brute_force(scene, o, d, mint, maxt)
    _, _, hit_b = bvh_mod.intersect(scene_bvh, o, d, mint, maxt,
                                    any_hit=True)
    assert (np.asarray(hit_b) == np.asarray(hit_ref)).all()


def test_mixed_quadric_scene():
    txt = ("Film \"image\" \"integer xresolution\" [16] "
           "\"integer yresolution\" [16]\n"
           "Camera \"perspective\" \"float fov\" [60]\n"
           "Accelerator \"bvh\"\n"
           "WorldBegin\n"
           "Material \"matte\" \"color Kd\" [0.5 0.5 0.5]\n"
           "AttributeBegin\n"
           "  Translate -0.5 0 2\n"
           "  Shape \"sphere\" \"float radius\" [0.4]\n"
           "AttributeEnd\n"
           "Shape \"trianglemesh\" \"integer indices\" [0 1 2]\n"
           "  \"point P\" [0.2 -0.5 2  1.2 -0.5 2  0.7 0.6 2]\n"
           "WorldEnd\n")
    scene, opts = load_scene_string(txt)
    assert isinstance(scene.accel, BvhAccel)
    scene_nb = dataclasses.replace(scene, accel=None)
    o, d, mint, maxt = _rays(256, seed=7)
    t_ref, id_ref, hit_ref = isect._brute_force(scene_nb, o, d, mint, maxt)
    t_b, id_b, hit_b = isect.intersect_ids(scene, o, d, mint, maxt)
    assert (np.asarray(hit_b) == np.asarray(hit_ref)).all()
    m = np.asarray(hit_ref)
    np.testing.assert_allclose(np.asarray(t_b)[m], np.asarray(t_ref)[m],
                               rtol=2e-5, atol=2e-5)



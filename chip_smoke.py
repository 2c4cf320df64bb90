#!/usr/bin/env python
"""Proof on the card that the render path runs on an NVIDIA GPU.

Drives the entry points a user calls (pbrt.py; load_scene -> render.render;
parallel/shard.py) at full scene and frame sizes, checks each traversal
kernel against the jnp reference walk at real widths (and a sample of the
rays against brute force), checks the images against the reference
goldens, and runs one inverse-rendering step.

    python chip_smoke.py                  # one card: phases 1-4
    python chip_smoke.py --four           # four cards: phase 5 only

Phases: 1 device, 2 kernels vs reference, 3 full-size renders,
4 gradient, 5 (--four) sharded render and gradients on 4 cards vs 1.
Exits non-zero, with no result line, when JAX finds no GPU or a phase
fails. The last line of a passing run is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
SCENES = os.path.join(HERE, "scenes")
OUT = os.path.join(HERE, "chiprun_out", "chip_smoke")
CARD = "card unknown"
T_BAND = 2e-5          # kernel vs walk t band (tests/test_bvh.py)
# Rays of each phase-2 batch also checked against brute force over every
# triangle, and how many of them may differ: the brute force computes the
# edge tests in another order, so a ray through a shared edge or vertex can
# miss both triangles in one and not in the other.
N_BRUTE = 4096
BRUTE_SLACK = N_BRUTE // 1000
RENDER_BAND = 1e-4     # mean |a - b| / mean for same-seed renders
GRAD_BAND = 1e-4       # 4-card vs 1-card gradients, per leaf
# Golden bands (mean-energy, blurred-region) of tests/test_golden.py for
# config3 (bench3 is the same scene) and config4; bench6's is about twice
# the error measured once on the card (CHANGES.md).
BANDS = {"bench3": (0.03, 0.10), "config4_big": (0.01, 0.02),
         "bench6": (0.06, 0.11)}


def log(msg):
    print(f"[{CARD}] {msg}", flush=True)


def card_name():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


class Timer:
    def __init__(self, what):
        self.what = what

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.s = time.time() - self.t0
        if exc[0] is None:
            log(f"{self.what}: {self.s:.3f} s")


# --- phase 1 ------------------------------------------------------------

def phase_device():
    global CARD
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX platform is {devs[0].platform!r}")
    CARD = card_name()
    from prt import native
    from prt.utils.jax_cache import enable_compile_cache
    cache = enable_compile_cache()
    log(f"device_kind={devs[0].device_kind} count={len(devs)} "
        f"jax={jax.__version__} XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}"
        f" compile_cache={cache} "
        f"native_bvh_builder={native.load('bvh_build8') is not None}")
    return devs


# --- phase 2 ------------------------------------------------------------

def _probe_rays(scene, opts, n, seed):
    """n camera rays over the film, cosine bounce rays from their hits
    (nearest and any hit), and shadow rays toward the scene's distant
    light (or straight up)."""
    import numpy as np
    import jax.numpy as jnp
    from prt.accel import intersect as isect
    from prt.cameras import cameras as cam_mod
    from prt.core import mc, vecmath as vm
    from prt.scene.data import LIGHT_DISTANT

    cam = scene.camera
    xres, yres = opts.xres, opts.yres
    r = np.random.default_rng(seed)
    u = jnp.asarray(r.random((5, n)), jnp.float32)
    o, d, mint, maxt, _ = cam_mod.generate_rays(
        cam, u[0] * xres, u[1] * yres, u[2], u[2], u[2], xres, yres)
    t, pid, hit = isect.intersect_ids(scene, o, d, mint, maxt)
    dg = isect.hit_geometry_light(scene, jnp.maximum(pid, 0), o, d, t)
    nrm = vm.face_forward(dg["nn"], -d)
    p = o + jnp.where(hit, t, 0.0)[:, None] * d
    loc = mc.cosine_sample_hemisphere(u[3], u[4])
    _, s1, s2 = vm.coordinate_system(nrm)
    bd = s1 * loc[..., 0:1] + s2 * loc[..., 1:2] + nrm * loc[..., 2:3]
    kinds = np.asarray(scene.lights.kind)
    dist = np.nonzero(kinds == LIGHT_DISTANT)[0]
    ld = np.asarray(scene.lights.params)[dist[0], 0:3] if len(dist) else \
        np.asarray([0.0, 1.0, 0.0], np.float32)
    sd = jnp.broadcast_to(jnp.asarray(ld, jnp.float32), (n, 3))
    eps = jnp.full((n,), 1e-3, jnp.float32)
    big = jnp.full((n,), 1e30, jnp.float32)
    empty_lo = jnp.where(hit, eps, 1.0)
    empty_hi = jnp.where(hit, big, -1.0)
    return {"camera": (o, d, mint, maxt),
            "bounce": (p, bd, empty_lo, empty_hi),
            "bounce any-hit": (p, bd, empty_lo, empty_hi),
            "shadow": (p, sd, empty_lo, empty_hi)}


def _check_pair(name, ref, ker, any_hit, ids_of=lambda r: r[1], slack=0):
    """ref/ker: (t, id, ...) from a reference and from the kernel; at most
    `slack` rays may disagree."""
    import numpy as np
    t_r, t_k = np.asarray(ref[0]), np.asarray(ker[0])
    i_r, i_k = np.asarray(ids_of(ref)), np.asarray(ids_of(ker))
    h_r, h_k = i_r >= 0, i_k >= 0
    n_mask = int((h_r != h_k).sum())
    both = h_r & h_k
    if any_hit:
        log(f"{name}: {h_r.sum()} of {len(h_r)} occluded, "
            f"hit-mask mismatches {n_mask}")
        if n_mask > slack:
            raise AssertionError(f"{name}: any-hit masks differ on {n_mask}")
        return
    diff = both & (i_r != i_k)
    tie = diff & (np.abs(t_r - t_k) <= 1e-6 * np.maximum(1.0, np.abs(t_r)))
    bad_t = both & ~np.isclose(t_k, t_r, rtol=T_BAND, atol=T_BAND)
    log(f"{name}: {h_r.sum()} of {len(h_r)} hit, hit-mask mismatches "
        f"{n_mask}, id mismatches {int(diff.sum())} of which exact-t ties "
        f"{int(tie.sum())}, t outside band {int(bad_t.sum())}, max |dt| "
        f"{float(np.abs(t_r - t_k)[both].max(initial=0.0)):.3g}")
    if n_mask + int((diff & ~tie).sum()) + int(bad_t.sum()) > slack:
        raise AssertionError(f"{name}: kernel and reference disagree")


def _timed(fn, *args):
    import jax
    jax.block_until_ready(fn(*args))             # compile + warm
    t0 = time.time()
    out = jax.block_until_ready(fn(*args))
    return out, time.time() - t0


def _brute_force(scene, o, d, mint, maxt, chunk=128):
    """(t, prim id) of every ray against every triangle, no tree: the
    all-pairs test of accel/intersect.py over chunks of rays."""
    import jax
    from prt.accel import intersect as isect

    def one(ray):
        return isect._brute_force(scene, *ray)[:2]
    k = o.shape[0] // chunk
    return jax.lax.map(one, tuple(a.reshape(k, chunk, *a.shape[1:])
                                  for a in (o, d, mint, maxt)))


def _compare_bvh(name, scene, opts, n_rays):
    """The kernel against the jnp walk on every ray, and against brute
    force on the first N_BRUTE: the kernel and the walk share one loop
    (ops/bvh_walk.walk), so only the brute force checks the walk's logic
    on the card."""
    import functools
    import jax
    from prt.ops import bvh_walk
    bvh = scene.accel
    rays = _probe_rays(scene, opts, n_rays, seed=1)
    brute = jax.jit(_brute_force)
    for kind, (o, d, mint, maxt) in rays.items():
        any_hit = kind in ("shadow", "bounce any-hit")
        kw = dict(nn=bvh.n_nodes, leaf_k=bvh.leaf_k, any_hit=any_hit)
        walk = jax.jit(functools.partial(bvh_walk.walk_rays, **kw))
        kern = functools.partial(bvh_walk.traverse, **kw)
        ref, s_w = _timed(walk, bvh.nodes, o, d, mint, maxt)
        ker, s_k = _timed(kern, bvh.nodes, o, d, mint, maxt)
        log(f"{name} {kind} x{n_rays}: kernel {1e3 * s_k:.3f} ms, "
            f"jnp walk {1e3 * s_w:.3f} ms")
        _check_pair(f"{name} {kind}", ref, ker, any_hit)
        bf = [a.reshape(-1) for a in brute(
            scene, o[:N_BRUTE], d[:N_BRUTE], mint[:N_BRUTE],
            maxt[:N_BRUTE])]
        _check_pair(f"{name} {kind} vs brute force", bf,
                    [a[:N_BRUTE] for a in ker], any_hit, slack=BRUTE_SLACK)


def instanced_scene_text(n_side=32, subdiv=4, res=512, spp=4):
    """n_side^2 instances of one bumpy icosphere prototype (one of them
    mirrored) on a ground plane, direct lighting at res^2 x spp."""
    import numpy as np
    sys.path.insert(0, os.path.join(HERE, "tools"))
    from make_scenes import icosphere, mesh_stanza
    v, f = icosphere(subdiv)
    v = v * (1.0 + 0.15 * np.sin(7.0 * v[:, :1]) * np.cos(5.0 * v[:, 2:]))
    r = np.random.default_rng(3)
    s = (f'Film "image" "integer xresolution" [{res}] '
         f'"integer yresolution" [{res}]\n'
         "LookAt 0 9 -15  0 0 0  0 1 0\n"
         'Camera "perspective" "float fov" [50]\n'
         f'Sampler "lowdiscrepancy" "integer pixelsamples" [{spp}]\n'
         'PixelFilter "box" "float xwidth" [0.5] "float ywidth" [0.5]\n'
         'SurfaceIntegrator "directlighting"\nWorldBegin\n'
         'LightSource "distant" "point from" [3 6 -4] "point to" [0 0 0] '
         '"color L" [2.2 2.1 1.9]\n'
         'LightSource "infinite" "color L" [0.3 0.35 0.4]\n'
         'Material "matte" "color Kd" [0.6 0.55 0.5]\n'
         'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]\n'
         '  "point P" [-30 -0.6 -30  30 -0.6 -30  30 -0.6 30  -30 -0.6 30]\n'
         'ObjectBegin "rock"\n'
         'Material "matte" "color Kd" [0.3 0.5 0.8]\n'
         + mesh_stanza(v, f) + "ObjectEnd\n")
    for i in range(n_side * n_side):
        x = (i % n_side - n_side / 2 + 0.5) * 1.1
        z = (i // n_side - n_side / 2 + 0.5) * 1.1
        mirror = "  Scale -1 1 1\n" if i == 0 else ""
        s += (f"AttributeBegin\n  Translate {x:.3f} 0 {z:.3f}\n"
              f"  Rotate {r.uniform(0, 360):.2f} 0 1 0\n"
              f"  Scale {r.uniform(0.3, 0.5):.3f} {r.uniform(0.3, 0.6):.3f}"
              f" {r.uniform(0.3, 0.5):.3f}\n{mirror}"
              '  ObjectInstance "rock"\nAttributeEnd\n')
    return s + "WorldEnd\n"


def _compare_instanced(scene, opts, n_rays):
    import functools
    import jax
    from prt.ops import bvh_walk
    inst = scene.instances
    rays = _probe_rays(scene, opts, n_rays, seed=2)
    tab = (inst.nodes, inst.inst_bbox, inst.inst_range,
           inst.inst_w2o.reshape(inst.count, 16))
    for kind, ray in rays.items():
        any_hit = kind in ("shadow", "bounce any-hit")
        kw = dict(leaf_k=inst.leaf_k, any_hit=any_hit)
        walk = jax.jit(functools.partial(bvh_walk.walk_instanced, **kw))
        kern = functools.partial(bvh_walk.traverse_instanced, **kw)
        ref, s_w = _timed(walk, *tab, *ray)
        ker, s_k = _timed(kern, *tab, *ray)
        log(f"instanced {kind} x{n_rays} ({inst.count} instances): kernel "
            f"{1e3 * s_k:.3f} ms, jnp walk {1e3 * s_w:.3f} ms")
        # Compare (instance, proto tri) pairs: one code per hit.
        _check_pair(f"instanced {kind}", ref, ker, any_hit,
                    ids_of=lambda r: r[2] * inst.n_tris + r[1])


def load_big_scenes():
    import bench
    from prt.scene.parser import load_scene, load_scene_string
    with Timer("set-up: parse + BVH build, config4_big"):
        c4 = load_scene(os.path.join(SCENES, "config4_big.pbrt"))
    with Timer("set-up: build + BVH build, config5_huge"):
        c5 = bench.build_config5_scene()
    with Timer("set-up: parse + BLAS build, instanced scene"):
        ins = load_scene_string(instanced_scene_text())
    return {"config4_big": c4, "config5_huge": c5[:2], "instanced": ins}


def phase_kernels(scenes, n_rays=1 << 17):
    for name in ("config4_big", "config5_huge"):
        scene, opts = scenes[name]
        log(f"{name}: {scene.triangles.count} triangles, "
            f"{scene.accel.n_nodes} nodes "
            f"({scene.accel.nodes.nbytes / 2**20:.1f} MiB table)")
        _compare_bvh(name, scene, opts, n_rays)
    scene, opts = scenes["instanced"]
    log(f"instanced: {scene.instances.count} instances of "
        f"{scene.instances.n_tris} triangles")
    _compare_instanced(scene, opts, n_rays)


# --- phase 3 ------------------------------------------------------------

class PoolMemory:
    """Prints compiled.memory_analysis() of each wavefront pool step."""

    def __enter__(self):
        from prt.integrators import path_wavefront as pw
        self.pw, self.orig = pw, pw._jrun

        def jrun(scene, film, st, cursor, aux=None, **kw):
            c = self.orig.lower(scene, film, st, cursor, aux, **kw).compile()
            m = c.memory_analysis()
            log(f"pool step memory ({kw['mode']}, {st['o'].shape[0]} "
                f"lanes): args {m.argument_size_in_bytes / 2**20:.1f} MiB, "
                f"temp {m.temp_size_in_bytes / 2**20:.1f} MiB, out "
                f"{m.output_size_in_bytes / 2**20:.1f} MiB")
            return c(scene, film, st, cursor, aux)
        pw._jrun = jrun
        return self

    def __exit__(self, *exc):
        self.pw._jrun = self.orig


def golden_metric(rgb, ref):
    """(mean-energy error, blurred-region error) of tests/test_golden.py:
    4x4 block means at equal sizes; otherwise block means on the largest
    grid that divides both images (square images)."""
    import math
    import numpy as np

    def down(x, n):
        k = x.shape[0] // n
        return x.reshape(n, k, n, k, -1).mean((1, 3))
    if rgb.shape == ref.shape:
        n = rgb.shape[0] // 4
        dr, dm = down(ref[:4 * n, :4 * n], n), down(rgb[:4 * n, :4 * n], n)
    else:
        n = math.gcd(rgb.shape[0], ref.shape[0])
        dr, dm = down(ref, n), down(rgb, n)
    lit = dr.mean(-1) > 0.02
    rel = (np.abs(dr - dm).mean(-1)[lit] /
           np.maximum(dr.mean(-1)[lit], 1e-3)).mean()
    return abs(rgb.mean() - ref.mean()) / max(ref.mean(), 1e-3), float(rel)


def _check_golden(name, rgb, golden):
    import numpy as np
    from prt.io.exr import read_exr
    if not np.isfinite(rgb).all():
        raise AssertionError(f"{name}: non-finite pixels")
    ref, _ = read_exr(os.path.join(SCENES, golden))
    e_mean, e_blur = golden_metric(rgb, ref)
    b_mean, b_blur = BANDS[name]
    log(f"{name} vs {golden}: mean error {e_mean:.5f} (band {b_mean}), "
        f"blurred error {e_blur:.5f} (band {b_blur})")
    if e_mean > b_mean or e_blur > b_blur:
        raise AssertionError(f"{name}: outside the golden band")


def _render(name, scene, opts):
    import numpy as np
    from prt import render as R
    with Timer(f"render {name} {opts.xres}x{opts.yres} "
               f"(first, incl. compile)"):
        rgb, _ = R.render(scene, opts._replace(half_readback=True))
    if not np.isfinite(rgb).all():
        raise AssertionError(f"{name}: non-finite pixels")
    return rgb


def phase_renders(scenes):
    import numpy as np
    import pbrt
    from prt.io.exr import read_exr
    from prt.scene.parser import load_scene
    os.makedirs(OUT, exist_ok=True)
    with PoolMemory():
        exr = os.path.join(OUT, "bench3.exr")
        with Timer("pbrt.py scenes/bench3.pbrt (incl. compile)"):
            pbrt.main([os.path.join(SCENES, "bench3.pbrt"), "-o", exr,
                       "--quiet"])
        # golden3.exr: the reference's render of this scene at 96^2.
        _check_golden("bench3", read_exr(exr)[0], "golden3.exr")

        scene, opts = scenes["config4_big"]
        _check_golden("config4_big", _render("config4_big", scene, opts),
                      "bench4.exr")

        scene, opts = load_scene(os.path.join(SCENES, "bench6.pbrt"))
        _check_golden("bench6", _render("bench6", scene, opts),
                      "bench6.exr")

        scene, opts = scenes["config5_huge"]
        a = _render("config5_huge kernel", scene, opts)
        walk = dataclasses.replace(scene, accel=dataclasses.replace(
            scene.accel, traversal="jnp"))
        b = _render("config5_huge jnp walk", walk, opts)
        rel = float(np.abs(a - b).mean() / max(b.mean(), 1e-12))
        log(f"config5_huge kernel vs jnp walk: mean |diff| / mean {rel:.3g}"
            f" (band {RENDER_BAND})")
        if rel > RENDER_BAND:
            raise AssertionError("config5_huge: kernel render differs")

        scene, opts = scenes["instanced"]
        rgb = _render("instanced", scene, opts)
        log(f"instanced image mean {float(rgb.mean()):.5f}")
        if not rgb.mean() > 0:
            raise AssertionError("instanced: black image")


# --- phases 4 and 5 -----------------------------------------------------

def _grad_setup(res=64, spp=4):
    import numpy as np
    import jax.numpy as jnp
    from __graft_entry__ import _flagship_scene
    from prt import render as R
    from prt.samplers.samplers import SamplerConfig
    scene = _flagship_scene(res, res)
    opts = R.RenderOptions(
        xres=res, yres=res,
        sampler=SamplerConfig(kind="lowdiscrepancy", pixelsamples=spp),
        filter_kind="box", filter_xwidth=0.5, filter_ywidth=0.5,
        integrator="path", max_depth=3, chunk_size=1 << 14)
    lin = np.arange(res * res * spp)
    px = jnp.asarray((lin // spp) % res, jnp.int32)
    py = jnp.asarray((lin // spp) // res, jnp.int32)
    si = jnp.asarray(lin % spp, jnp.int32)
    target = jnp.zeros((res, res, 3), jnp.float32)
    return scene, opts, px, py, si, target


def _with_radiance(scene, light, delta):
    sp = scene.lights.spectrum.at[light].add(delta)
    return dataclasses.replace(scene, lights=dataclasses.replace(
        scene.lights, spectrum=sp))


def phase_gradient():
    import numpy as np
    import jax
    from prt.parallel import shard
    scene, opts, px, py, si, target = _grad_setup()
    mesh = shard.make_mesh(1)
    with Timer("train_step_sharded, 1-device mesh, 64x64 (incl. compile)"):
        loss, grads = shard.train_step_sharded(scene, opts, target, px, py,
                                               si, mesh)
        jax.block_until_ready(grads)
    leaves = [np.asarray(g) for g in jax.tree.leaves(grads)]
    if not leaves or not all(np.isfinite(g).all() for g in leaves):
        raise AssertionError("non-finite gradients")
    # Finite difference along the area light's radiance (all channels).
    light = int(np.nonzero(np.asarray(scene.lights.spectrum).sum(-1) > 0)[0][0])
    g = float(np.asarray(grads.lights.spectrum)[light].sum())
    eps = 1e-2

    def loss_at(delta):
        sc = _with_radiance(scene, light, delta)
        return float(shard.train_step_sharded(sc, opts, target, px, py, si,
                                              mesh)[0])
    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    log(f"loss {float(loss):.6g}; d loss / d radiance: autodiff {g:.6g}, "
        f"finite difference {fd:.6g}")
    if not abs(g - fd) < 0.10 * max(abs(fd), 1e-4):
        raise AssertionError("light-radiance gradient outside the 10% band")


def phase_four():
    import numpy as np
    import jax
    from prt.parallel import shard
    from prt.scene.parser import load_scene
    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four needs 4 cards, found {len(jax.devices())}")
    scene, opts = load_scene(os.path.join(SCENES, "bench3.pbrt"))
    res = {}
    for n in (1, 4):
        with Timer(f"render_sharded bench3 on {n} card(s) (incl. compile)"):
            res[n] = shard.render_sharded(scene, opts, shard.make_mesh(n))[0]
    rel = float(np.abs(res[4] - res[1]).mean() / max(res[1].mean(), 1e-12))
    log(f"bench3 4 cards vs 1: mean |diff| / mean {rel:.3g} "
        f"(band {RENDER_BAND})")
    if not np.isfinite(res[4]).all() or rel > RENDER_BAND:
        raise AssertionError("sharded render differs from one card")

    scene, opts, px, py, si, target = _grad_setup()
    grads = {}
    for n in (1, 4):
        with Timer(f"train_step_sharded on {n} card(s) (incl. compile)"):
            grads[n] = shard.train_step_sharded(
                scene, opts, target, px, py, si, shard.make_mesh(n),
                boundary=False)[1]
    # Relative to each leaf's largest entry: the two sum their samples in
    # different orders, so entries near zero differ by rounding alone.
    worst = 0.0
    for g1, g4 in zip(jax.tree.leaves(grads[1]), jax.tree.leaves(grads[4])):
        g1, g4 = np.asarray(g1), np.asarray(g4)
        if not np.isfinite(g4).all():
            raise AssertionError("non-finite 4-card gradients")
        scale = max(float(np.abs(g1).max(initial=0.0)), 1e-12)
        worst = max(worst, float(np.abs(g4 - g1).max(initial=0.0)) / scale)
    log(f"gradients 4 cards vs 1: worst max|diff| / max|g1| per leaf "
        f"{worst:.3g} (band {GRAD_BAND})")
    if worst > GRAD_BAND:
        raise AssertionError("4-card gradients differ from one card")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card phase")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    devs = phase_device()
    if args.four:
        phases = [("5 four cards", phase_four)]
    else:
        scenes = load_big_scenes()
        phases = [("2 kernels", lambda: phase_kernels(scenes)),
                  ("3 renders", lambda: phase_renders(scenes)),
                  ("4 gradient", phase_gradient)]
    failed = []
    for name, fn in phases:
        log(f"phase {name}")
        t0 = time.time()
        try:
            fn()
        except Exception:
            traceback.print_exc()
            failed.append(name)
        log(f"phase {name}: {'FAILED' if name in failed else 'ok'} "
            f"({time.time() - t0:.1f} s)")
    if failed:
        log(f"FAILED phases: {', '.join(failed)}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

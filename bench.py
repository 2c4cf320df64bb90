"""Benchmarks: primary+shadow rays/sec on the BASELINE workloads.

Workloads measured against the reference renderer (pbrt-v1 from
/root/reference with OpenEXR 3.x + hand-written parser; see
tools/build_reference.md). The pbrt-v1 figures below are historical: one
CPU core of an earlier build machine, timed once in 2026-08 and not
re-timed since (the reference build is not available here). Only their
equal-work ray counts are used as normalizers:

  config3  scenes/bench3.pbrt — 256^2 x 32spp path-traced Cornell
           (10 tris + 3 quadrics, wavefront path driver).
           pbrt-v1: 7.726s, 2.114M camera + 3.363M shadow rays
           => 0.709M primary+shadow rays/s on one CPU core.

  config4  scenes/config4_big.pbrt — 512^2 x 4spp directlighting over a
           100K-triangle terrain (accelerator benchmark; our skip-link
           BVH walk vs the reference's kd-tree).
           pbrt-v1: 2.41s, 1.05M camera + 387K shadow rays
           => 0.596M primary+shadow rays/s on one CPU core.

The rays/s normalizer is the REFERENCE's measured ray count for the exact
workload divided by each renderer's wall time — throughput at equal work,
immune to counter-definition differences.

Prints ONE JSON line. The headline metric/value/vs_baseline is config3
(continuity with rounds 1-2); config4 is reported alongside as
config4_value / config4_vs_baseline.
"""
import json
import os
import sys
import time

# Historical pbrt-v1 rates: one CPU core of the earlier build machine,
# 2026-08-20.
PBRT_CONFIG3_RAYS_PER_SEC = 0.709e6
PBRT_CONFIG4_RAYS_PER_SEC = 0.596e6
# config5 (1M-tri terrain, 512^2 x 4spp directlighting): reference
# measured 2026-08-21 on that machine's CPU — full run 9.94s of which
# parse + kd-tree build 7.51s (measured via a 1x1 render of the same
# scene), i.e. 2.43s render for 1.053M camera + 387K shadow rays.
PBRT_CONFIG5_RAYS_PER_SEC = 0.592e6
# bench6 (photonmap + 16-sample final gather, 256^2 x 4spp Cornell +
# mirror, scenes/bench6.pbrt): reference wall measured 2026-08-21 on that
# machine's CPU, single thread (2.5s shooting + render; tools/refbuild).
PBRT_BENCH6_WALL = 80.0
CONFIG3_REF_RAYS = 2.114e6 + 3.363e6
CONFIG4_REF_RAYS = 1.05e6 + 0.387e6
# Reference-measured ray count for the config5 run itself (1.053M camera
# + 387K shadow over the 2.43s render) — the same equal-work convention
# as config4, replacing the estimated count ADVICE r4 flagged.
CONFIG5_REF_RAYS = 1.053e6 + 0.387e6


def bench_config3(here):
    import jax
    from prt.scene.parser import load_scene
    from prt.integrators import path_wavefront
    from prt.utils.stats import StatsRegistry

    scene, opts = load_scene(os.path.join(here, "scenes", "bench3.pbrt"))
    opts = opts._replace(chunk_size=1 << 17, half_readback=True)
    path_wavefront.render(scene, opts)           # warmup/compile
    dt = 1e30
    for _ in range(3):
        stats = StatsRegistry()   # fresh per run: counters are per-render
        t0 = time.time()
        path_wavefront.render(scene, opts, stats=stats)
        dt = min(dt, time.time() - t0)
    return dt, stats


def bench_config4(here):
    from prt.scene.parser import load_scene
    from prt import render as R

    scene, opts = load_scene(os.path.join(here, "scenes",
                                          "config4_big.pbrt"))
    opts = opts._replace(chunk_size=1 << 17, half_readback=True)
    R.render(scene, opts)                        # warmup/compile
    dt = 1e30
    for _ in range(3):
        t0 = time.time()
        R.render(scene, opts)
        dt = min(dt, time.time() - t0)
    return dt


def build_config5_scene(n=708):
    """The 1M-triangle scale workload (VERDICT r3 item 3): config4's
    terrain at 10x triangle count, plain matte, same lights/camera/
    sampler. Built procedurally (the 50 MB .pbrt text form is only
    written for reference cross-runs, tools/make_scenes.py --huge)."""
    import numpy as np
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "tools"))
    from make_scenes import terrain
    from prt.scene.build import SceneBuilder
    from prt.cameras import cameras as cam
    from prt.core import transform as tf
    from prt import render as R
    from prt.samplers.samplers import SamplerConfig

    v, f = terrain(n)
    b = SceneBuilder()
    m = b.matte(kd=(0.6, 0.55, 0.5))
    b.add_trianglemesh(np.eye(4), f, v, material=m)
    b.add_distant_light(np.eye(4), L=(2.2, 2.1, 1.9), frm=(3, 6, -4),
                        to=(0, 0, 0))
    b.add_infinite_light(np.eye(4), L=(0.8, 0.9, 1.1))
    xres = yres = 512
    c2w = np.asarray(tf.look_at([0, 1.1, -2.6], [0, 0, 0], [0, 1, 0]))
    b.set_camera(cam.build_projective(
        0, c2w, np.asarray(tf.perspective(55.0, 1e-2, 100.0)),
        cam.default_screen_window(xres, yres), xres, yres))
    scene = b.build()
    opts = R.RenderOptions(
        xres=xres, yres=yres,
        sampler=SamplerConfig(kind="lowdiscrepancy", pixelsamples=4),
        filter_kind="box", filter_xwidth=0.5, filter_ywidth=0.5,
        integrator="directlighting", max_depth=5, chunk_size=1 << 17,
        half_readback=True)
    return scene, opts, len(f)


def bench_config5():
    from prt import render as R
    from prt.utils.stats import StatsRegistry
    scene, opts, ntris = build_config5_scene()
    R.render(scene, opts)                        # warmup/compile
    dt = 1e30
    for _ in range(3):
        stats = StatsRegistry()   # fresh per run: counters are per-render
        t0 = time.time()
        R.render(scene, opts, stats=stats)
        dt = min(dt, time.time() - t0)
    shadow = stats.get("Wavefront", "Shadow rays traced") or 0
    return dt, ntris, int(shadow)


def bench_config6(here):
    """Photon mapping with final gather (the GI headline; VERDICT r4
    item 2) — full pipeline per run: photon shooting + map builds +
    wavefront render, same as the reference's wall clock."""
    from prt.scene.parser import load_scene
    from prt import render as R

    scene, opts = load_scene(os.path.join(here, "scenes", "bench6.pbrt"))
    opts = opts._replace(half_readback=True)
    R.render(scene, opts)                        # warmup/compile
    dt = 1e30
    for _ in range(2):
        t0 = time.time()
        R.render(scene, opts)
        dt = min(dt, time.time() - t0)
    return dt


def _run_stage(stage):
    """One workload, in THIS process. Prints its raw numbers as JSON."""
    from prt.utils.jax_cache import enable_compile_cache
    enable_compile_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    if stage == "3":
        dt3, stats = bench_config3(here)
        print(json.dumps({"dt": dt3,
                          "shadow": stats.get("Wavefront",
                                              "Shadow rays traced")}))
    elif stage == "4":
        print(json.dumps({"dt": bench_config4(here)}))
    elif stage == "5":
        dt5, ntris5, shadow5 = bench_config5()
        print(json.dumps({"dt": dt5, "ntris": ntris5, "shadow": shadow5}))
    elif stage == "6":
        print(json.dumps({"dt": bench_config6(here)}))


def _stage_subprocess(stage):
    """Each workload in its own process, one after another: the parent
    never imports JAX, so exactly one process holds the card at a time
    and each stage's peak memory is its own."""
    import subprocess
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--stage", stage],
                       capture_output=True, text=True, check=True)
    return json.loads(r.stdout.strip().splitlines()[-1])


def main():
    s3 = _stage_subprocess("3")
    dt3, shadow = s3["dt"], s3["shadow"]
    rate3 = CONFIG3_REF_RAYS / dt3

    dt4 = _stage_subprocess("4")["dt"]
    rate4 = CONFIG4_REF_RAYS / dt4

    s5 = _stage_subprocess("5")
    dt5, ntris5 = s5["dt"], s5["ntris"]
    # Same equal-work convention as config3/config4: the REFERENCE's
    # measured ray count for this exact workload over our wall time.
    rate5 = CONFIG5_REF_RAYS / dt5
    extra5 = {}
    if PBRT_CONFIG5_RAYS_PER_SEC:
        extra5["config5_vs_baseline"] = round(
            rate5 / PBRT_CONFIG5_RAYS_PER_SEC, 3)
        extra5["config5_baseline_rays_per_sec"] = PBRT_CONFIG5_RAYS_PER_SEC

    dt6 = _stage_subprocess("6")["dt"]

    print(json.dumps({
        "metric": "primary+shadow rays/sec/chip (config3 Cornell path)",
        "value": round(rate3, 1),
        "unit": "rays/s",
        "vs_baseline": round(rate3 / PBRT_CONFIG3_RAYS_PER_SEC, 3),
        "wall_s": round(dt3, 3),
        "camera_rays": 256 * 256 * 32,
        "shadow_rays": int(shadow),
        "baseline_rays_per_sec": PBRT_CONFIG3_RAYS_PER_SEC,
        "config4_metric": "primary+shadow rays/sec/chip (config4_big "
                          "100K-tri terrain, BVH)",
        "config4_value": round(rate4, 1),
        "config4_vs_baseline": round(rate4 / PBRT_CONFIG4_RAYS_PER_SEC, 3),
        "config4_wall_s": round(dt4, 3),
        "config4_baseline_rays_per_sec": PBRT_CONFIG4_RAYS_PER_SEC,
        "config5_metric": "primary+shadow rays/sec/chip (config5_huge "
                          f"{ntris5}-tri terrain, BVH)",
        "config5_value": round(rate5, 1),
        "config5_wall_s": round(dt5, 3),
        "config5_our_shadow_rays": s5.get("shadow", 0),
        **extra5,
        "photonmap_metric": "photonmap+finalgather wall vs pbrt-v1 "
                            "(bench6, 256^2x4spp, shooting included)",
        "photonmap_wall_s": round(dt6, 3),
        "photonmap_vs_baseline": round(PBRT_BENCH6_WALL / dt6, 3),
        "photonmap_baseline_wall_s": PBRT_BENCH6_WALL,
        "baseline_note": "historical pbrt-v1 timings on one CPU core of "
                         "an earlier build machine, same scenes/counters "
                         "(tools/build_reference.md)",
    }))


if __name__ == "__main__":
    import sys
    if len(sys.argv) > 2 and sys.argv[1] == "--stage":
        _run_stage(sys.argv[2])
    else:
        main()

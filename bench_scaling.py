#!/usr/bin/env python
"""Scaling-efficiency harness (BASELINE.md north star: >=85% rays/s/chip
retained at 1 chip -> 1 host -> N hosts).

Renders the flagship path-traced scene with the sample space sharded
over meshes of 1, 2, 4, ... N devices (fixed total work) and reports
rays/sec and per-device efficiency vs the 1-device run.

On a host of GPUs this measures scaling over NVLink, which joins the
cards all to all; with --cpu N it runs on N virtual CPU devices, which
validates the sharding machinery and collective layout but NOT real
efficiency (the virtual devices share the host's cores).

Prints one JSON line per mesh size.
"""
import argparse
import json
import math
import time


def _pworker(coord, nproc, pid, res, spp, depth):
    """One process of the cross-PROCESS overhead probe (VERDICT r5 item
    6): each process owns ONE virtual CPU device, so every psum crosses a
    real process boundary over the loopback transport — the
    measurable-here analogue of DCN collective cost. Fixed per-device
    work, with/without the film psum; process 0 prints the JSON row."""
    import os
    import time as _t
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=1")
    import jax
    jax.config.update("jax_platforms", "cpu")
    from prt.utils.jax_cache import enable_compile_cache
    enable_compile_cache()
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=nproc, process_id=pid)
    import numpy as np_
    import jax.numpy as jnp
    from functools import partial as _p
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from __graft_entry__ import _flagship_scene
    from prt import render as R
    from prt.film import film as film_mod
    from prt.samplers.samplers import SamplerConfig

    xres = yres = res
    scene = _flagship_scene(xres, yres)
    opts = R.RenderOptions(
        xres=xres, yres=yres,
        sampler=SamplerConfig(kind="lowdiscrepancy", pixelsamples=spp),
        filter_kind="box", filter_xwidth=0.5, filter_ywidth=0.5,
        integrator="path", max_depth=depth, chunk_size=1 << 14)
    mesh = Mesh(np_.asarray(jax.devices()), ("data",))
    per_dev = 1 << 12
    k = per_dev * nproc
    total = xres * yres * spp
    lin = np_.arange(k) % total
    px_n = ((lin // spp) % xres).astype(np_.int32)
    py_n = ((lin // spp) // xres % yres).astype(np_.int32)
    si_n = (lin % spp).astype(np_.int32)
    va_n = np_.ones(k, bool)

    def mk(a):
        sh = NamedSharding(mesh, P("data"))
        return jax.make_array_from_callback(a.shape, sh,
                                            lambda idx: a[idx])

    def body(sc, fdata, pxa, pya, sia, va, do_psum):
        f = film_mod.Film(data=fdata[0], xres=xres, yres=yres,
                          crop=opts.crop)
        f = R.render_chunk(sc, opts, f, pxa, pya, sia, va)
        out = f.data
        if do_psum:
            out = jax.lax.psum(out, "data")
        return out[None]

    def make(do_psum):
        return jax.jit(_p(
            jax.shard_map, mesh=mesh,
            in_specs=(P(), P("data"), P("data"), P("data"), P("data"),
                      P("data")),
            out_specs=P("data"))(
                lambda sc, fd, a, b, c2, d: body(sc, fd, a, b, c2, d,
                                                 do_psum)))

    fdata = jnp.zeros((nproc, yres, xres, 5), jnp.float32)
    fdata = jax.device_put(fdata, NamedSharding(mesh, P("data")))
    args5 = (mk(px_n), mk(py_n), mk(si_n), mk(va_n))

    # The per-chunk render is ~1 s on these shared CPU cores while the
    # 327 KB psum is milliseconds, so a with/without-subtraction is pure
    # noise. Time the COLLECTIVE in isolation instead (same shape, same
    # transport) with many reps, and the render once, then report the
    # collective's cost as a fraction of a render+merge step.
    psum_only = jax.jit(_p(
        jax.shard_map, mesh=mesh, in_specs=(P("data"),),
        out_specs=P("data"))(
            lambda fd: jax.lax.psum(fd, "data")[None][0]))
    render_only = make(False)

    out = render_only(scene, fdata, *args5)
    out.block_until_ready()
    t0 = _t.time()
    reps_r = 3
    for _ in range(reps_r):
        out = render_only(scene, fdata, *args5)
    out.block_until_ready()
    t_render = (_t.time() - t0) / reps_r

    o2 = psum_only(fdata)
    o2.block_until_ready()
    reps_p = 30
    t0 = _t.time()
    for _ in range(reps_p):
        o2 = psum_only(o2 * 0.5)   # new value each rep: no caching
    o2.block_until_ready()
    t_psum = (_t.time() - t0) / reps_p

    if pid == 0:
        print(json.dumps({
            "metric": "collective_overhead", "devices": nproc,
            "processes": nproc, "per_device_samples": per_dev,
            "t_render_s": round(t_render, 4),
            "t_psum_s": round(t_psum, 5),
            "overhead_fraction": round(t_psum / max(t_render + t_psum,
                                                    1e-9), 4),
            "psum_bytes": int(yres * xres * 5 * 4),
            "psum_gbps": round(yres * xres * 5 * 4 / max(t_psum, 1e-9)
                               / 1e9, 3),
            "backend": jax.default_backend(), "virtual_cpu": True,
            "note": "1 device per PROCESS: the psum crosses real process "
                    "boundaries (loopback transport) — the DCN-shaped "
                    "cost the in-process virtual mesh cannot see; "
                    "collective timed in isolation (same shape/transport)"
            }), flush=True)
    jax.distributed.shutdown()


def _launch_processes(nproc, res, spp, depth):
    import os
    import socket
    import subprocess
    import sys as _s
    s = socket.socket()
    s.bind(("localhost", 0))
    coord = f"localhost:{s.getsockname()[1]}"
    s.close()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [_s.executable, os.path.abspath(__file__), "--pworker", coord,
         str(nproc), str(i), str(res), str(spp), str(depth)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(nproc)]
    outs = [p.communicate(timeout=1200)[0] for p in procs]
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(o.decode()[-3000:])
    for line in outs[0].decode().splitlines():
        if line.startswith("{"):
            print(line, flush=True)


def main():
    import sys as _s
    if len(_s.argv) > 1 and _s.argv[1] == "--pworker":
        coord, nproc, pid, res, spp, depth = _s.argv[2:8]
        _pworker(coord, int(nproc), int(pid), int(res), int(spp),
                 int(depth))
        return

    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", type=int, default=0,
                    help="use N virtual CPU devices instead of the "
                         "default backend")
    ap.add_argument("--processes", type=int, default=0,
                    help="ALSO run the cross-process overhead probe "
                         "with N single-device processes")
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--depth", type=int, default=4)
    args = ap.parse_args()

    if args.processes:
        _launch_processes(args.processes, args.res, args.spp, args.depth)
        if not args.cpu:
            return

    import os
    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.cpu}")
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from prt.utils.jax_cache import enable_compile_cache
    enable_compile_cache()

    from __graft_entry__ import _flagship_scene
    from prt import render as R
    from prt.parallel import shard
    from prt.samplers.samplers import SamplerConfig

    xres = yres = args.res
    scene = _flagship_scene(xres, yres)
    opts = R.RenderOptions(
        xres=xres, yres=yres,
        sampler=SamplerConfig(kind="lowdiscrepancy",
                              pixelsamples=args.spp),
        filter_kind="box", filter_xwidth=0.5, filter_ywidth=0.5,
        integrator="path", max_depth=args.depth,
        chunk_size=1 << 14)
    total_samples = xres * yres * args.spp
    # Path rays per camera sample: 1 camera + per-bounce (intersect +
    # shadow + BSDF) — use the integrator's own counter for honesty.
    ndev_all = len(jax.devices())

    # --- Collective/sharding overhead at FIXED per-device work ---------
    # On virtual CPU devices the samples/s rows below decay ~1/N by
    # construction (the devices share the host's cores), so they validate
    # machinery, not efficiency. This probe isolates what CAN be measured
    # here: the cost of the collective itself. Each mesh size runs the
    # same per-device sample count twice — once with no cross-device
    # communication, once with a per-chunk film psum (the allreduce
    # shape of the gradient/film merges) — and reports the fraction of
    # wall time the collective adds.
    import jax.numpy as jnp
    import numpy as np_
    from jax.sharding import PartitionSpec as P
    from functools import partial as _p

    per_dev_samples = 1 << 12
    sizes = [1 << i for i in range(int(math.log2(ndev_all)) + 1)]
    for n in sizes:
        mesh = shard.make_mesh(n)
        axis = mesh.axis_names[0]
        k = per_dev_samples * n
        lin = np_.arange(k) % total_samples
        spp = args.spp
        px = jnp.asarray((lin // spp) % xres, jnp.int32)
        py = jnp.asarray((lin // spp) // xres % yres, jnp.int32)
        si = jnp.asarray(lin % spp, jnp.int32)
        valid = jnp.ones(k, bool)

        def body(sc, fdata, pxa, pya, sia, va, do_psum):
            from prt.film import film as film_mod
            f = film_mod.Film(data=fdata[0], xres=xres, yres=yres,
                              crop=opts.crop)
            f = R.render_chunk(sc, opts, f, pxa, pya, sia, va)
            out = f.data
            if do_psum:
                out = jax.lax.psum(out, axis)
            return out[None]

        def make(do_psum):
            return jax.jit(_p(
                jax.shard_map, mesh=mesh,
                in_specs=(P(), P(axis), P(axis), P(axis), P(axis),
                          P(axis)),
                out_specs=P(axis))(
                    lambda sc, fd, a, b, c2, d: body(sc, fd, a, b, c2, d,
                                                     do_psum)))

        fdata = jnp.zeros((n, yres, xres, 5), jnp.float32)
        times = {}
        for name, fn in (("nocollective", make(False)),
                         ("psum", make(True))):
            out = fn(scene, fdata, px, py, si, valid)
            out.block_until_ready()            # compile warmup
            reps = 3
            t0 = time.time()
            for _ in range(reps):
                out = fn(scene, fdata, px, py, si, valid)
            out.block_until_ready()
            times[name] = (time.time() - t0) / reps
        ovh = max(times["psum"] - times["nocollective"], 0.0)
        print(json.dumps({
            "metric": "collective_overhead", "devices": n,
            "per_device_samples": per_dev_samples,
            "t_nocollective_s": round(times["nocollective"], 4),
            "t_psum_s": round(times["psum"], 4),
            "overhead_fraction": round(ovh / max(times["psum"], 1e-9), 4),
            "backend": jax.default_backend(),
            "virtual_cpu": bool(args.cpu),
            "note": "fixed per-device work; virtual CPU devices share "
                    "host cores, so only the collective delta is "
                    "meaningful here"}), flush=True)

    base_rate = None
    for n in sizes:
        mesh = shard.make_mesh(n)
        shard.render_sharded(scene, opts, mesh)           # compile warmup
        t0 = time.time()
        shard.render_sharded(scene, opts, mesh)
        dt = time.time() - t0
        rate = total_samples / dt
        per_dev = rate / n
        if base_rate is None:
            base_rate = per_dev
        eff = per_dev / base_rate
        print(json.dumps({
            "metric": "samples_per_sec", "devices": n,
            "value": round(rate, 1), "unit": "samples/s",
            "per_device": round(per_dev, 1),
            "efficiency_vs_1dev": round(eff, 4),
            "backend": jax.default_backend(),
            "virtual_cpu": bool(args.cpu)}), flush=True)


if __name__ == "__main__":
    main()

"""Render driver: Scene::Render
(/root/reference/core/scene.cpp:32-88).

The reference's sequential sample loop becomes: enumerate the (pixel,
sample-index) space of the crop window, process it in fixed-size wavefront
chunks under one jit'd step (camera raygen -> integrator Li -> NaN guards ->
filtered film splat), then develop the film. Deterministic counter-based
sampling makes every chunk independent — the basis for device sharding
(parallel/shard.py).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .cameras import cameras as cam_mod
from .core import spectrum as spec
from .film import film as film_mod
from .samplers import samplers as smp
from .scene.data import SceneData
# Integrators imported eagerly: lazy imports inside a jit trace would create
# module-level jnp constants as leaked tracers.
from .integrators import whitted as _whitted, path as _path


class RenderOptions(NamedTuple):
    xres: int = 256
    yres: int = 256
    sampler: smp.SamplerConfig = smp.SamplerConfig()
    filter_kind: str = "mitchell"      # reference default (core/api.cpp:64)
    filter_xwidth: float = 2.0
    filter_ywidth: float = 2.0
    integrator: str = "whitted"        # whitted|path|directlighting|debug
    volume_integrator: str = "emission"  # emission|single
    max_depth: int = 5
    crop: tuple = (0.0, 1.0, 0.0, 1.0)
    seed: int = 0
    chunk_size: int = 1 << 16          # wavefront size
    direct_strategy: str = "all"       # directlighting: all|one|weighted
    debug_channels: tuple = ("u", "v", "hit")
    photon: tuple = ()                 # PhotonParams when integrator=photonmap
    igi: tuple = ()                    # IgiParams when integrator=igi
    irrad: tuple = ()                  # IrradParams, integrator=irradiancecache
    filename: str = "pbrt.exr"         # film/image.cpp:213-216
    # Re-write the in-progress image every N samples (film/image.cpp:142-146,
    # writefrequency param); <=0 disables. Rounded up to whole chunks.
    writefrequency: int = -1
    # Render drive: "auto" routes path/directlighting/whitted through the
    # single-dispatch regenerating wavefront pool (path_wavefront.render)
    # unless checkpointing is requested; "scan" forces the chunked scan
    # driver (parity tests, checkpoint/resume); "wavefront" forces the pool.
    driver: str = "auto"
    # Quantize the developed image to f16 ON DEVICE before the host
    # transfer: the reference's EXR writer stores HALF pixels anyway
    # (core/exrio.cpp RgbaOutputFile), and it halves the readback (whose
    # cost on the H100 host is not measured yet; ROADMAP A6).
    # Off by default so driver-parity tests compare full-precision
    # accumulators; the CLI and benchmarks enable it.
    half_readback: bool = False


def _li_dispatch(scene, opts: RenderOptions, o, d, mint, maxt,
                 px, py, s_idx, rx=None, ry=None, aux=None):
    if opts.integrator == "photonmap":
        from .integrators import photonmap
        prm = opts.photon if opts.photon else photonmap.PhotonParams()
        return photonmap.li(scene, aux, o, d, mint, maxt, opts.sampler,
                            px, py, s_idx, opts.max_depth, opts.seed,
                            prm, rx=rx, ry=ry)
    if opts.integrator == "exphotonmap":
        from .integrators import exphotonmap
        prm = opts.photon if opts.photon else exphotonmap.ExPhotonParams()
        return exphotonmap.li(scene, aux, o, d, mint, maxt, opts.sampler,
                              px, py, s_idx, opts.max_depth, opts.seed,
                              prm, rx=rx, ry=ry)
    if opts.integrator == "igi":
        from .integrators import igi
        prm = opts.igi if opts.igi else igi.IgiParams()
        return igi.li(scene, aux, o, d, mint, maxt, opts.sampler,
                      px, py, s_idx, opts.max_depth, opts.seed, prm,
                      rx=rx, ry=ry)
    if opts.integrator == "irradiancecache":
        from .integrators import irradiancecache
        prm = opts.irrad if opts.irrad else irradiancecache.IrradParams()
        return irradiancecache.li(scene, aux, o, d, mint, maxt,
                                  opts.sampler, px, py, s_idx,
                                  opts.max_depth, opts.seed, prm,
                                  rx=rx, ry=ry)
    if opts.integrator == "bidirectional":
        from .integrators import bidirectional
        return bidirectional.li(scene, o, d, mint, maxt, opts.sampler,
                                px, py, s_idx, opts.max_depth, opts.seed,
                                rx=rx, ry=ry)
    if opts.integrator == "whitted":
        return _whitted.li(scene, o, d, mint, maxt, opts.sampler, px, py,
                           s_idx, opts.max_depth, opts.seed, rx=rx, ry=ry)
    if opts.integrator == "path":
        return _path.li(scene, o, d, mint, maxt, opts.sampler, px, py,
                        s_idx, opts.max_depth, opts.seed, rx=rx, ry=ry)
    if opts.integrator == "directlighting":
        from .integrators import directlighting
        return directlighting.li(scene, o, d, mint, maxt, opts.sampler,
                                 px, py, s_idx, opts.max_depth, opts.seed,
                                 opts.direct_strategy, rx=rx, ry=ry)
    if opts.integrator == "debug":
        from .integrators import debug
        return debug.li(scene, o, d, mint, maxt, opts.debug_channels)
    raise ValueError(f"unknown integrator {opts.integrator}")


def render_chunk(scene: SceneData, opts: RenderOptions, film: film_mod.Film,
                 px, py, s_idx, valid, aux=None):
    """One jit-able wavefront step: raygen -> Li -> guards -> splat."""
    cs = smp.camera_samples(opts.sampler, px, py, s_idx, opts.seed)
    o, d, mint, maxt, time = cam_mod.generate_rays(
        scene.camera, cs["image_x"], cs["image_y"], cs["lens_u"],
        cs["lens_v"], cs["time"], opts.xres, opts.yres)
    # Auxiliary +1-pixel rays for ray differentials (core/scene.cpp:45-53);
    # same lens/time samples, shifted raster position.
    o_rx, d_rx, *_ = cam_mod.generate_rays(
        scene.camera, cs["image_x"] + 1.0, cs["image_y"], cs["lens_u"],
        cs["lens_v"], cs["time"], opts.xres, opts.yres)
    o_ry, d_ry, *_ = cam_mod.generate_rays(
        scene.camera, cs["image_x"], cs["image_y"] + 1.0, cs["lens_u"],
        cs["lens_v"], cs["time"], opts.xres, opts.yres)
    L, alpha, t_first = _li_dispatch(scene, opts, o, d, mint, maxt, px, py,
                                     s_idx, rx=(o_rx, d_rx), ry=(o_ry, d_ry),
                                     aux=aux)
    # Scene::Li composition (core/scene.cpp:120-126): L = T*Lo + Lv with T
    # the camera-segment transmittance to the first hit and Lv the volume
    # integrator's in-scatter/emission along that segment. The integrator
    # already found the first hit; reuse its t rather than re-intersecting.
    if scene.volumes is not None and scene.volumes.count > 0:
        from .core import rng as rng_mod
        from .integrators import volume as vol_integ
        seg_end = t_first
        ph = rng_mod.hash_u32(px, py, opts.seed, 0xF0)
        u = rng_mod.uniform(ph, s_idx, 0x7A)
        T = vol_integ.transmittance(scene, o, d, mint, seg_end, u)
        if opts.volume_integrator == "single":
            Lv = vol_integ.li_single(scene, o, d, mint, seg_end, ph, s_idx,
                                     opts.seed)
        else:
            Lv = vol_integ.li_emission(scene, o, d, mint, seg_end, u)
        L = T * L + Lv
    # Radiance guards (core/scene.cpp:60-74): NaN/negative/inf -> black.
    bad = jnp.any(~jnp.isfinite(L) | (L < 0.0), axis=-1)
    L = jnp.where(bad[..., None], 0.0, L)
    L = jnp.where(valid[..., None], L, 0.0)
    w_valid = jnp.where(valid, 1.0, 0.0)
    # Invalid (padding) lanes get zero filter weight via off-screen coords.
    ix = jnp.where(valid, cs["image_x"], -1e6)
    iy = jnp.where(valid, cs["image_y"], -1e6)
    return film_mod.add_samples(film, ix, iy, L, alpha * w_valid,
                                opts.filter_kind, opts.filter_xwidth,
                                opts.filter_ywidth)


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("opts",))
def _render_chunk_jit(scene, film, px, py, s_idx, valid, aux, *,
                      opts: RenderOptions):
    """Module-level jit of render_chunk: one trace per (opts, shapes)
    across all render() calls instead of a fresh closure per call."""
    return render_chunk(scene, opts, film, px, py, s_idx, valid, aux=aux)


def _render_fingerprint(opts: RenderOptions) -> str:
    """Identity of the sample schedule a checkpoint belongs to: resuming
    under a different schedule would silently blend wrong pixels."""
    return repr((opts.xres, opts.yres, tuple(opts.crop), opts.seed,
                 opts.sampler, opts.integrator, opts.max_depth,
                 opts.filter_kind, opts.filter_xwidth, opts.filter_ywidth,
                 opts.chunk_size))


def save_checkpoint(path: str, film: film_mod.Film, next_chunk: int,
                    opts: RenderOptions = None):
    """Dump the film accumulator + wavefront cursor (the analogue of
    the reference's writefrequency partial image, film/image.cpp:142-146,
    made resumable: deterministic counter-based sampling means re-running
    from the saved chunk index reproduces the remaining work exactly)."""
    np.savez(path, pixels=np.asarray(film.pixels),
             alpha=np.asarray(film.alpha),
             weight_sum=np.asarray(film.weight_sum),
             next_chunk=np.int64(next_chunk),
             fingerprint=np.array(
                 _render_fingerprint(opts) if opts is not None else ""))


def load_checkpoint(path: str, opts: RenderOptions):
    """Restore (film, next_chunk) written by save_checkpoint. Refuses a
    checkpoint whose render schedule does not match `opts`."""
    z = np.load(path)
    if "fingerprint" in z.files:
        saved = str(z["fingerprint"])
        if saved and saved != _render_fingerprint(opts):
            raise ValueError(
                f"checkpoint {path} was written by a different render "
                "configuration (resolution/sampler/seed/integrator...); "
                "refusing to resume into it")
    film = film_mod.from_planes(z["pixels"], z["alpha"], z["weight_sum"],
                                opts.xres, opts.yres, opts.crop)
    return film, int(z["next_chunk"])


def render(scene: SceneData, opts: RenderOptions, progress: bool = False,
           stats=None, checkpoint_path: str = None, resume: bool = False):
    """Full frame render. Returns (rgb f32[yres,xres,3], alpha).

    progress: print a ProgressReporter bar (core/util.cpp:396-448).
    stats: a utils.stats.StatsRegistry to fill (core/util.cpp:186-285).
    checkpoint_path/resume: film checkpoint + restart mid-render
    (writefrequency analogue, film/image.cpp:142-146).
    """
    import time as _time
    t0 = _time.time()
    # Wavefront routing: the regenerating lane pool renders these
    # integrators in ONE device dispatch (no per-chunk host syncs, no
    # dead-lane passes) — the scan driver remains for checkpoint/resume
    # and as the parity oracle (driver="scan").
    has_vols = scene.volumes is not None and scene.volumes.count > 0
    wf_ok = (opts.integrator in ("path", "directlighting", "whitted") or
             (opts.integrator == "photonmap" and not has_vols)) and \
        checkpoint_path is None and not resume and \
        not (opts.writefrequency and opts.writefrequency > 0)
    if opts.driver == "wavefront" or (opts.driver == "auto" and wf_ok):
        from .integrators import path_wavefront
        return path_wavefront.render(scene, opts, progress=progress,
                                     stats=stats)
    film = film_mod.make_film(opts.xres, opts.yres, opts.crop)
    xstart, xcount, ystart, ycount = film_mod.pixel_extent(film)
    spp = smp.samples_per_pixel(opts.sampler)
    total = xcount * ycount * spp
    chunk = min(opts.chunk_size, total)
    if opts.integrator == "photonmap":
        # Final gather runs as ONE flat widened wavefront per depth
        # (photonmap.py li): chunk x gather_samples rays in flight.
        # Keep that product <= 2^17. The cap was inherited from an
        # earlier build, where larger products faulted; it is not yet measured
        # on the H100 (ROADMAP A4).
        from .integrators import photonmap as _pm
        prm_ph = opts.photon if opts.photon else _pm.PhotonParams()
        if prm_ph.final_gather:
            chunk = min(chunk, max(1 << 11,
                                   (1 << 17) // max(prm_ph.gather_samples,
                                                    1)))
    elif opts.integrator == "exphotonmap":
        # exphotonmap's cone-MIS gather still runs the scan form (its
        # two-strategy per-sample logic resists flattening); 4K lanes, a
        # bound inherited from an earlier build and not yet measured on the
        # H100 (ROADMAP A4).
        chunk = min(chunk, 1 << 12)

    # Integrator preprocess (Scene::Render -> Preprocess, core/scene.cpp:38):
    # photon shooting happens here, before the camera-sample loop.
    aux = None
    if opts.integrator == "photonmap":
        from .integrators import photonmap
        prm = opts.photon if opts.photon else photonmap.PhotonParams()
        aux = photonmap.build_maps(scene, prm, opts.seed)
    elif opts.integrator == "exphotonmap":
        from .integrators import exphotonmap
        prm = opts.photon if opts.photon else exphotonmap.ExPhotonParams()
        aux = exphotonmap.build_aux(scene, prm, opts.seed)
    elif opts.integrator == "igi":
        from .integrators import igi as igi_mod
        prm = opts.igi if opts.igi else igi_mod.IgiParams()
        aux = igi_mod.build_virtual_lights(scene, prm, opts.seed)
    elif opts.integrator == "irradiancecache":
        from .integrators import irradiancecache as ic_mod
        prm = opts.irrad if opts.irrad else ic_mod.IrradParams()
        aux = ic_mod.build_cache(scene, prm, opts.xres, opts.yres,
                                 opts.seed)

    def step(sc, f, pxa, pya, sia, va, aa):
        return _render_chunk_jit(sc, f, pxa, pya, sia, va, aa, opts=opts)

    n_chunks = math.ceil(total / chunk)
    start_chunk = 0
    if resume and checkpoint_path is not None and \
            __import__("os").path.exists(checkpoint_path):
        film, start_chunk = load_checkpoint(checkpoint_path, opts)

    write_every = 0
    if opts.writefrequency and opts.writefrequency > 0:
        write_every = max(1, math.ceil(opts.writefrequency / chunk))

    rep = None
    if progress:
        from .utils.progress import ProgressReporter
        rep = ProgressReporter(n_chunks - start_chunk, "Rendering")
        rep.done_work = 0

    for c in range(start_chunk, n_chunks):
        base = c * chunk
        lin = np.arange(base, base + chunk)
        valid = lin < total
        lin = np.minimum(lin, total - 1)
        s_idx = lin % spp
        pix = lin // spp
        px = xstart + (pix % xcount)
        py = ystart + (pix // xcount)
        film = step(scene, film,
                    jnp.asarray(px, jnp.int32), jnp.asarray(py, jnp.int32),
                    jnp.asarray(s_idx, jnp.int32), jnp.asarray(valid), aux)
        # Per-chunk sync, inherited from an earlier build; whether the H100
        # gains from letting chunks queue is not measured (ROADMAP C3).
        film.data.block_until_ready()
        if rep is not None:
            rep.update()
        if write_every and (c + 1) % write_every == 0 and c + 1 < n_chunks:
            from .io import exr
            rgb_p, alpha_p = film_mod.develop(film)
            exr.write_exr(opts.filename, np.asarray(rgb_p),
                          np.asarray(alpha_p))
            if checkpoint_path is not None:
                save_checkpoint(checkpoint_path, film, c + 1, opts)
    if rep is not None:
        rep.done()
    rgb, alpha = film_mod.develop(film)
    if getattr(opts, "half_readback", False):
        rgb, alpha = film_mod.to_half(rgb, alpha)
    rgb.block_until_ready()
    if stats is not None:
        wall = _time.time() - t0
        done_samples = (n_chunks - start_chunk) * chunk
        stats.add("Camera", "Samples taken", done_samples)
        stats.add("Camera", "Rays generated (incl. differentials)",
                  3 * done_samples)
        stats.add("Film", "Wavefront chunks", n_chunks - start_chunk)
        stats.add("Performance", "Wall-clock seconds", round(wall, 3))
        stats.add("Performance", "Samples per second",
                  int(done_samples / max(wall, 1e-9)))
    return (np.asarray(rgb).astype(np.float32, copy=False),
            np.asarray(alpha).astype(np.float32, copy=False))

"""Multi-host launch + global-mesh rendering.

The reference's multi-machine story is N hand-launched processes with
different crop windows, stitched by tools/exrassemble.cpp (SURVEY.md
section 2.15). Here each host calls `init_distributed` (SPMD: every
process runs the same program), the global device mesh spans all hosts,
and the sample space is sharded over it; the per-device films are merged
with a psum inside shard_map — ICI within a slice, DCN across hosts,
never exposed as raw transport.

Every process computes the same (pixel, sample) schedule from the same
deterministic counters, so the global arrays are assembled from
process-local shards without any data exchange
(jax.make_array_from_callback with each device's slice).
"""
from __future__ import annotations

import math
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import render as R
from ..film import film as film_mod
from ..samplers import samplers as smp
from ..scene.data import SceneData
from . import shard as shard_mod


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None):
    """jax.distributed.initialize wrapper. On CPU/GPU hosts nothing tells
    JAX of the cluster: pass the arguments explicitly. Safe to call once
    per process, before any jax op."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    if local_device_ids is not None:
        kwargs.update(local_device_ids=local_device_ids)
    jax.distributed.initialize(**kwargs)


def global_mesh(axis: str = "data") -> Mesh:
    """1-D mesh over every device on every host."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def _make_global(np_arr, mesh: Mesh, axis: str):
    """Build a global jax.Array sharded over the mesh from a host-side
    numpy array that every process computed identically."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.make_array_from_callback(np_arr.shape, sharding,
                                        lambda idx: np_arr[idx])


def render_multihost(scene: SceneData, opts: R.RenderOptions,
                     mesh: Mesh | None = None):
    """Full-frame render across all hosts' devices. Every process returns
    the same merged (rgb, alpha); process 0 typically writes the EXR.

    Identical estimator to render.render(): same counter-based sample
    schedule, sharded over the global mesh instead of chunk-looped.
    """
    mesh = mesh or global_mesh()
    axis = mesh.axis_names[0]
    ndev = mesh.devices.size

    film0 = film_mod.make_film(opts.xres, opts.yres, opts.crop)
    xstart, xcount, ystart, ycount = film_mod.pixel_extent(film0)
    spp = smp.samples_per_pixel(opts.sampler)
    total = xcount * ycount * spp
    chunk = min(opts.chunk_size * ndev,
                ((total + ndev - 1) // ndev) * ndev)

    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P(axis), P(axis), P(axis), P(axis)),
             out_specs=(P(), P(), P()))
    def shard_step(sc, px, py, si, valid):
        film = film_mod.make_film(opts.xres, opts.yres, opts.crop)
        film = R.render_chunk(sc, opts, film, px, py, si, valid)
        # Film merge: the automated exrassemble. psum rides ICI within a
        # slice and DCN across hosts.
        return (jax.lax.psum(film.pixels, axis),
                jax.lax.psum(film.alpha, axis),
                jax.lax.psum(film.weight_sum, axis))

    pix_acc = np.zeros((opts.yres, opts.xres, 3), np.float32)
    alpha_acc = np.zeros((opts.yres, opts.xres), np.float32)
    w_acc = np.zeros((opts.yres, opts.xres), np.float32)

    n_chunks = math.ceil(total / chunk)
    for c in range(n_chunks):
        base = c * chunk
        lin = np.arange(base, base + chunk)
        valid = lin < total
        lin = np.minimum(lin, total - 1)
        s_idx = (lin % spp).astype(np.int32)
        pixid = lin // spp
        px = (xstart + (pixid % xcount)).astype(np.int32)
        py = (ystart + (pixid // xcount)).astype(np.int32)
        out = shard_step(scene,
                         _make_global(px, mesh, axis),
                         _make_global(py, mesh, axis),
                         _make_global(s_idx, mesh, axis),
                         _make_global(valid, mesh, axis))
        # Outputs are replicated; pull the addressable copy.
        pix_acc += np.asarray(jax.device_get(out[0]))
        alpha_acc += np.asarray(jax.device_get(out[1]))
        w_acc += np.asarray(jax.device_get(out[2]))

    w = np.maximum(w_acc, 1e-10)[..., None]
    return pix_acc / w, np.clip(alpha_acc / w[..., 0], 0.0, 1.0)


def train_step_multihost(scene: SceneData, opts: R.RenderOptions, target,
                         mesh: Mesh | None = None, n_samples: int = None,
                         seed_chunk: int = 0):
    """One global inverse-rendering step: every device renders its slice
    of the sample space, losses and parameter grads psum across the whole
    mesh (shard.train_step_sharded with globally-sharded inputs)."""
    mesh = mesh or global_mesh()
    axis = mesh.axis_names[0]
    ndev = mesh.devices.size
    spp = smp.samples_per_pixel(opts.sampler)
    n = n_samples or (ndev * 256)
    n = ((n + ndev - 1) // ndev) * ndev
    film0 = film_mod.make_film(opts.xres, opts.yres, opts.crop)
    xstart, xcount, ystart, ycount = film_mod.pixel_extent(film0)
    total = xcount * ycount * spp
    lin = (np.arange(n) + seed_chunk * n) % total
    s_idx = (lin % spp).astype(np.int32)
    pixid = lin // spp
    px = (xstart + (pixid % xcount)).astype(np.int32)
    py = (ystart + (pixid // xcount)).astype(np.int32)
    return shard_mod.train_step_sharded(
        scene, opts, target,
        _make_global(px, mesh, axis), _make_global(py, mesh, axis),
        _make_global(s_idx, mesh, axis), mesh)

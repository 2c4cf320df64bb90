"""Multi-device / multi-host rendering and gradient reduction.

The reference's only distribution story is manual crop windows +
exrassemble (/root/reference/film/image.cpp:79-85, tools/exrassemble.cpp).
Here the sample space is sharded over a `jax.sharding.Mesh` "data" axis with
shard_map: every device renders its own interleaved slice of the (pixel,
sample) space with the scene replicated, accumulates a local film, and the
films are merged with a psum — the automated exrassemble. Counter-based
sampling (core/rng.py) makes shards order-invariant, so the sharded render
is bit-identical to the single-device one up to float addition order.

For inverse rendering, `train_step_sharded` computes pixel-loss
gradients with the same sample sharding; the gradient of the replicated
parameters is summed across the mesh by shard_map's transpose.
"""
from __future__ import annotations

import math
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .. import render as R
from ..cameras import cameras as cam_mod
from ..film import film as film_mod
from ..samplers import samplers as smp
from ..scene.data import SceneData


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def render_sharded(scene: SceneData, opts: R.RenderOptions,
                   mesh: Mesh | None = None):
    """Full-frame render with the sample space sharded over the mesh.

    Each device owns a full film accumulator that stays RESIDENT on device
    across all chunks (no per-chunk host transfer); the ndev partial films
    are summed once at the end — the reduce-scatter-shaped analogue of the
    reference's manual crop-window + exrassemble flow. Returns (rgb, alpha)
    numpy arrays, identical in expectation to render.render().
    """
    mesh = mesh or make_mesh()
    axis = mesh.axis_names[0]
    ndev = mesh.devices.size

    film = film_mod.make_film(opts.xres, opts.yres, opts.crop)
    xstart, xcount, ystart, ycount = film_mod.pixel_extent(film)
    spp = smp.samples_per_pixel(opts.sampler)
    total = xcount * ycount * spp
    # Round the global chunk up to a multiple of ndev.
    chunk = min(opts.chunk_size * ndev, ((total + ndev - 1) // ndev) * ndev)
    per_dev = chunk // ndev

    @jax.jit
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P(axis), P(axis), P(axis), P(axis), P(axis)),
             out_specs=P(axis))
    def shard_step(sc, fdata, px, py, si, valid):
        f = film_mod.Film(data=fdata[0], xres=opts.xres, yres=opts.yres,
                          crop=opts.crop)
        f = R.render_chunk(sc, opts, f, px, py, si, valid)
        return f.data[None]

    fdata = jnp.zeros((ndev, opts.yres, opts.xres, 5), jnp.float32)
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
        fdata = shard_step(scene, fdata, jnp.asarray(px), jnp.asarray(py),
                           jnp.asarray(s_idx), jnp.asarray(valid))

    data = np.asarray(fdata).sum(0)
    w = np.maximum(data[..., 4], 1e-10)[..., None]
    return data[..., 0:3] / w, np.clip(data[..., 3] / w[..., 0], 0.0, 1.0)


def render_loss_fn(scene: SceneData, opts: R.RenderOptions, px, py, s_idx,
                   target):
    """Mean pixel L2 between a rendered sample batch and target pixels.

    Differentiable w.r.t. scene (pytree) arrays: texture constants, light
    spectra, transforms. Discrete sampling decisions are detached inside
    the integrators (standard detached-sampling estimator).
    """
    cs = smp.camera_samples(opts.sampler, px, py, s_idx, opts.seed)
    o, d, mint, maxt, _ = cam_mod.generate_rays(
        scene.camera, cs["image_x"], cs["image_y"], cs["lens_u"],
        cs["lens_v"], cs["time"], opts.xres, opts.yres)
    L = R._li_dispatch(scene, opts, o, d, mint, maxt, px, py, s_idx)[0]
    tgt = target[py, px]
    diff = L - tgt
    return jnp.mean(jnp.sum(diff * diff, axis=-1))


def split_float_params(scene: SceneData):
    """Split the scene into (float_params tuple, rebuild fn). Grad flows
    through the float leaves only — int/bool topology tables are structural.
    """
    leaves, treedef = jax.tree.flatten(scene)
    is_float = tuple(jnp.issubdtype(l.dtype, jnp.inexact) for l in leaves)
    params = tuple(l for l, f in zip(leaves, is_float) if f)

    def rebuild(params_t):
        it = iter(params_t)
        merged = [next(it) if f else l for l, f in zip(leaves, is_float)]
        return jax.tree.unflatten(treedef, merged)

    return params, rebuild, treedef, is_float


def train_step_sharded(scene: SceneData, opts: R.RenderOptions, target,
                       px, py, s_idx, mesh: Mesh, boundary: bool = False,
                       topology=None, n_edge_samples: int = 1024,
                       seed: int = 0):
    """One inverse-rendering step: per-device loss grads, psum over mesh.

    boundary=True augments the gradient with the silhouette/visibility
    boundary terms (diff/silhouette.py: primary edges, sphere rims,
    delta- and area-light shadow curves) — the loss VALUE is unchanged.
    Pass topology=mesh_edges(np.asarray(scene.triangles.idx)) computed
    outside jit (edge extraction needs concrete indices).

    Returns (loss, grads) with grads a SceneData-shaped pytree (None outside
    differentiated float leaves).
    """
    if boundary:
        from ..diff.silhouette import (mesh_edges,
                                       render_loss_with_silhouette)
        if topology is None:
            import numpy as _np
            topology = mesh_edges(_np.asarray(scene.triangles.idx))
    axis = mesh.axis_names[0]
    params, rebuild, treedef, is_float = split_float_params(scene)
    leaves_static = jax.tree.flatten(scene)[0]

    @jax.jit  # jit so the persistent compilation cache applies
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P(), P(axis), P(axis), P(axis), P()),
             out_specs=(P(), P()))
    def step(prm, sc_rest, pxs, pys, sis, tgt):
        def loss_of_params(prm_):
            it = iter(prm_)
            rest_it = iter(sc_rest)
            merged = [next(it) if f else next(rest_it)
                      for f in is_float]
            sc = jax.tree.unflatten(treedef, merged)
            if boundary:
                return render_loss_with_silhouette(
                    sc, opts, pxs, pys, sis, tgt,
                    n_edge_samples=n_edge_samples, seed=seed,
                    topology=topology)
            return render_loss_fn(sc, opts, pxs, pys, sis, tgt)

        # Differentiate the mean over every device's samples as one
        # function. The params are replicated, so shard_map already sums
        # their gradient over the mesh; a pmean of that gradient would
        # scale it by the device count.
        return jax.value_and_grad(
            lambda p: jax.lax.pmean(loss_of_params(p), axis))(prm)

    rest = tuple(l for l, f in zip(leaves_static, is_float) if not f)
    loss, gparams = step(params, rest, px, py, s_idx, target)
    # Re-assemble a SceneData-shaped grad pytree (None on non-float leaves).
    it = iter(gparams)
    gleaves = [next(it) if f else None for f in is_float]
    grads = jax.tree.unflatten(treedef, gleaves)
    return loss, grads

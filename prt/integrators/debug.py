"""Debug channel-visualizer integrator.

Replacement for /root/reference/integrators/debug.cpp: renders
selected geometric quantities (u, v, geometric/shading normal components,
hit mask, one, zero) as the RGB channels — the renderer's "inspect
intermediate tensors" probe.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..accel import intersect as isect
from ..scene.data import SceneData


def li(scene: SceneData, o, d, mint, maxt, channels=("u", "v", "hit")):
    t, pid, hit = isect.intersect_ids(scene, o, d, mint, maxt)
    dg = isect.hit_geometry(scene, pid, o, d, t)
    hitf = hit.astype(jnp.float32)

    def chan(name):
        if name == "u":
            return dg["u"] * hitf
        if name == "v":
            return dg["v"] * hitf
        if name in ("nx", "ny", "nz"):
            i = "xyz".index(name[1])
            return (dg["nn"][..., i] * 0.5 + 0.5) * hitf
        if name in ("snx", "sny", "snz"):
            i = "xyz".index(name[2])
            return (dg["sn"][..., i] * 0.5 + 0.5) * hitf
        if name == "t":
            return jnp.where(hit, t, 0.0)
        if name == "hit":
            return hitf
        if name == "one":
            return jnp.ones_like(hitf)
        if name == "zero":
            return jnp.zeros_like(hitf)
        if name == "matid":
            return dg["material"].astype(jnp.float32) * hitf
        raise ValueError(f"unknown debug channel {name}")

    L = jnp.stack([chan(c) for c in (list(channels) + ["zero"] * 3)[:3]], -1)
    return L, hitf, jnp.where(hit, t, maxt)

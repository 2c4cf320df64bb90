"""Volume integrators: emission-only and single-scattering ray marching.

Replacement for /root/reference/integrators/emission.cpp and
single.cpp, as fixed-step masked marches:
  * emission: Li = sum Tr * Lve * dt (emission.cpp:60-95),
  * single:   adds in-scatter Tr * sigma_s * p(w,w') * Ld at each step with
    one light sample per step (single.cpp:57-116).
`transmittance` is exp(-Tau) with jittered offset (emission.cpp:47-59).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..accel import intersect as isect
from ..core import mc, rng, vecmath as vm
from ..lights import lights as lt
from ..scene.data import SceneData
from ..volumes import regions as vr

_STEPS = 32
_EPS = vm.RAY_EPSILON


def transmittance(scene: SceneData, o, d, mint, maxt, u):
    return vr.transmittance(scene.volumes, o, d, mint, maxt, u)


def li_emission(scene: SceneData, o, d, mint, maxt, u_jitter):
    """Emission-only Li (emission.cpp:60-95)."""
    vol = scene.volumes
    if vol is None or vol.count == 0:
        return jnp.zeros(o.shape[:-1] + (3,), jnp.float32)
    t0, t1, any_hit = vr._segment(vol, o, d, mint, maxt)
    seg = jnp.maximum(t1 - t0, 0.0)
    dt = seg / _STEPS
    L = jnp.zeros(o.shape[:-1] + (3,), jnp.float32)
    tau_acc = jnp.zeros(o.shape[:-1] + (3,), jnp.float32)
    for i in range(_STEPS):
        tmid = t0 + (i + u_jitter) * dt
        p = o + tmid[..., None] * d
        tau_acc = tau_acc + vr.sigma_t(vol, p) * dt[..., None]
        tr = jnp.exp(-tau_acc)
        L = L + tr * vr.lve(vol, p) * dt[..., None]
    return jnp.where(any_hit[..., None], L, 0.0)


def li_single(scene: SceneData, o, d, mint, maxt, px_hash, s_idx, seed=0):
    """Single-scattering Li (single.cpp:57-116): per-step one-light direct
    in-scatter with HG phase weighting."""
    vol = scene.volumes
    if vol is None or vol.count == 0 or scene.lights.count == 0:
        return li_emission(scene, o, d, mint, maxt,
                           rng.uniform(px_hash, s_idx, 0x70))
    n_lights = scene.lights.count
    t0, t1, any_hit = vr._segment(vol, o, d, mint, maxt)
    seg = jnp.maximum(t1 - t0, 0.0)
    dt = seg / _STEPS
    u_jit = rng.uniform(px_hash, s_idx, 0x71)
    L = jnp.zeros(o.shape[:-1] + (3,), jnp.float32)
    tau_acc = jnp.zeros(o.shape[:-1] + (3,), jnp.float32)
    for i in range(_STEPS):
        tmid = t0 + (i + u_jit) * dt
        p = o + tmid[..., None] * d
        tau_acc = tau_acc + vr.sigma_t(vol, p) * dt[..., None]
        tr = jnp.exp(-tau_acc)
        # Emission.
        L = L + tr * vr.lve(vol, p) * dt[..., None]
        # In-scatter: pick one light (single.cpp:88-115).
        u_n = rng.uniform(px_hash, s_idx, i, 0x72)
        lid = jnp.minimum((u_n * n_lights).astype(jnp.int32), n_lights - 1)
        u1 = rng.uniform(px_hash, s_idx, i, 0x73)
        u2 = rng.uniform(px_hash, s_idx, i, 0x74)
        u3 = rng.uniform(px_hash, s_idx, i, 0x75)
        # Normal argument unused by the lights we sample here; pass -d.
        sm = lt.sample(scene, lid, p, -d, u1, u2, u3)
        occ = isect.occluded(scene, p, sm["wi"],
                             jnp.full(tmid.shape, _EPS), sm["vis_maxt"])
        tr_light = vr.transmittance(vol, p, sm["wi"],
                                    jnp.zeros_like(tmid), sm["vis_maxt"],
                                    u_jit)
        ss = vr.sigma_s(vol, p)
        g = vr.mean_g(vol, p)
        ph = mc.hg_pdf(vm.dot(-d, sm["wi"]), g)
        ok = ~occ & (sm["pdf"] > 0)
        contrib = tr * ss * (ph * n_lights /
                             jnp.maximum(sm["pdf"], 1e-12))[..., None] * \
            tr_light * sm["Li"] * dt[..., None]
        L = L + jnp.where(ok[..., None], contrib, 0.0)
    return jnp.where(any_hit[..., None], L, 0.0)

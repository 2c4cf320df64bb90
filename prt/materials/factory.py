"""Material -> BSDF lobe assembly via build-time templates.

Replacement for the per-material GetBSDF constructors
(/root/reference/materials/*.cpp). A material's lobe *structure* (which
BxDFs, which Fresnel, how parameters derive from texture slots) depends only
on its kind — known at scene build. `build_templates` compiles it into
[M, L] op-code columns on the host; `make_lobes` then assembles a shading
wavefront's LobeTable with a single gather per column plus a handful of
selects, keeping the traced graph small (this is the hot path of every
bounce).

Slot conventions (MaterialTable.tex columns):
  matte:       0=Kd 1=sigma                        (matte.cpp:46-64;
               sigma==0 reduces Oren-Nayar to exact Lambertian, A=1,B=0)
  plastic:     0=Kd 1=Ks 2=roughness               (plastic.cpp:46-68)
  glass:       0=Kr 1=Kt 2=index                   (glass.cpp:46-63)
  mirror:      0=Kr                                (mirror.cpp)
  shinymetal:  0=Ks 1=Kr 2=roughness               (shinymetal.cpp:45-66)
  substrate:   0=Kd 1=Ks 2=uroughness 3=vroughness (substrate.cpp:47-63)
  translucent: 0=Kd 1=Ks 2=roughness 3=reflect 4=transmit (translucent.cpp)
  uber:        0=Kd 1=Ks 2=Kr 3=roughness 4=opacity (uber.cpp:52-88)
  measured:    none (kind encodes which measurement)

A lobe whose evaluated scale is exactly black is disabled at shading time,
matching the reference's conditional bsdf->Add() so component counts and
mixture pdfs agree.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import jax.numpy as jnp

from ..bsdf import bsdf as B

MAT_MATTE = 0
MAT_PLASTIC = 1
MAT_GLASS = 2
MAT_MIRROR = 3
MAT_SHINYMETAL = 4
MAT_SUBSTRATE = 5
MAT_TRANSLUCENT = 6
MAT_UBER = 7
MAT_MEASURED_BASE = 8      # 8..13 = bluepaint..skin
NUM_MEASURED = 6

MAX_LOBES = 4

MATERIAL_KINDS = {
    "matte": MAT_MATTE, "plastic": MAT_PLASTIC, "glass": MAT_GLASS,
    "mirror": MAT_MIRROR, "shinymetal": MAT_SHINYMETAL,
    "substrate": MAT_SUBSTRATE, "translucent": MAT_TRANSLUCENT,
    "uber": MAT_UBER,
    "bluepaint": MAT_MEASURED_BASE + 0, "brushedmetal": MAT_MEASURED_BASE + 1,
    "clay": MAT_MEASURED_BASE + 2, "felt": MAT_MEASURED_BASE + 3,
    "primer": MAT_MEASURED_BASE + 4, "skin": MAT_MEASURED_BASE + 5,
}

_FL_DIFF_R = B.REFLECTION | B.DIFFUSE
_FL_GLOS_R = B.REFLECTION | B.GLOSSY
_FL_SPEC_R = B.REFLECTION | B.SPECULAR
_FL_SPEC_T = B.TRANSMISSION | B.SPECULAR
_FL_DIFF_T = B.TRANSMISSION | B.DIFFUSE
_FL_GLOS_T = B.TRANSMISSION | B.GLOSSY

# R op codes: how the lobe scale derives from slot values a, b.
R_NONE = 0          # lobe absent
R_ONE = 1           # 1
R_SLOT = 2          # clamp01(slot a)
R_PROD = 3          # clamp01(slot a) * clamp01(slot b)
R_ONE_MINUS = 4     # 1 - clamp01(slot a)
R_MEASURED = 5      # measured diffuse table row aux0

# eta/k op codes.
E_NONE = 0          # eta = (1,1,1), k = 0
E_DIEL_15 = 1       # FresnelDielectric(1.5, 1)
E_DIEL_IDX = 2      # FresnelDielectric(1, slot a float)  (glass)
E_APPROX = 3        # FresnelConductor(FresnelApproxEta(slot a), 0)
E_KS = 4            # k = clamp01(slot a)  (FresnelBlend Rs)
E_PASS = 5          # FresnelDielectric(1, 1)  (uber opacity passthrough)

# p op codes (lobe_p columns 0,1).
P_NONE = 0
P_INV_A = 1         # p0 = 1/slot a (roughness -> exponent)
P_SIGMA_AB = 2      # Oren-Nayar A,B from sigma degrees in slot a
P_INV_AB = 3        # p0 = 1/slot a, p1 = 1/slot b (aniso)


def build_templates(mats: List[Tuple[int, List[int], int]]):
    """Host-side: (kind, tex_slots, bump) list -> template column arrays."""
    M = len(mats)
    L = MAX_LOBES
    cols = {k: np.zeros((M, L), np.int32) for k in
            ("kind", "flags", "aux0", "aux1", "rop", "ra", "rb",
             "eop", "ea", "pop", "pa", "pb")}
    cols["kind"][:] = B.BX_NONE
    flip = np.zeros((M, L), bool)

    def lobe(m, li, kind, flags, rop=R_ONE, ra=0, rb=0, eop=E_NONE, ea=0,
             pop=P_NONE, pa=0, pb=0, aux0=0, aux1=0, fl=False):
        cols["kind"][m, li] = kind
        cols["flags"][m, li] = flags
        cols["rop"][m, li] = rop
        cols["ra"][m, li] = ra
        cols["rb"][m, li] = rb
        cols["eop"][m, li] = eop
        cols["ea"][m, li] = ea
        cols["pop"][m, li] = pop
        cols["pa"][m, li] = pa
        cols["pb"][m, li] = pb
        cols["aux0"][m, li] = aux0
        cols["aux1"][m, li] = aux1
        flip[m, li] = fl

    for m, (kind, slots, bump) in enumerate(mats):
        if kind == MAT_MATTE:
            lobe(m, 0, B.BX_ORENNAYAR, _FL_DIFF_R, R_SLOT, 0,
                 pop=P_SIGMA_AB, pa=1)
        elif kind == MAT_PLASTIC:
            lobe(m, 0, B.BX_LAMBERTIAN, _FL_DIFF_R, R_SLOT, 0)
            lobe(m, 1, B.BX_MICROFACET, _FL_GLOS_R, R_SLOT, 1,
                 eop=E_DIEL_15, pop=P_INV_A, pa=2,
                 aux0=B.FR_DIELECTRIC, aux1=B.DIST_BLINN)
        elif kind == MAT_GLASS:
            lobe(m, 0, B.BX_SPECREFL, _FL_SPEC_R, R_SLOT, 0,
                 eop=E_DIEL_IDX, ea=2, aux0=B.FR_DIELECTRIC)
            lobe(m, 1, B.BX_SPECTRANS, _FL_SPEC_T, R_SLOT, 1,
                 eop=E_DIEL_IDX, ea=2)
        elif kind == MAT_MIRROR:
            lobe(m, 0, B.BX_SPECREFL, _FL_SPEC_R, R_SLOT, 0, aux0=B.FR_NOOP)
        elif kind == MAT_SHINYMETAL:
            lobe(m, 0, B.BX_MICROFACET, _FL_GLOS_R, R_ONE,
                 eop=E_APPROX, ea=0, pop=P_INV_A, pa=2,
                 aux0=B.FR_CONDUCTOR, aux1=B.DIST_BLINN)
            lobe(m, 1, B.BX_SPECREFL, _FL_SPEC_R, R_ONE,
                 eop=E_APPROX, ea=1, aux0=B.FR_CONDUCTOR)
        elif kind == MAT_SUBSTRATE:
            lobe(m, 0, B.BX_FRESNELBLEND, _FL_GLOS_R, R_SLOT, 0,
                 eop=E_KS, ea=1, pop=P_INV_AB, pa=2, pb=3, aux1=B.DIST_ANISO)
        elif kind == MAT_TRANSLUCENT:
            lobe(m, 0, B.BX_LAMBERTIAN, _FL_DIFF_R, R_PROD, 3, 0)
            lobe(m, 1, B.BX_LAMBERTIAN, _FL_DIFF_T, R_PROD, 4, 0, fl=True)
            lobe(m, 2, B.BX_MICROFACET, _FL_GLOS_R, R_PROD, 3, 1,
                 eop=E_DIEL_15, pop=P_INV_A, pa=2,
                 aux0=B.FR_DIELECTRIC, aux1=B.DIST_BLINN)
            lobe(m, 3, B.BX_MICROFACET, _FL_GLOS_T, R_PROD, 4, 1,
                 eop=E_DIEL_15, pop=P_INV_A, pa=2,
                 aux0=B.FR_DIELECTRIC, aux1=B.DIST_BLINN, fl=True)
        elif kind == MAT_UBER:
            lobe(m, 0, B.BX_SPECTRANS, _FL_SPEC_T, R_ONE_MINUS, 4, eop=E_PASS)
            lobe(m, 1, B.BX_LAMBERTIAN, _FL_DIFF_R, R_PROD, 4, 0)
            lobe(m, 2, B.BX_MICROFACET, _FL_GLOS_R, R_PROD, 4, 1,
                 eop=E_DIEL_15, pop=P_INV_A, pa=3,
                 aux0=B.FR_DIELECTRIC, aux1=B.DIST_BLINN)
            lobe(m, 3, B.BX_SPECREFL, _FL_SPEC_R, R_PROD, 4, 2,
                 eop=E_DIEL_15, aux0=B.FR_DIELECTRIC)
        elif kind >= MAT_MEASURED_BASE:
            mid = min(kind - MAT_MEASURED_BASE, NUM_MEASURED - 1)
            lobe(m, 0, B.BX_LAFORTUNE, _FL_DIFF_R, R_MEASURED, aux0=mid)

    # Clear flags on absent lobes.
    cols["flags"][cols["kind"] == B.BX_NONE] = 0
    out = {f"t_{k}": jnp.asarray(v) for k, v in cols.items()
           if k in ("kind", "flags", "aux0", "aux1")}
    out.update(t_flip=jnp.asarray(flip),
               t_rop=jnp.asarray(cols["rop"]), t_ra=jnp.asarray(cols["ra"]),
               t_rb=jnp.asarray(cols["rb"]), t_eop=jnp.asarray(cols["eop"]),
               t_ea=jnp.asarray(cols["ea"]), t_pop=jnp.asarray(cols["pop"]),
               t_pa=jnp.asarray(cols["pa"]), t_pb=jnp.asarray(cols["pb"]),
               lobe_kinds=tuple(sorted(
                   {int(k) for k in cols["kind"].ravel() if k != B.BX_NONE})),
               dist_kinds=tuple(sorted({
                   int(d) for k, d in zip(cols["kind"].ravel(),
                                          cols["aux1"].ravel())
                   if k in (B.BX_MICROFACET, B.BX_FRESNELBLEND)})))
    return out


def make_lobes(materials, mat_id, tex_vals) -> B.LobeTable:
    """Assemble the wavefront LobeTable from templates + texture values.

    mat_id: i32[N]; tex_vals: f32[Ntex, N, 3].

    Per-lane row gathers are the expensive op here, so all 12 template
    columns are stacked host-shape-side into ONE [M, L, C] table and
    gathered once; texture-slot lookups (ids in [0, 8), textures in
    [0, Ntex)) become static select chains over the tiny id spaces —
    elementwise selects instead of advanced gathers.
    """
    n = mat_id.shape[0]
    mid = jnp.maximum(mat_id, 0)
    L = materials.t_kind.shape[1]

    # ---- ONE gather for every per-lobe template column ----
    stacked = jnp.stack(
        [materials.t_kind, materials.t_flags, materials.t_flip.astype(
            materials.t_kind.dtype), materials.t_aux0, materials.t_aux1,
         materials.t_rop, materials.t_ra, materials.t_rb, materials.t_eop,
         materials.t_ea, materials.t_pop, materials.t_pa, materials.t_pb],
        axis=-1)                                        # [M, L, 13]
    cols = stacked[mid]                                 # [N, L, 13] 1 gather
    kind, flags = cols[..., 0], cols[..., 1]
    flip = cols[..., 2].astype(bool)
    aux0, aux1 = cols[..., 3], cols[..., 4]
    rop = cols[..., 5]
    c_ra, c_rb = cols[..., 6], cols[..., 7]
    eop, c_ea = cols[..., 8], cols[..., 9]
    pop, c_pa, c_pb = cols[..., 10], cols[..., 11], cols[..., 12]
    tex_ids = materials.tex[mid]                        # [N, 8] 1 gather

    # Per-lane slot values [N, 8, 3] by selecting over the texture roster.
    ntex = tex_vals.shape[0]
    nslots = tex_ids.shape[1]
    if ntex:
        sv_raw = jnp.zeros((n, nslots, 3), jnp.float32)
        for i in range(ntex):
            sv_raw = jnp.where((tex_ids == i)[..., None], tex_vals[i][:, None],
                               sv_raw)
        sv = jnp.clip(jnp.where((tex_ids >= 0)[..., None], sv_raw, 0.0),
                      0.0, 1.0)
    else:
        sv_raw = jnp.ones((n, nslots, 3), jnp.float32)
        sv = jnp.zeros((n, nslots, 3), jnp.float32)

    def slot(col, table=None):              # col: [N, L] -> value [N, L, 3]
        src = sv if table is None else table
        v = jnp.zeros((n, L, 3), jnp.float32)
        for s in range(nslots):
            v = jnp.where((col == s)[..., None], src[:, s][:, None], v)
        return v

    sa = slot(c_ra)
    sb = slot(c_rb)

    from .lafortune_data import DIFFUSE
    meas_diff = jnp.zeros((n, L, 3), jnp.float32)
    for i in range(NUM_MEASURED):
        meas_diff = jnp.where(
            (jnp.clip(aux0, 0, NUM_MEASURED - 1) == i)[..., None],
            jnp.asarray(DIFFUSE[i]), meas_diff)
    R = jnp.where((rop == R_SLOT)[..., None], sa,
        jnp.where((rop == R_PROD)[..., None], sa * sb,
        jnp.where((rop == R_ONE_MINUS)[..., None], 1.0 - sa,
        jnp.where((rop == R_MEASURED)[..., None], meas_diff,
        jnp.where((rop == R_ONE)[..., None], 1.0, 0.0)))))

    ea_raw = slot(c_ea)                     # clamped [N,L,3]
    # E_DIEL_IDX needs the unclamped float (IOR can exceed 1).
    ea_unc = slot(c_ea, table=sv_raw)
    ones3 = jnp.ones_like(R)
    eta = ones3
    eta = jnp.where((eop == E_DIEL_15)[..., None],
                    jnp.stack([1.5 * ones3[..., 0], ones3[..., 1],
                               ones3[..., 2]], -1), eta)
    eta = jnp.where((eop == E_DIEL_IDX)[..., None],
                    jnp.stack([ones3[..., 0], ea_unc[..., 0],
                               ones3[..., 2]], -1), eta)
    eta = jnp.where((eop == E_APPROX)[..., None],
                    B.fresnel_approx_eta(ea_raw), eta)
    k_ = jnp.where((eop == E_KS)[..., None], ea_raw, jnp.zeros_like(R))

    pa = slot(c_pa)[..., 0]
    pb = slot(c_pb)[..., 0]
    inv = lambda x: 1.0 / jnp.maximum(x, 1e-5)
    sig = jnp.radians(pa)
    sig2 = sig * sig
    A_on = 1.0 - sig2 / (2.0 * (sig2 + 0.33))
    B_on = 0.45 * sig2 / (sig2 + 0.09)
    p0 = jnp.where(pop == P_INV_A, inv(pa),
         jnp.where(pop == P_SIGMA_AB, A_on,
         jnp.where(pop == P_INV_AB, inv(pa), 0.0)))
    p1 = jnp.where(pop == P_SIGMA_AB, B_on,
         jnp.where(pop == P_INV_AB, inv(pb), 0.0))
    # Blinn exponent cap (reflection.h:313).
    p0 = jnp.minimum(p0, 10000.0)
    p1 = jnp.minimum(p1, 10000.0)
    p = jnp.stack([p0, p1, jnp.zeros_like(p0), jnp.zeros_like(p0)], -1)

    # Disable exactly-black lobes (reference's conditional Add()).
    scale_black = jnp.all(R == 0.0, axis=-1)
    fb = kind == B.BX_FRESNELBLEND
    dead = jnp.where(fb, scale_black & jnp.all(k_ == 0.0, -1), scale_black)
    dead = dead | (kind == B.BX_NONE)
    kind = jnp.where(dead, B.BX_NONE, kind)
    flags = jnp.where(dead, 0, flags)

    return B.LobeTable(kind=kind, flags=flags, flip=flip, R=R, eta=eta,
                       k=k_, p=p, aux0=aux0, aux1=aux1,
                       kinds_present=materials.lobe_kinds,
                       dist_kinds=materials.dist_kinds)

"""Host-side scene compilation: Python API -> frozen SoA SceneData.

This is the replacement for the reference's scene-construction
API + RenderOptions::MakeScene (/root/reference/core/api.cpp:354-529): all
object creation, transform application, tessellation, and table packing
happen eagerly on the host in numpy; `build()` freezes everything into the
SceneData pytree of device arrays. The pbrt-format parser (scene/parser.py)
drives this same builder, mirroring how every grammar production calls one
pbrt* API function.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core import transform as tf
from ..materials.factory import MATERIAL_KINDS
from ..textures.graph import TexGraph, TexNodeMeta
from . import data as D

_TWO_PI = 2.0 * math.pi - 1e-6


def _quadric_static_row(kind: int, params) -> Tuple[int, bool, bool]:
    """Build-time facts for QuadricTable.static_rows: (kind, phi_full,
    z_full). phi_full — phimax covers the full circle; z_full — the z clip
    window cannot reject any point of the surface (only possible for the
    sphere, whose z range is intrinsically bounded by +-radius; every other
    kind's z window IS part of its definition)."""
    p = np.asarray(params, np.float64)
    if kind == D.QUADRIC_SPHERE:
        phi_full = p[3] >= _TWO_PI
        z_full = (p[1] <= -p[0] * (1.0 - 1e-5)) and \
                 (p[2] >= p[0] * (1.0 - 1e-5))
        return (kind, bool(phi_full), bool(z_full))
    if kind == D.QUADRIC_DISK:
        return (kind, bool(p[3] >= _TWO_PI), True)
    if kind == D.QUADRIC_CONE:
        return (kind, bool(p[2] >= _TWO_PI), False)
    if kind == D.QUADRIC_HYPERBOLOID:
        return (kind, bool(p[6] >= _TWO_PI), False)
    # cylinder / paraboloid: phimax in p[3]; z window always meaningful.
    return (kind, bool(p[3] >= _TWO_PI), False)


@dataclass
class _Quadric:
    kind: int
    o2w: np.ndarray
    params: np.ndarray
    material: int
    area_light: int
    flip: float


@dataclass
class _Mesh:
    verts: np.ndarray          # world space [V,3]
    idx: np.ndarray            # [T,3]
    normals: Optional[np.ndarray]
    uv: Optional[np.ndarray]
    tangents: Optional[np.ndarray]
    material: int
    area_light: int
    flip: float


@dataclass
class _Light:
    kind: int
    l2w: np.ndarray
    spectrum: np.ndarray
    params: np.ndarray = field(default_factory=lambda: np.zeros(8, np.float32))
    nsamples: int = 1
    image: int = -1
    area_geom_kind: int = 0
    area_first: int = 0
    area_count: int = 1
    area_total: float = 0.0
    tri_areas: Optional[np.ndarray] = None
    importance: bool = False   # infinitesample: map importance sampling


class SceneBuilder:
    def __init__(self):
        self.quadrics: List[_Quadric] = []
        self.meshes: List[_Mesh] = []
        self.materials: List[Tuple[int, List[int], int]] = []  # kind, tex, bump
        self.tex_nodes: List[TexNodeMeta] = []
        self.tex_fparams: List[np.ndarray] = []
        self.tex_w2t: List[np.ndarray] = []
        self.images: List[Tuple[Tuple[np.ndarray, ...], int]] = []
        self.lights: List[_Light] = []
        self.volumes: List[Dict[str, Any]] = []
        self.camera: Optional[D.CameraData] = None
        self.accel_kind: str = "auto"
        self.accel_params: Dict[str, Any] = {}
        self._const_cache: Dict[Tuple[float, float, float], int] = {}
        # Ray-transform instancing: prototype meshes + (proto, o2w) pairs.
        self.protos: List[Dict[str, Any]] = []
        self.instances: List[Tuple[int, np.ndarray]] = []
        self.instance_area_light: List[int] = []

    # ---- textures -------------------------------------------------------
    def add_texture(self, meta: TexNodeMeta, fparams=None, w2t=None) -> int:
        fp = np.zeros(16, np.float32)
        if fparams is not None:
            fp[: len(fparams)] = np.asarray(fparams, np.float32)
        m = np.eye(4, dtype=np.float32) if w2t is None else np.asarray(w2t, np.float32)
        self.tex_nodes.append(meta)
        self.tex_fparams.append(fp)
        self.tex_w2t.append(m)
        return len(self.tex_nodes) - 1

    def constant_texture(self, value) -> int:
        v = np.asarray(value, np.float32)
        if v.ndim == 0:
            v = np.repeat(v[None], 3)
        key = tuple(np.round(v, 7).tolist())
        if key in self._const_cache:
            return self._const_cache[key]
        tid = self.add_texture(TexNodeMeta(kind="constant"), fparams=v)
        self._const_cache[key] = tid
        return tid

    def add_image(self, levels: Tuple[np.ndarray, ...], wrap: int = 0) -> int:
        self.images.append((levels, wrap))
        return len(self.images) - 1

    # ---- materials ------------------------------------------------------
    def add_material(self, kind: str, tex_slots: List[int], bump: int = -1) -> int:
        k = MATERIAL_KINDS[kind]
        slots = list(tex_slots) + [-1] * (8 - len(tex_slots))
        self.materials.append((k, slots[:8], bump))
        return len(self.materials) - 1

    def matte(self, kd=(0.5, 0.5, 0.5), sigma=0.0, kd_tex=None, sigma_tex=None):
        kd_t = kd_tex if kd_tex is not None else self.constant_texture(kd)
        sg_t = sigma_tex if sigma_tex is not None else self.constant_texture(sigma)
        return self.add_material("matte", [kd_t, sg_t])

    def plastic(self, kd=(0.25,) * 3, ks=(0.25,) * 3, roughness=0.1):
        return self.add_material("plastic", [
            self.constant_texture(kd), self.constant_texture(ks),
            self.constant_texture(roughness)])

    def glass(self, kr=(1.0,) * 3, kt=(1.0,) * 3, index=1.5):
        return self.add_material("glass", [
            self.constant_texture(kr), self.constant_texture(kt),
            self.constant_texture(index)])

    def mirror(self, kr=(0.9,) * 3):
        return self.add_material("mirror", [self.constant_texture(kr)])

    # ---- shapes ---------------------------------------------------------
    def add_sphere(self, o2w, radius=1.0, zmin=None, zmax=None, phimax=360.0,
                   material=0, area_light=-1, reverse_orientation=False):
        o2w = np.asarray(o2w, np.float32)
        zmin = -radius if zmin is None else max(zmin, -radius)
        zmax = radius if zmax is None else min(zmax, radius)
        thetamin = math.acos(np.clip(zmin / radius, -1, 1))
        thetamax = math.acos(np.clip(zmax / radius, -1, 1))
        # theta measured from +z: acos(zmax) < acos(zmin); store min->max as
        # the reference does (sphere.cpp:93-98 uses thetaMin=acos(zmin)).
        params = np.array([radius, zmin, zmax, math.radians(phimax),
                           thetamin, thetamax, 0, 0], np.float32)
        flip = -1.0 if (reverse_orientation ^ tf.swaps_handedness(o2w)) else 1.0
        self.quadrics.append(_Quadric(D.QUADRIC_SPHERE, o2w, params,
                                      material, area_light, flip))
        return len(self.quadrics) - 1

    def add_cylinder(self, o2w, radius=1.0, zmin=-1.0, zmax=1.0, phimax=360.0,
                     material=0, area_light=-1, reverse_orientation=False):
        o2w = np.asarray(o2w, np.float32)
        params = np.array([radius, zmin, zmax, math.radians(phimax),
                           0, 0, 0, 0], np.float32)
        flip = -1.0 if (reverse_orientation ^ tf.swaps_handedness(o2w)) else 1.0
        self.quadrics.append(_Quadric(D.QUADRIC_CYLINDER, o2w, params,
                                      material, area_light, flip))
        return len(self.quadrics) - 1

    def add_disk(self, o2w, height=0.0, radius=1.0, inner_radius=0.0,
                 phimax=360.0, material=0, area_light=-1,
                 reverse_orientation=False):
        o2w = np.asarray(o2w, np.float32)
        params = np.array([height, radius, inner_radius, math.radians(phimax),
                           0, 0, 0, 0], np.float32)
        flip = -1.0 if (reverse_orientation ^ tf.swaps_handedness(o2w)) else 1.0
        self.quadrics.append(_Quadric(D.QUADRIC_DISK, o2w, params,
                                      material, area_light, flip))
        return len(self.quadrics) - 1

    def add_cone(self, o2w, radius=1.0, height=1.0, phimax=360.0, material=0,
                 area_light=-1, reverse_orientation=False):
        o2w = np.asarray(o2w, np.float32)
        params = np.array([radius, height, math.radians(phimax),
                           0, 0, 0, 0, 0], np.float32)
        flip = -1.0 if (reverse_orientation ^ tf.swaps_handedness(o2w)) else 1.0
        self.quadrics.append(_Quadric(D.QUADRIC_CONE, o2w, params,
                                      material, area_light, flip))
        return len(self.quadrics) - 1

    def add_paraboloid(self, o2w, radius=1.0, zmin=0.0, zmax=1.0,
                       phimax=360.0, material=0, area_light=-1,
                       reverse_orientation=False):
        o2w = np.asarray(o2w, np.float32)
        params = np.array([radius, zmin, zmax, math.radians(phimax),
                           0, 0, 0, 0], np.float32)
        flip = -1.0 if (reverse_orientation ^ tf.swaps_handedness(o2w)) else 1.0
        self.quadrics.append(_Quadric(D.QUADRIC_PARABOLOID, o2w, params,
                                      material, area_light, flip))
        return len(self.quadrics) - 1

    def add_hyperboloid(self, o2w, p1=(0, 0, 0), p2=(1, 1, 1), phimax=360.0,
                        material=0, area_light=-1, reverse_orientation=False):
        """Solve the implicit coefficients a, c like the reference ctor
        (shapes/hyperboloid.cpp:38-70)."""
        o2w = np.asarray(o2w, np.float32)
        p1 = np.asarray(p1, np.float64)
        p2 = np.asarray(p2, np.float64)
        if p2[2] == 0:
            p1, p2 = p2, p1
        pp = p1.copy()
        a = c = 0.0
        for _ in range(1000):
            pp = pp + 2.0 * (p2 - pp)
            xy1 = pp[0] ** 2 + pp[1] ** 2
            xy2 = p2[0] ** 2 + p2[1] ** 2
            denom = xy1 * p2[2] ** 2 - xy2 * pp[2] ** 2
            if abs(denom) > 1e-12:
                a = (pp[2] ** 2 - p2[2] ** 2) / denom * -1.0
                a = (1.0 * (pp[2] ** 2) - 1.0 * (p2[2] ** 2))
                # a,c from solving a*xy - c*z^2 = 1 at pp and p2:
                M = np.array([[xy1, -pp[2] ** 2], [xy2, -p2[2] ** 2]])
                try:
                    sol = np.linalg.solve(M, np.ones(2))
                    a, c = sol[0], sol[1]
                    if not (math.isinf(a) or math.isnan(a)):
                        break
                except np.linalg.LinAlgError:
                    continue
        params = np.array([a, c, p1[2], p1[0], p1[1], p2[2],
                           math.radians(phimax), 0], np.float32)
        flip = -1.0 if (reverse_orientation ^ tf.swaps_handedness(o2w)) else 1.0
        self.quadrics.append(_Quadric(D.QUADRIC_HYPERBOLOID, o2w, params,
                                      material, area_light, flip))
        return len(self.quadrics) - 1

    def add_trianglemesh(self, o2w, indices, P, N=None, uv=None, S=None,
                         material=0, area_light=-1,
                         reverse_orientation=False):
        """World-space mesh like the reference TriangleMesh ctor
        (shapes/trianglemesh.cpp:38-64 transforms verts to world)."""
        o2w = np.asarray(o2w, np.float32)
        P = np.asarray(P, np.float32).reshape(-1, 3)
        idx = np.asarray(indices, np.int32).reshape(-1, 3)
        vw = (P @ o2w[:3, :3].T) + o2w[:3, 3]
        nw = None
        if N is not None:
            n = np.asarray(N, np.float32).reshape(-1, 3)
            inv = np.linalg.inv(o2w)
            nw = n @ inv[:3, :3]  # inverse-transpose
            nw /= np.maximum(np.linalg.norm(nw, axis=-1, keepdims=True), 1e-12)
        sw = None
        if S is not None:
            s = np.asarray(S, np.float32).reshape(-1, 3)
            sw = s @ o2w[:3, :3].T
        uvw = np.asarray(uv, np.float32).reshape(-1, 2) if uv is not None else None
        flip = -1.0 if (reverse_orientation ^ tf.swaps_handedness(o2w)) else 1.0
        self.meshes.append(_Mesh(vw, idx, nw, uvw, sw, material, area_light,
                                 flip))
        return len(self.meshes) - 1

    def add_prototype(self, indices, P, N=None, uv=None, material=0,
                      reverse_orientation=False, o2w=None,
                      area_light_L=None, area_nsamples=1) -> int:
        """Object-space prototype mesh for ray-transform instancing
        (ObjectBegin geometry; o2w = the definition-time CTM, baked into
        the prototype's object space like api.cpp's shape transform)."""
        P = np.asarray(P, np.float32).reshape(-1, 3)
        idx = np.asarray(indices, np.int32).reshape(-1, 3)
        nrm = None
        flip_swap = False
        if o2w is not None:
            o2w = np.asarray(o2w, np.float32)
            P = (P @ o2w[:3, :3].T) + o2w[:3, 3]
            flip_swap = tf.swaps_handedness(o2w)
            if N is not None:
                n = np.asarray(N, np.float32).reshape(-1, 3)
                inv = np.linalg.inv(o2w)
                nrm = n @ inv[:3, :3]
                nrm /= np.maximum(
                    np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
        elif N is not None:
            nrm = np.asarray(N, np.float32).reshape(-1, 3)
        uvw = np.asarray(uv, np.float32).reshape(-1, 2) \
            if uv is not None else None
        flip = -1.0 if (bool(reverse_orientation) ^ flip_swap) else 1.0
        self.protos.append(dict(
            verts=P, idx=idx, uv=uvw, normals=nrm, material=material,
            flip=flip,
            area_L=(np.asarray(area_light_L, np.float32)
                    if area_light_L is not None else None),
            area_nsamples=area_nsamples))
        return len(self.protos) - 1

    def add_instance(self, proto_id: int, o2w) -> int:
        """Place an instance of a prototype under transform o2w
        (ObjectInstance; reference core/primitive.cpp:66-85). An EMISSIVE
        prototype (add_prototype area_light_L=...) makes each instance a
        DISTINCT area light whose geometry stays in the shared instance
        table (AREA_GEOM_INST): one LightTable row + one CDF segment per
        instance, O(proto) geometry. Requires a similarity transform
        (relative triangle areas must be preserved for the shared
        area-CDF to stay correct)."""
        o2w = np.asarray(o2w, np.float32)
        self.instances.append((proto_id, o2w))
        pr = self.protos[proto_id]
        lid = -1
        if pr.get("area_L") is not None:
            A = o2w[:3, :3]
            det = float(np.linalg.det(A))
            s_lin = abs(det) ** (1.0 / 3.0)
            if not np.allclose(A @ A.T, (s_lin * s_lin) * np.eye(3),
                               atol=1e-4 * max(s_lin * s_lin, 1.0)):
                raise ValueError(
                    "instanced area emitters need a similarity transform "
                    "(rotation + uniform scale + translation); fold "
                    "non-uniform scales into the prototype or duplicate")
            v = pr["verts"]
            idx = pr["idx"]
            p0, p1, p2 = v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]]
            areas = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0),
                                         axis=-1)
            params = np.zeros(8, np.float32)
            params[5] = 1.0 if det >= 0 else -1.0
            lid = len(self.lights)
            self.lights.append(_Light(
                D.LIGHT_AREA, o2w, pr["area_L"], params=params,
                nsamples=pr.get("area_nsamples", 1),
                area_geom_kind=D.AREA_GEOM_INST, area_first=proto_id,
                area_count=len(areas),
                area_total=float(areas.sum()) * s_lin * s_lin,
                tri_areas=areas))
        self.instance_area_light.append(lid)
        return len(self.instances) - 1

    # ---- lights ---------------------------------------------------------
    def add_point_light(self, l2w, intensity=(1.0,) * 3):
        l2w = np.asarray(l2w, np.float32)
        self.lights.append(_Light(D.LIGHT_POINT, l2w,
                                  np.asarray(intensity, np.float32)))
        return len(self.lights) - 1

    def add_spot_light(self, l2w, intensity=(1.0,) * 3, coneangle=30.0,
                       conedeltaangle=5.0):
        params = np.zeros(8, np.float32)
        params[0] = math.cos(math.radians(coneangle))
        params[1] = math.cos(math.radians(coneangle - conedeltaangle))
        self.lights.append(_Light(D.LIGHT_SPOT, np.asarray(l2w, np.float32),
                                  np.asarray(intensity, np.float32), params))
        return len(self.lights) - 1

    def add_distant_light(self, l2w, L=(1.0,) * 3, frm=(0, 0, 0), to=(0, 0, 1)):
        l2w = np.asarray(l2w, np.float32)
        d = np.asarray(frm, np.float64) - np.asarray(to, np.float64)
        dw = l2w[:3, :3] @ d
        dw /= np.linalg.norm(dw)
        params = np.zeros(8, np.float32)
        params[0:3] = dw
        self.lights.append(_Light(D.LIGHT_DISTANT, l2w,
                                  np.asarray(L, np.float32), params))
        return len(self.lights) - 1

    def add_infinite_light(self, l2w, L=(1.0,) * 3, image=-1, nsamples=1,
                           importance=False):
        """importance=True selects the infinitesample behavior
        (/root/reference/lights/infinitesample.cpp): luminance*sin(theta)
        CDF tables are built over the map at scene build."""
        self.lights.append(_Light(D.LIGHT_INFINITE, np.asarray(l2w, np.float32),
                                  np.asarray(L, np.float32), image=image,
                                  nsamples=nsamples,
                                  importance=importance and image >= 0))
        return len(self.lights) - 1

    def add_projection_light(self, l2w, intensity=(1.0,) * 3, fov=45.0,
                             image=-1, aspect=1.0):
        params = np.zeros(8, np.float32)
        inv_tan = 1.0 / math.tan(math.radians(fov) / 2.0)
        params[0] = inv_tan
        params[1] = inv_tan
        if aspect > 1.0:
            params[4:8] = [-aspect, aspect, -1.0, 1.0]
        else:
            params[4:8] = [-1.0, 1.0, -1.0 / aspect, 1.0 / aspect]
        self.lights.append(_Light(
            D.LIGHT_PROJECTION, np.asarray(l2w, np.float32),
            np.asarray(intensity, np.float32), params, image=image))
        return len(self.lights) - 1

    def add_goniometric_light(self, l2w, intensity=(1.0,) * 3, image=-1):
        self.lights.append(_Light(
            D.LIGHT_GONIOMETRIC, np.asarray(l2w, np.float32),
            np.asarray(intensity, np.float32), image=image))
        return len(self.lights) - 1

    def add_area_light_sphere(self, quadric_id: int, L=(1.0,) * 3,
                              nsamples=1):
        """Area light on a quadric (sphere/disk/cylinder, the shapes the
        reference implements Sample/Area for: sphere.cpp:45-86,
        disk.cpp:36-44,127-130, cylinder.cpp)."""
        q = self.quadrics[quadric_id]
        p = [float(x) for x in q.params]
        if q.kind == D.QUADRIC_SPHERE:
            # phiMax * r * (zmax - zmin) (sphere.cpp Area()).
            area = p[3] * p[0] * (p[2] - p[1])
        elif q.kind == D.QUADRIC_DISK:
            # params [height, radius, inner, phimax]: phiMax/2 (r^2 - ri^2).
            area = 0.5 * p[3] * (p[1] * p[1] - p[2] * p[2])
        elif q.kind == D.QUADRIC_CYLINDER:
            # (zmax - zmin) * r * phiMax (cylinder.cpp Area()).
            area = (p[2] - p[1]) * p[0] * p[3]
        else:
            from ..utils import errors
            errors.warning("area light on unsupported quadric kind "
                           f"{q.kind}; the reference Severe()s here "
                           "(core/shape.h:85-91). Using sphere formula.")
            area = p[3] * p[0] * abs(p[2] - p[1])
        lid = len(self.lights)
        light = _Light(D.LIGHT_AREA, q.o2w, np.asarray(L, np.float32),
                       nsamples=nsamples, area_geom_kind=D.AREA_GEOM_QUADRIC,
                       area_first=quadric_id, area_count=1, area_total=area)
        self.lights.append(light)
        q.area_light = lid
        return lid

    def add_area_light_mesh(self, mesh_id: int, L=(1.0,) * 3, nsamples=1):
        """Registered at build(): triangle range assigned after packing."""
        m = self.meshes[mesh_id]
        v = m.verts
        p0, p1, p2 = v[m.idx[:, 0]], v[m.idx[:, 1]], v[m.idx[:, 2]]
        areas = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)
        lid = len(self.lights)
        light = _Light(D.LIGHT_AREA, np.eye(4, dtype=np.float32),
                       np.asarray(L, np.float32), nsamples=nsamples,
                       area_geom_kind=D.AREA_GEOM_TRIS, area_first=mesh_id,
                       area_count=len(areas), area_total=float(areas.sum()),
                       tri_areas=areas)
        self.lights.append(light)
        m.area_light = lid
        return lid

    # ---- volumes --------------------------------------------------------
    def add_volume(self, kind: str, v2w, p0=(0, 0, 0), p1=(1, 1, 1),
                   sigma_a=(1.0,) * 3, sigma_s=(1.0,) * 3, le=(0.0,) * 3,
                   g=0.0, a=1.0, b=1.0, updir=(0, 1, 0), density=None,
                   density_shape=None):
        """homogeneous | exponential | volumegrid (volumes/*.cpp).
        p0/p1: object-space AABB; v2w: volume-to-world transform."""
        kinds = {"homogeneous": 0, "exponential": 1, "volumegrid": 2}
        v2w = np.asarray(v2w, np.float32)
        p0 = np.asarray(p0, np.float64)
        p1 = np.asarray(p1, np.float64)
        # world AABB from the 8 transformed corners.
        corners = np.array([[p0[0] if i & 1 else p1[0],
                             p0[1] if i & 2 else p1[1],
                             p0[2] if i & 4 else p1[2]] for i in range(8)])
        wc = corners @ v2w[:3, :3].T + v2w[:3, 3]
        # w2v maps world -> unit box over [p0, p1].
        span = np.where(np.abs(p1 - p0) < 1e-12, 1.0, p1 - p0)
        to_unit = np.eye(4)
        to_unit[:3, :3] = np.diag(1.0 / span)
        to_unit[:3, 3] = -p0 / span
        w2v = (to_unit @ np.linalg.inv(v2w)).astype(np.float32)
        dens = None
        if density is not None:
            nx, ny, nz = density_shape
            dens = np.asarray(density, np.float32).reshape(nz, ny, nx)
        self.volumes.append(dict(
            kind=kinds[kind], w2v=w2v,
            v2w=np.linalg.inv(w2v).astype(np.float32),
            lo=wc.min(0).astype(np.float32), hi=wc.max(0).astype(np.float32),
            sigma_a=np.asarray(sigma_a, np.float32),
            sigma_s=np.asarray(sigma_s, np.float32),
            le=np.asarray(le, np.float32), g=float(g),
            params=np.asarray([a, b, 0, 0], np.float32),
            updir=np.asarray(updir, np.float32) /
            max(np.linalg.norm(updir), 1e-12),
            density=dens))
        return len(self.volumes) - 1

    # ---- camera ---------------------------------------------------------
    def set_camera(self, cam: D.CameraData):
        self.camera = cam

    # ---- build ----------------------------------------------------------
    def build(self) -> D.SceneData:
        # Quadrics.
        nq = len(self.quadrics)
        if nq:
            q = D.QuadricTable(
                kind=np.asarray([x.kind for x in self.quadrics], np.int32),
                o2w=np.asarray(np.stack([x.o2w for x in self.quadrics])),
                w2o=np.asarray(np.stack(
                    [np.linalg.inv(x.o2w).astype(np.float32)
                     for x in self.quadrics])),
                params=np.asarray(np.stack([x.params for x in self.quadrics])),
                material=np.asarray([x.material for x in self.quadrics], np.int32),
                area_light=np.asarray([x.area_light for x in self.quadrics], np.int32),
                flip_normal=np.asarray([x.flip for x in self.quadrics], np.float32),
                count=nq,
                kinds_present=tuple(sorted({x.kind for x in self.quadrics})),
                static_rows=tuple(_quadric_static_row(x.kind, x.params)
                                  for x in self.quadrics))
        else:
            z = np.zeros
            q = D.QuadricTable(kind=z((0,), np.int32), o2w=z((0, 4, 4)),
                               w2o=z((0, 4, 4)), params=z((0, 8)),
                               material=z((0,), np.int32),
                               area_light=z((0,), np.int32),
                               flip_normal=z((0,)), count=0,
                               kinds_present=(), static_rows=())

        # Triangles: concatenate meshes; record per-mesh triangle offsets.
        mesh_tri_offset = []
        verts_l, idx_l, n_l, uv_l, tan_l = [], [], [], [], []
        hasn_l, hast_l, mat_l, al_l, flip_l = [], [], [], [], []
        voff = 0
        toff = 0
        for m in self.meshes:
            mesh_tri_offset.append(toff)
            nt = len(m.idx)
            nv = len(m.verts)
            verts_l.append(m.verts)
            idx_l.append(m.idx + voff)
            n_l.append(m.normals if m.normals is not None
                       else np.zeros((nv, 3), np.float32))
            uv_l.append(m.uv if m.uv is not None
                        else np.zeros((nv, 2), np.float32))
            tan_l.append(m.tangents if m.tangents is not None
                         else np.zeros((nv, 3), np.float32))
            hasn_l.append(np.full(nt, m.normals is not None))
            hast_l.append(np.full(nt, m.tangents is not None))
            mat_l.append(np.full(nt, m.material, np.int32))
            al_l.append(np.full(nt, m.area_light, np.int32))
            flip_l.append(np.full(nt, m.flip, np.float32))
            voff += nv
            toff += nt
        nt_total = toff
        if nt_total:
            tri = D.TriangleTable(
                verts=np.asarray(np.concatenate(verts_l)),
                idx=np.asarray(np.concatenate(idx_l)),
                normals=np.asarray(np.concatenate(n_l)),
                uv=np.asarray(np.concatenate(uv_l)),
                tangents=np.asarray(np.concatenate(tan_l)),
                has_normals=np.asarray(np.concatenate(hasn_l)),
                has_tangents=np.asarray(np.concatenate(hast_l)),
                material=np.asarray(np.concatenate(mat_l)),
                area_light=np.asarray(np.concatenate(al_l)),
                flip_normal=np.asarray(np.concatenate(flip_l)),
                count=nt_total)
        else:
            z = np.zeros
            tri = D.TriangleTable(
                verts=z((1, 3)), idx=z((0, 3), np.int32), normals=z((1, 3)),
                uv=z((1, 2)), tangents=z((1, 3)),
                has_normals=z((0,), bool), has_tangents=z((0,), bool),
                material=z((0,), np.int32), area_light=z((0,), np.int32),
                flip_normal=z((0,)), count=0)

        # Materials (+ build-time lobe templates, materials/factory.py).
        from ..materials.factory import build_templates
        nm = max(1, len(self.materials))
        mats = self.materials or [(0, [self.constant_texture((0.5,) * 3),
                                       self.constant_texture(0.0)] + [-1] * 6, -1)]
        materials = D.MaterialTable(
            kind=np.asarray([m[0] for m in mats], np.int32),
            tex=np.asarray([m[1] for m in mats], np.int32),
            bump=np.asarray([m[2] for m in mats], np.int32),
            count=nm, has_bump=any(m[2] >= 0 for m in mats),
            **build_templates(mats))

        # Texture graph.
        if self.tex_nodes:
            textures = TexGraph(
                fparams=np.asarray(np.stack(self.tex_fparams)),
                w2t=np.asarray(np.stack(self.tex_w2t)),
                nodes=tuple(self.tex_nodes))
        else:
            from ..textures.graph import empty_graph
            textures = empty_graph()

        images = tuple(
            D.ImagePyramid(levels=tuple(np.asarray(l) for l in lv), wrap=w)
            for (lv, w) in self.images)

        # Lights: resolve mesh-range area lights, pack CDFs.
        nl = len(self.lights)
        cdf_flat: List[float] = []
        cdf_off = []
        max_cnt = 1
        for li_ in self.lights:
            cdf_off.append(len(cdf_flat))
            if li_.kind == D.LIGHT_AREA and li_.area_geom_kind == D.AREA_GEOM_TRIS:
                mesh_id = li_.area_first
                li_.area_first = mesh_tri_offset[mesh_id]
                areas = li_.tri_areas
                c = np.concatenate([[0.0], np.cumsum(areas)])
                c /= max(c[-1], 1e-12)
                cdf_flat.extend(c.tolist())
                max_cnt = max(max_cnt, li_.area_count)
            elif (li_.kind == D.LIGHT_AREA
                  and li_.area_geom_kind == D.AREA_GEOM_INST):
                # area_first: proto id -> first GLOBAL proto-tri id in the
                # instance table (concatenation order of build_instances).
                proto_tri_offset = np.concatenate(
                    [[0], np.cumsum([len(p["idx"]) for p in self.protos])])
                li_.area_first = int(proto_tri_offset[li_.area_first])
                c = np.concatenate([[0.0], np.cumsum(li_.tri_areas)])
                c /= max(c[-1], 1e-12)
                cdf_flat.extend(c.tolist())
                max_cnt = max(max_cnt, li_.area_count)
            else:
                cdf_flat.extend([0.0, 1.0])
        # Importance tables (infinitesample): third meta element is the
        # index into SceneData.env_importance, or -1 (cosine sampling).
        env_dists: List[D.EnvDist] = []
        inf_meta_rows = []
        for i, l in enumerate(self.lights):
            if l.kind != D.LIGHT_INFINITE:
                continue
            imp_idx = -1
            if l.importance:
                imp_idx = len(env_dists)
                env_dists.append(_build_env_dist(self.images[l.image][0][0]))
            inf_meta_rows.append((i, l.image, imp_idx))
        infinite_meta = tuple(inf_meta_rows)
        dir_map_meta = tuple(
            (i, l.image) for i, l in enumerate(self.lights)
            if l.kind in (D.LIGHT_PROJECTION, D.LIGHT_GONIOMETRIC)
            and l.image >= 0)
        if nl:
            lt_tab = D.LightTable(
                kind=np.asarray([l.kind for l in self.lights], np.int32),
                l2w=np.asarray(np.stack([l.l2w for l in self.lights])),
                w2l=np.asarray(np.stack(
                    [np.linalg.inv(l.l2w).astype(np.float32)
                     for l in self.lights])),
                spectrum=np.asarray(np.stack([l.spectrum for l in self.lights])),
                params=np.asarray(np.stack([l.params for l in self.lights])),
                nsamples=np.asarray([l.nsamples for l in self.lights], np.int32),
                image=np.asarray([l.image for l in self.lights], np.int32),
                area_geom_kind=np.asarray(
                    [l.area_geom_kind for l in self.lights], np.int32),
                area_first=np.asarray([l.area_first for l in self.lights], np.int32),
                area_count=np.asarray([l.area_count for l in self.lights], np.int32),
                area_total_area=np.asarray(
                    [l.area_total for l in self.lights], np.float32),
                cdf_offset=np.asarray(cdf_off, np.int32),
                area_cdf=np.asarray(cdf_flat, np.float32),
                count=nl, infinite_meta=infinite_meta,
                dir_map_meta=dir_map_meta, max_area_count=max_cnt,
                inst_area=any(
                    l.kind == D.LIGHT_AREA
                    and l.area_geom_kind == D.AREA_GEOM_INST
                    for l in self.lights),
                kinds_present=tuple(sorted({l.kind for l in self.lights})),
                kinds_list=tuple(int(l.kind) for l in self.lights))
        else:
            z = np.zeros
            lt_tab = D.LightTable(
                kind=z((0,), np.int32), l2w=z((0, 4, 4)), w2l=z((0, 4, 4)),
                spectrum=z((0, 3)), params=z((0, 8)),
                nsamples=z((0,), np.int32), image=z((0,), np.int32),
                area_geom_kind=z((0,), np.int32), area_first=z((0,), np.int32),
                area_count=z((0,), np.int32), area_total_area=z((0,)),
                cdf_offset=z((0,), np.int32), area_cdf=z((1,)),
                count=0, infinite_meta=(), dir_map_meta=(), max_area_count=1,
                kinds_present=(), kinds_list=())

        # World bound.
        los, his = [], []
        for qd in self.quadrics:
            r = float(np.abs(qd.params[:3]).max()) + 1e-3
            corners = np.array([[sx, sy, sz] for sx in (-r, r)
                                for sy in (-r, r) for sz in (-r, r)])
            wc = corners @ qd.o2w[:3, :3].T + qd.o2w[:3, 3]
            los.append(wc.min(0))
            his.append(wc.max(0))
        for m in self.meshes:
            los.append(m.verts.min(0))
            his.append(m.verts.max(0))
        if los:
            wlo = np.minimum.reduce(los).astype(np.float32)
            whi = np.maximum.reduce(his).astype(np.float32)
        else:
            wlo = np.full(3, -1.0, np.float32)
            whi = np.full(3, 1.0, np.float32)

        # Volumes.
        vols = None
        if self.volumes:
            nv_ = len(self.volumes)
            vv = self.volumes
            vols = D.VolumeTable(
                kind=np.asarray([v["kind"] for v in vv], np.int32),
                w2v=np.asarray(np.stack([v["w2v"] for v in vv])),
                v2w=np.asarray(np.stack([v["v2w"] for v in vv])),
                bound_lo=np.asarray(np.stack([v["lo"] for v in vv])),
                bound_hi=np.asarray(np.stack([v["hi"] for v in vv])),
                sigma_a=np.asarray(np.stack([v["sigma_a"] for v in vv])),
                sigma_s=np.asarray(np.stack([v["sigma_s"] for v in vv])),
                le=np.asarray(np.stack([v["le"] for v in vv])),
                g=np.asarray([v["g"] for v in vv], np.float32),
                params=np.asarray(np.stack([v["params"] for v in vv])),
                updir=np.asarray(np.stack([v["updir"] for v in vv])),
                density=tuple(np.asarray(v["density"])
                              if v["density"] is not None else None
                              for v in vv),
                count=nv_)
            for v in vv:
                wlo = np.minimum(wlo, v["lo"])
                whi = np.maximum(whi, v["hi"])

        # Ray-transform instances (accel/instances.py): prototype BLAS
        # tables + per-instance transforms, O(protos + instances) memory.
        inst_tab = None
        if self.instances:
            import dataclasses as _dc
            import jax as _jax
            from ..accel.instances import build_instances
            inst_tab = build_instances(self.protos, self.instances)
            tri_em = np.concatenate(
                [np.full(len(p["idx"]), p.get("area_L") is not None)
                 for p in self.protos])
            inst_tab = _dc.replace(
                inst_tab,
                tri_emissive=_jax.device_put(tri_em),
                inst_area_light=_jax.device_put(np.asarray(
                    self.instance_area_light, np.int32)))
            wlo = np.minimum(wlo, np.asarray(inst_tab.bounds_lo))
            whi = np.maximum(whi, np.asarray(inst_tab.bounds_hi))

        scene = D.SceneData(
            quadrics=q, triangles=tri, materials=materials, textures=textures,
            images=images, lights=lt_tab, volumes=vols, camera=self.camera,
            accel=None, instances=inst_tab,
            env_importance=tuple(env_dists),
            world_bound_lo=np.asarray(wlo), world_bound_hi=np.asarray(whi))

        # Accelerator: explicit request, or automatic for big scenes (the
        # reference defaults to kdtree for everything, api.cpp:495; brute
        # force beats traversal for tiny prim counts on a vector machine).
        nprims = nq + nt_total
        want = self.accel_kind in ("grid", "kdtree", "bvh") or \
            (self.accel_kind == "auto" and nprims > 64)
        if want and nprims > 0:
            import dataclasses
            if self.accel_kind == "kdtree":
                from ..accel.kdtree_build import build_kdtree
                kw = {k: v for k, v in self.accel_params.items()
                      if k in ("isect_cost", "trav_cost", "empty_bonus",
                               "max_prims", "max_depth")}
                scene = dataclasses.replace(scene,
                                            accel=build_kdtree(scene, **kw))
            elif self.accel_kind == "bvh" or (
                    self.accel_kind == "auto" and nprims > 4096):
                # Default for big scenes: the skip-link BVH reads one
                # packed row per node (accel/bvh_build.py) where
                # kd-restart pays O(depth) gathers per visited leaf.
                from ..accel.bvh_build import build_bvh
                scene = dataclasses.replace(scene, accel=build_bvh(scene))
            else:
                from ..accel.grid_build import build_grid
                scene = dataclasses.replace(scene, accel=build_grid(scene))

        # One device_put sweep over the finished pytree. All assembly above
        # is host numpy on purpose: each parse-time jnp *computation* costs
        # a tiny XLA compile (below the persistent cache's
        # min-compile-time threshold, so paid every run).
        # device_put compiles nothing, and eager (non-jit) consumers need
        # jnp leaves for tracer indexing inside lax loops.
        import jax
        scene = jax.tree_util.tree_map(
            lambda x: jax.device_put(np.ascontiguousarray(x))
            if isinstance(x, np.ndarray) else x, scene)
        return scene


def _build_env_dist(finest: "np.ndarray") -> "D.EnvDist":
    """Build the infinitesample importance tables from the finest mip level
    (/root/reference/lights/infinitesample.cpp:102-133): per-column (u = phi
    axis) conditional CDFs over rows (v = theta axis) of
    luminance * sin(pi*(v+.5)/nv), plus the marginal over columns. CDFs use
    the ComputeStep1dCDF convention (core/mc.cpp:31-53): steps of
    func[i]/(n*funcInt); Sample pdf = func[offset]/funcInt."""
    img = np.asarray(finest, np.float32)
    nv, nu = img.shape[0], img.shape[1]          # rows = t/theta, cols = s/phi
    yw = np.asarray([0.212671, 0.715160, 0.072169], np.float32)
    lum = img @ yw                               # [nv, nu]
    # Separable [1/4, 1/2, 1/4] blur (wrapping): the radiance lookup at a
    # sampled position bilinearly interpolates NEIGHBOR texels, so the
    # importance function must cover them too or boundary texels of bright
    # regions produce rare huge Li/pdf spikes. (The reference builds its
    # table from filtered corner lookups for the same reason,
    # infinitesample.cpp:107-113; this symmetric form covers both sides.)
    for ax in (0, 1):
        lum = 0.5 * lum + 0.25 * (np.roll(lum, 1, ax) + np.roll(lum, -1, ax))
    sin_t = np.sin(np.pi * (np.arange(nv) + 0.5) / nv).astype(np.float32)
    func_v = (lum * sin_t[:, None]).T.astype(np.float32)   # [nu, nv]
    func_v = np.maximum(func_v, 1e-9)            # avoid zero-integral columns

    def step_cdf(f):
        # f: [..., n] -> (cdf [..., n+1] normalized, funcInt [...])
        n = f.shape[-1]
        cdf = np.concatenate([np.zeros(f.shape[:-1] + (1,), np.float32),
                              np.cumsum(f / n, axis=-1)], -1)
        func_int = cdf[..., -1].copy()
        cdf /= np.maximum(func_int[..., None], 1e-20)
        return cdf.astype(np.float32), func_int.astype(np.float32)

    cdf_v, int_v = step_cdf(func_v)
    func_u = int_v.copy()                        # marginal = column integrals
    cdf_u, int_u = step_cdf(func_u)
    return D.EnvDist(func_u=func_u, cdf_u=cdf_u, int_u=int_u,
                     func_v=func_v, cdf_v=cdf_v, int_v=int_v,
                     nu=int(nu), nv=int(nv))

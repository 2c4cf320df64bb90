"""pbrt scene-description parser + API state machine.

Replacement for the flex/bison parser + api.cpp
(/root/reference/core/pbrtlex.l, core/pbrtparse.y, core/api.cpp). The
grammar's *behavior* is reimplemented in Python: a tokenizer (strings,
numbers, brackets, # comments, nested Include), typed ParamSets
("type name" [values], core/pbrtparse.y:120-132), and the stateful
scene-construction API — current transform + named coordinate systems
(api.cpp:113-118, 213-222), hierarchical graphics state via
AttributeBegin/End (api.cpp:274-304), object instancing (api.cpp:409-457,
realized by ray-transform instancing for mesh objects — shared prototype
BLAS + per-instance transforms, accel/instances.py; area-light objects
and quadrics fall back to duplication under the instance CTM), world block
construction (api.cpp:458-529). Defaults mirror api.cpp:64-72.

Output: (SceneData via SceneBuilder, RenderOptions).
"""
from __future__ import annotations

import math
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core import transform as tfm
from ..filters.filters import DEFAULT_WIDTHS
from ..materials.factory import MATERIAL_KINDS
from ..samplers.samplers import SamplerConfig
from ..textures.graph import TexNodeMeta
from .build import SceneBuilder
from . import data as D

_TOKEN_RE = re.compile(r'"([^"]*)"|\[|\]|([^\s"\[\]]+)')


def tokenize(text: str, basedir: str = "."):
    """Yields tokens; handles # comments and Include directives
    (core/pbrtlex.l:45-92 nested file stack)."""
    for raw_line in text.splitlines():
        line = raw_line.split("#", 1)[0]
        pos = 0
        toks = []
        for m in _TOKEN_RE.finditer(line):
            if m.group(1) is not None:
                toks.append(("str", m.group(1)))
            elif m.group(0) == "[":
                toks.append(("lb", "["))
            elif m.group(0) == "]":
                toks.append(("rb", "]"))
            else:
                toks.append(("id", m.group(2)))
        i = 0
        while i < len(toks):
            t = toks[i]
            if t == ("id", "Include") and i + 1 < len(toks):
                path = os.path.join(basedir, toks[i + 1][1])
                with open(path) as fh:
                    yield from tokenize(fh.read(), os.path.dirname(path))
                i += 2
                continue
            yield t
            i += 1


_NUM_RE = re.compile(r"^[-+0-9.eE]+$")


class _TokenStream:
    def __init__(self, toks):
        self.toks = list(toks)
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def done(self):
        return self.i >= len(self.toks)


def _parse_value_list(ts: _TokenStream):
    t = ts.peek()
    vals = []
    if t is None:
        return vals
    if t[0] == "lb":
        ts.next()
        while ts.peek() and ts.peek()[0] != "rb":
            k, v = ts.next()
            vals.append(v if k == "str" else _num(v))
        ts.next()  # ]
    else:
        k, v = ts.next()
        vals.append(v if k == "str" else _num(v))
    return vals


def _num(s):
    try:
        return int(s)
    except ValueError:
        return float(s)


def parse_params(ts: _TokenStream) -> Dict[str, Tuple[str, list]]:
    """Read '"type name" values' pairs until the next directive token."""
    params = {}
    while True:
        t = ts.peek()
        if t is None or t[0] != "str":
            break
        ts.next()
        decl = t[1].split()
        if len(decl) != 2:
            continue
        typ, name = decl
        vals = _parse_value_list(ts)
        params[name] = (typ, vals)
    return params


class ParamSet:
    """Typed lookup with defaults (core/paramset.h FindOne* semantics).

    Tracks which names were looked up so report_unused() can warn on
    typo'd scene parameters (core/paramset.cpp:242 ReportUnused, invoked
    by every Make* factory in core/dynload.cpp)."""

    def __init__(self, raw: Dict[str, Tuple[str, list]]):
        self.raw = raw
        self._looked = set()

    def report_unused(self, where: str):
        from ..utils import errors
        for name in self.raw:
            if name not in self._looked:
                errors.warning(f'parameter "{name}" not used', where)

    def find_one(self, name, default):
        self._looked.add(name)
        if name not in self.raw:
            return default
        vals = self.raw[name][1]
        v = vals[0] if vals else default
        if isinstance(default, bool):
            return v == "true" if isinstance(v, str) else bool(v)
        if isinstance(default, float):
            return float(v)
        if isinstance(default, int) and not isinstance(default, bool):
            return int(v)
        return v

    def find_spectrum(self, name, default):
        self._looked.add(name)
        if name not in self.raw:
            return np.asarray(default, np.float32)
        vals = self.raw[name][1]
        if len(vals) == 1:
            return np.full(3, float(vals[0]), np.float32)
        return np.asarray(vals[:3], np.float32)

    def find_point(self, name, default):
        self._looked.add(name)
        if name not in self.raw:
            return np.asarray(default, np.float32)
        return np.asarray(self.raw[name][1][:3], np.float32)

    def find_floats(self, name):
        self._looked.add(name)
        if name not in self.raw:
            return None
        return np.asarray(self.raw[name][1], np.float32)

    def find_ints(self, name):
        self._looked.add(name)
        if name not in self.raw:
            return None
        return np.asarray(self.raw[name][1], np.int32)

    def is_texture(self, name):
        self._looked.add(name)
        return name in self.raw and self.raw[name][0] == "texture"

    def texture_name(self, name):
        self._looked.add(name)
        return self.raw[name][1][0]


class _GraphicsState:
    def __init__(self):
        self.material_kind = "matte"
        self.material_params = ParamSet({})
        self.area_light: Optional[Tuple[str, ParamSet]] = None
        self.reverse_orientation = False
        self.material_id: Optional[int] = None


class PbrtParser:
    """The API state machine (core/api.cpp). Drives a SceneBuilder."""

    def __init__(self, basedir="."):
        self.basedir = basedir
        self.builder = SceneBuilder()
        self.ctm = np.eye(4, dtype=np.float32)
        self.ctm_stack: List[np.ndarray] = []
        self.gs = _GraphicsState()
        self.gs_stack: List[_GraphicsState] = []
        self.coord_systems: Dict[str, np.ndarray] = {}
        self.named_textures: Dict[str, int] = {}
        self.in_world = False
        # RenderOptions accumulation (defaults: core/api.cpp:64-72).
        self.camera_name = "perspective"
        self.camera_params = ParamSet({})
        self.camera_w2c = np.eye(4, dtype=np.float32)
        self.sampler_name = "bestcandidate"
        self.sampler_params = ParamSet({})
        self.film_params = ParamSet({})
        self.filter_name = "mitchell"
        self.filter_params = ParamSet({})
        self.integrator_name = "directlighting"
        self.integrator_params = ParamSet({})
        self.volume_integrator_name = "emission"
        self.volume_integrator_params = ParamSet({})
        self.accel_name = "kdtree"
        self.accel_params = ParamSet({})
        self.objects: Dict[str, list] = {}
        self.current_object: Optional[str] = None
        self._exr_cache: Dict[str, int] = {}
        # (object name, shape index) -> prototype id, so N instances of
        # one object share ONE prototype BLAS (O(proto + N) memory).
        self._proto_cache: Dict[Tuple[str, int], int] = {}

    # ------------------------------------------------------------------
    def parse_file(self, path: str):
        with open(path) as f:
            self.parse_string(f.read(), os.path.dirname(path) or ".")

    def parse_string(self, text: str, basedir: Optional[str] = None):
        if basedir:
            self.basedir = basedir
        ts = _TokenStream(tokenize(text, self.basedir))
        while not ts.done():
            kind, tok = ts.next()
            if kind != "id":
                continue
            self._directive(tok, ts)

    # ------------------------------------------------------------------
    def _directive(self, name: str, ts: _TokenStream):
        b = self.builder
        if name == "LookAt":
            v = [_num(ts.next()[1]) for _ in range(9)]
            w2c = np.linalg.inv(np.asarray(
                tfm.look_at(v[0:3], v[3:6], v[6:9]), np.float32))
            self.ctm = self.ctm @ w2c
        elif name == "Translate":
            v = [_num(ts.next()[1]) for _ in range(3)]
            self.ctm = self.ctm @ np.asarray(tfm.translate(v), np.float32)
        elif name == "Scale":
            v = [_num(ts.next()[1]) for _ in range(3)]
            self.ctm = self.ctm @ np.asarray(tfm.scale(*v), np.float32)
        elif name == "Rotate":
            v = [_num(ts.next()[1]) for _ in range(4)]
            self.ctm = self.ctm @ np.asarray(tfm.rotate(v[0], v[1:4]), np.float32)
        elif name == "Transform":
            v = _parse_value_list(ts)
            m = np.asarray([float(x) for x in v], np.float32).reshape(4, 4).T
            self.ctm = m
        elif name == "ConcatTransform":
            v = _parse_value_list(ts)
            m = np.asarray([float(x) for x in v], np.float32).reshape(4, 4).T
            self.ctm = self.ctm @ m
        elif name == "Identity":
            self.ctm = np.eye(4, dtype=np.float32)
        elif name == "CoordinateSystem":
            self.coord_systems[ts.next()[1]] = self.ctm.copy()
        elif name == "CoordSysTransform":
            nm = ts.next()[1]
            if nm in self.coord_systems:
                self.ctm = self.coord_systems[nm].copy()
        elif name == "ReverseOrientation":
            self.gs.reverse_orientation = not self.gs.reverse_orientation
        elif name == "AttributeBegin":
            self.gs_stack.append(self._copy_gs())
            self.ctm_stack.append(self.ctm.copy())
        elif name == "AttributeEnd":
            self.gs = self.gs_stack.pop()
            self.ctm = self.ctm_stack.pop()
        elif name == "TransformBegin":
            self.ctm_stack.append(self.ctm.copy())
        elif name == "TransformEnd":
            self.ctm = self.ctm_stack.pop()
        elif name == "WorldBegin":
            self.in_world = True
            self.coord_systems["world"] = np.eye(4, dtype=np.float32)
            self.ctm = np.eye(4, dtype=np.float32)
        elif name == "WorldEnd":
            self.in_world = False
        elif name == "Camera":
            self.camera_name = ts.next()[1]
            self.camera_params = ParamSet(parse_params(ts))
            self.camera_w2c = self.ctm.copy()
            self.coord_systems["camera"] = np.linalg.inv(self.ctm)
        elif name == "Sampler":
            self.sampler_name = ts.next()[1]
            self.sampler_params = ParamSet(parse_params(ts))
        elif name == "Film":
            ts.next()  # "image"
            self.film_params = ParamSet(parse_params(ts))
        elif name == "PixelFilter":
            self.filter_name = ts.next()[1]
            self.filter_params = ParamSet(parse_params(ts))
        elif name == "SurfaceIntegrator":
            self.integrator_name = ts.next()[1]
            self.integrator_params = ParamSet(parse_params(ts))
        elif name == "VolumeIntegrator":
            self.volume_integrator_name = ts.next()[1]
            self.volume_integrator_params = ParamSet(parse_params(ts))
        elif name == "Accelerator":
            self.accel_name = ts.next()[1]
            self.accel_params = ParamSet(parse_params(ts))
            self.builder.accel_kind = self.accel_name
            # kd-tree SAH knobs (accelerators/kdtree.cpp:489-498).
            for src, dst in (("intersectcost", "isect_cost"),
                             ("traversalcost", "trav_cost"),
                             ("emptybonus", "empty_bonus"),
                             ("maxprims", "max_prims"),
                             ("maxdepth", "max_depth")):
                v = self.accel_params.find_one(src, None)
                if v is not None:
                    self.builder.accel_params[dst] = (
                        int(v) if dst in ("max_prims", "max_depth")
                        else float(v))
        elif name == "SearchPath":
            _parse_value_list(ts)  # plugin paths are meaningless here
        elif name == "Material":
            self.gs.material_kind = ts.next()[1]
            self.gs.material_params = ParamSet(parse_params(ts))
            self.gs.material_id = None
        elif name == "Texture":
            tex_name = ts.next()[1]
            tex_type = ts.next()[1]   # "float" | "color"/"spectrum"
            tex_class = ts.next()[1]
            params = ParamSet(parse_params(ts))
            tid = self._make_texture(tex_class, tex_type, params)
            self.named_textures[tex_name] = tid
            params.report_unused(f'Texture "{tex_name}" ({tex_class})')
        elif name == "LightSource":
            light_name = ts.next()[1]
            params = ParamSet(parse_params(ts))
            self._make_light(light_name, params)
            params.report_unused(f'LightSource "{light_name}"')
        elif name == "AreaLightSource":
            al_name = ts.next()[1]
            self.gs.area_light = (al_name, ParamSet(parse_params(ts)))
        elif name == "Shape":
            shape_name = ts.next()[1]
            params = ParamSet(parse_params(ts))
            if self.current_object is not None:
                self.objects[self.current_object].append(
                    (shape_name, params, self.ctm.copy(), self._copy_gs()))
            else:
                self._make_shape(shape_name, params, self.ctm, self.gs)
                params.report_unused(f'Shape "{shape_name}"')
        elif name == "ObjectBegin":
            self.current_object = ts.next()[1]
            self.objects[self.current_object] = []
            self.ctm_stack.append(self.ctm.copy())
        elif name == "ObjectEnd":
            self.current_object = None
            self.ctm = self.ctm_stack.pop()
        elif name == "ObjectInstance":
            # Ray-transform instancing (core/primitive.cpp:66-85): mesh
            # shapes become a shared prototype + per-instance transform.
            # QUADRICS instead fold the instance transform into a new
            # analytic-quadric table row: that row (kind + 2 transforms +
            # 8 params) is the SAME O(1) storage as the reference's
            # InstancePrimitive{ptr, o2w, w2o}, so transform-folding IS
            # the memory-optimal instancing for analytic shapes — only
            # tessellated geometry gains from a shared BLAS. Area-light
            # objects also take the fold/duplicate path: each instance
            # of an emitter is semantically a DISTINCT light (its own
            # power, its own CDF entry), which is what per-instance rows
            # give directly.
            nm = ts.next()[1]
            for i, (sn, sp, sctm, sgs) in enumerate(self.objects.get(nm, [])):
                mesh_kinds = ("trianglemesh", "loopsubdiv", "nurbs",
                              "heightfield")
                # Emissive mesh objects instance too (AREA_GEOM_INST: each
                # placement becomes its own light sharing the prototype
                # geometry) when the instance transform is a similarity —
                # the shared object-space area CDF needs relative areas
                # preserved. Otherwise fold/duplicate.
                emissive_ok = False
                if sgs.area_light is not None and sn in mesh_kinds:
                    A = np.asarray(self.ctm, np.float32)[:3, :3]
                    s_lin = abs(float(np.linalg.det(A))) ** (1.0 / 3.0)
                    emissive_ok = bool(np.allclose(
                        A @ A.T, (s_lin * s_lin) * np.eye(3),
                        atol=1e-4 * max(s_lin * s_lin, 1.0)))
                if sn in mesh_kinds and (sgs.area_light is None or
                                         emissive_ok):
                    key = (nm, i)
                    pid = self._proto_cache.get(key)
                    if pid is None:
                        mat = self._gs_material(sgs)
                        if sn == "trianglemesh":
                            P = sp.find_floats("P")
                            idx = sp.find_ints("indices")
                            N = sp.find_floats("N")
                            uv = sp.find_floats("uv")
                            if uv is None:
                                uv = sp.find_floats("st")
                        else:
                            from .tessellate import tessellate
                            P, idx, N, uv = tessellate(sn, sp)
                        al_L = None
                        al_ns = 1
                        if sgs.area_light is not None:
                            _, ap = sgs.area_light
                            al_L = ap.find_spectrum("L", (1.0,) * 3)
                            al_ns = int(ap.find_one("nsamples", 1))
                        pid = self.builder.add_prototype(
                            idx, P, N=N, uv=uv, material=mat,
                            reverse_orientation=sgs.reverse_orientation,
                            o2w=sctm, area_light_L=al_L,
                            area_nsamples=al_ns)
                        self._proto_cache[key] = pid
                    self.builder.add_instance(pid, self.ctm)
                else:
                    self._make_shape(sn, sp, self.ctm @ sctm, sgs)
        elif name == "Volume":
            vol_name = ts.next()[1]
            params = ParamSet(parse_params(ts))
            self._make_volume(vol_name, params)
            params.report_unused(f'Volume "{vol_name}"')
        else:
            # Unknown directive: warn (the reference's parser errors on
            # unknown statements) and consume its params defensively.
            from ..utils import errors
            errors.warning(f'unknown directive "{name}" ignored')
            parse_params(ts)

    def _copy_gs(self):
        g = _GraphicsState()
        g.material_kind = self.gs.material_kind
        g.material_params = self.gs.material_params
        g.area_light = self.gs.area_light
        g.reverse_orientation = self.gs.reverse_orientation
        g.material_id = self.gs.material_id
        return g

    # ------------------------------------------------------------------
    def _resolve_texture(self, params: ParamSet, name: str, default,
                         is_float=False) -> int:
        """TextureParams::Get*Texture (core/paramset.h:162-215)."""
        if params.is_texture(name):
            return self.named_textures[params.texture_name(name)]
        if is_float:
            v = params.find_one(name, float(default))
            return self.builder.constant_texture(v)
        v = params.find_spectrum(name, default)
        return self.builder.constant_texture(v)

    def _make_material(self, kind: str, params: ParamSet) -> int:
        b = self.builder
        rt = self._resolve_texture
        # Every reference material accepts an optional float "bumpmap"
        # displacement texture (materials/*.cpp, core/material.cpp:29-71).
        bump = (self.named_textures[params.texture_name("bumpmap")]
                if params.is_texture("bumpmap") else -1)
        if kind == "matte":
            return b.add_material("matte", [
                rt(params, "Kd", (0.5,) * 3),
                rt(params, "sigma", 0.0, True)], bump=bump)
        if kind == "plastic":
            return b.add_material("plastic", [
                rt(params, "Kd", (0.25,) * 3), rt(params, "Ks", (0.25,) * 3),
                rt(params, "roughness", 0.1, True)], bump=bump)
        if kind == "glass":
            return b.add_material("glass", [
                rt(params, "Kr", (1.0,) * 3), rt(params, "Kt", (1.0,) * 3),
                rt(params, "index", 1.5, True)], bump=bump)
        if kind == "mirror":
            return b.add_material("mirror", [rt(params, "Kr", (0.9,) * 3)], bump=bump)
        if kind == "shinymetal":
            return b.add_material("shinymetal", [
                rt(params, "Ks", (1.0,) * 3), rt(params, "Kr", (1.0,) * 3),
                rt(params, "roughness", 0.1, True)], bump=bump)
        if kind == "substrate":
            return b.add_material("substrate", [
                rt(params, "Kd", (0.5,) * 3), rt(params, "Ks", (0.5,) * 3),
                rt(params, "uroughness", 0.1, True),
                rt(params, "vroughness", 0.1, True)], bump=bump)
        if kind == "translucent":
            return b.add_material("translucent", [
                rt(params, "Kd", (0.25,) * 3), rt(params, "Ks", (0.25,) * 3),
                rt(params, "roughness", 0.1, True),
                rt(params, "reflect", (0.5,) * 3),
                rt(params, "transmit", (0.5,) * 3)], bump=bump)
        if kind == "uber":
            return b.add_material("uber", [
                rt(params, "Kd", (0.25,) * 3), rt(params, "Ks", (0.25,) * 3),
                rt(params, "Kr", (0.0,) * 3),
                rt(params, "roughness", 0.1, True),
                rt(params, "opacity", (1.0,) * 3)], bump=bump)
        if kind in MATERIAL_KINDS:  # measured materials
            return b.add_material(kind, [], bump=bump)
        # Unknown material: plastic is the reference's fallback behavior
        # (dynload failure -> error; we warn + matte).
        return b.matte()

    def _gs_material(self, gs: _GraphicsState) -> int:
        if gs.material_id is None:
            gs.material_id = self._make_material(gs.material_kind,
                                                 gs.material_params)
        return gs.material_id

    # ------------------------------------------------------------------
    def _make_texture(self, tex_class: str, tex_type: str,
                      params: ParamSet) -> int:
        b = self.builder
        is_float = tex_type == "float"
        # 2D mapping params (core/texture.cpp:63-82 defaults).
        mapping = params.find_one("mapping", "uv")
        fp = np.zeros(16, np.float32)
        fp[8] = params.find_one("uscale", 1.0)
        fp[9] = params.find_one("vscale", 1.0)
        fp[10] = params.find_one("udelta", 0.0)
        fp[11] = params.find_one("vdelta", 0.0)
        if mapping == "planar":
            fp[0:3] = params.find_point("v1", (1, 0, 0))
            fp[3:6] = params.find_point("v2", (0, 1, 0))
            fp[6] = params.find_one("udelta", 0.0)
            fp[7] = params.find_one("vdelta", 0.0)
        w2t = np.linalg.inv(self.ctm).astype(np.float32)

        def child(name, default):
            if params.is_texture(name):
                return self.named_textures[params.texture_name(name)]
            if is_float:
                return b.constant_texture(params.find_one(name, float(default)))
            return b.constant_texture(params.find_spectrum(name, default))

        if tex_class == "constant":
            v = params.find_spectrum("value", (1.0,) * 3)
            return b.constant_texture(v)
        if tex_class == "scale":
            return b.add_texture(TexNodeMeta(
                kind="scale", children=(child("tex1", (1,) * 3),
                                        child("tex2", (1,) * 3))))
        if tex_class == "mix":
            return b.add_texture(TexNodeMeta(
                kind="mix", children=(child("tex1", (0,) * 3),
                                      child("tex2", (1,) * 3),
                                      child("amount", 0.5))))
        if tex_class == "bilerp":
            v = np.zeros(16, np.float32)
            v[0:3] = params.find_spectrum("v00", (0.0,) * 3)
            v[3:6] = params.find_spectrum("v01", (1.0,) * 3)
            v[6:9] = params.find_spectrum("v10", (0.0,) * 3)
            v[9:12] = params.find_spectrum("v11", (1.0,) * 3)
            return b.add_texture(TexNodeMeta(kind="bilerp", mapping=mapping),
                                 fparams=v)
        if tex_class == "uv":
            return b.add_texture(TexNodeMeta(kind="uv", mapping=mapping),
                                 fparams=fp)
        if tex_class == "checkerboard":
            dim = params.find_one("dimension", 2)
            aamode = params.find_one("aamode", "closedform")
            if dim == 3:
                return b.add_texture(TexNodeMeta(
                    kind="checkerboard3d",
                    children=(child("tex1", (1,) * 3), child("tex2", (0,) * 3))),
                    w2t=w2t)
            return b.add_texture(TexNodeMeta(
                kind="checkerboard2d", mapping=mapping, aamode=aamode,
                children=(child("tex1", (1,) * 3), child("tex2", (0,) * 3))),
                fparams=fp)
        if tex_class == "dots":
            return b.add_texture(TexNodeMeta(
                kind="dots", mapping=mapping,
                children=(child("inside", (1,) * 3), child("outside", (0,) * 3))),
                fparams=fp)
        if tex_class in ("fbm", "wrinkled"):
            v = np.zeros(16, np.float32)
            v[0] = params.find_one("octaves", 8)
            v[1] = params.find_one("roughness", 0.5)
            return b.add_texture(TexNodeMeta(kind=tex_class, mapping="3d"),
                                 fparams=v, w2t=w2t)
        if tex_class == "windy":
            return b.add_texture(TexNodeMeta(kind="windy", mapping="3d"),
                                 w2t=w2t)
        if tex_class == "marble":
            v = np.zeros(16, np.float32)
            v[0] = params.find_one("octaves", 8)
            v[1] = params.find_one("roughness", 0.5)
            v[2] = params.find_one("scale", 1.0)
            v[3] = params.find_one("variation", 0.2)
            return b.add_texture(TexNodeMeta(kind="marble", mapping="3d"),
                                 fparams=v, w2t=w2t)
        if tex_class == "imagemap":
            fname = params.find_one("filename", "")
            trilinear = params.find_one("trilinear", False)
            wrap_s = params.find_one("wrap", "repeat")
            wrap = {"repeat": 0, "black": 1, "clamp": 2}.get(wrap_s, 0)
            img_id = self._load_image(fname, wrap)
            return b.add_texture(TexNodeMeta(
                kind="imagemap", image=img_id, mapping=mapping,
                float_from_y=is_float, trilinear=bool(trilinear)),
                fparams=fp)
        # Unknown: constant gray.
        return b.constant_texture((0.5,) * 3)

    def _load_image(self, fname: str, wrap: int = 0) -> int:
        key = f"{fname}|{wrap}"
        if key in self._exr_cache:
            return self._exr_cache[key]
        from ..io.exr import read_exr
        from ..io.mipmap_build import build_pyramid
        path = os.path.join(self.basedir, fname)
        rgb, _ = read_exr(path)
        levels = build_pyramid(rgb)
        img_id = self.builder.add_image(levels, wrap)
        self._exr_cache[key] = img_id
        return img_id

    # ------------------------------------------------------------------
    def _make_light(self, kind: str, params: ParamSet):
        b = self.builder
        l2w = self.ctm
        scale_from_to = lambda: None
        if kind == "point":
            I = params.find_spectrum("I", (1.0,) * 3)
            frm = params.find_point("from", (0, 0, 0))
            l2w2 = l2w @ np.asarray(tfm.translate(frm), np.float32)
            b.add_point_light(l2w2, I)
        elif kind == "spot":
            I = params.find_spectrum("I", (1.0,) * 3)
            frm = params.find_point("from", (0, 0, 0))
            to = params.find_point("to", (0, 0, 1))
            dir_ = to - frm
            nrm = np.linalg.norm(dir_)
            dir_ = dir_ / max(nrm, 1e-12)
            _, du, dv = self._coord_sys(dir_)
            m = np.eye(4, dtype=np.float32)
            m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = du, dv, dir_, frm
            b.add_spot_light(l2w @ m, I,
                             params.find_one("coneangle", 30.0),
                             params.find_one("conedeltaangle", 5.0))
        elif kind == "distant":
            b.add_distant_light(l2w, params.find_spectrum("L", (1.0,) * 3),
                                params.find_point("from", (0, 0, 0)),
                                params.find_point("to", (0, 0, 1)))
        elif kind in ("infinite", "infinitesample"):
            L = params.find_spectrum("L", (1.0,) * 3)
            fname = params.find_one("mapname", "")
            img = self._load_image(fname) if fname else -1
            b.add_infinite_light(l2w, L, img,
                                 params.find_one("nsamples", 1),
                                 importance=(kind == "infinitesample"))
        elif kind == "projection":
            fname = params.find_one("mapname", "")
            img = self._load_image(fname) if fname else -1
            aspect = 1.0
            if img >= 0:
                lv = self.builder.images[img][0][0]
                aspect = lv.shape[1] / lv.shape[0]
            b.add_projection_light(l2w, params.find_spectrum("I", (1.0,) * 3),
                                   params.find_one("fov", 45.0), img, aspect)
        elif kind == "goniometric":
            fname = params.find_one("mapname", "")
            img = self._load_image(fname) if fname else -1
            b.add_goniometric_light(l2w, params.find_spectrum("I", (1.0,) * 3),
                                    img)

    @staticmethod
    def _coord_sys(v):
        import numpy as np
        if abs(v[0]) > abs(v[1]):
            inv = 1.0 / math.sqrt(v[0] ** 2 + v[2] ** 2)
            u = np.array([-v[2] * inv, 0, v[0] * inv])
        else:
            inv = 1.0 / math.sqrt(v[1] ** 2 + v[2] ** 2)
            u = np.array([0, v[2] * inv, -v[1] * inv])
        w = np.cross(v, u)
        return v, u, w

    # ------------------------------------------------------------------
    def _make_shape(self, kind: str, params: ParamSet, ctm, gs):
        b = self.builder
        mat = self._gs_material(gs)
        ro = gs.reverse_orientation
        area = -1

        def attach_area_quadric(qid):
            if gs.area_light is not None:
                _, ap = gs.area_light
                b.add_area_light_sphere(qid, ap.find_spectrum("L", (1.0,) * 3),
                                        ap.find_one("nsamples", 1))

        def attach_area_mesh(mid):
            if gs.area_light is not None:
                _, ap = gs.area_light
                b.add_area_light_mesh(mid, ap.find_spectrum("L", (1.0,) * 3),
                                      ap.find_one("nsamples", 1))

        if kind == "sphere":
            r = params.find_one("radius", 1.0)
            qid = b.add_sphere(ctm, r,
                               params.find_one("zmin", -r),
                               params.find_one("zmax", r),
                               params.find_one("phimax", 360.0),
                               mat, -1, ro)
            attach_area_quadric(qid)
        elif kind == "cylinder":
            qid = b.add_cylinder(ctm, params.find_one("radius", 1.0),
                                 params.find_one("zmin", -1.0),
                                 params.find_one("zmax", 1.0),
                                 params.find_one("phimax", 360.0), mat, -1, ro)
            attach_area_quadric(qid)
        elif kind == "disk":
            qid = b.add_disk(ctm, params.find_one("height", 0.0),
                             params.find_one("radius", 1.0),
                             params.find_one("innerradius", 0.0),
                             params.find_one("phimax", 360.0), mat, -1, ro)
            attach_area_quadric(qid)
        elif kind == "cone":
            qid = b.add_cone(ctm, params.find_one("radius", 1.0),
                             params.find_one("height", 1.0),
                             params.find_one("phimax", 360.0), mat, -1, ro)
        elif kind == "paraboloid":
            r = params.find_one("radius", 1.0)
            qid = b.add_paraboloid(ctm, r, params.find_one("zmin", 0.0),
                                   params.find_one("zmax", 1.0),
                                   params.find_one("phimax", 360.0),
                                   mat, -1, ro)
        elif kind == "hyperboloid":
            qid = b.add_hyperboloid(ctm, params.find_point("p1", (0, 0, 0)),
                                    params.find_point("p2", (1, 1, 1)),
                                    params.find_one("phimax", 360.0),
                                    mat, -1, ro)
        elif kind == "trianglemesh":
            P = params.find_floats("P")
            idx = params.find_ints("indices")
            N = params.find_floats("N")
            uv = params.find_floats("uv")
            if uv is None:
                uv = params.find_floats("st")
            S = params.find_floats("S")
            mid = b.add_trianglemesh(ctm, idx, P, N, uv, S, mat, -1, ro)
            attach_area_mesh(mid)
        elif kind in ("loopsubdiv", "nurbs", "heightfield"):
            from .tessellate import tessellate
            P, idx, N, uv = tessellate(kind, params)
            mid = b.add_trianglemesh(ctm, idx, P, N, uv, None, mat, -1, ro)
            attach_area_mesh(mid)

    def _make_volume(self, kind: str, params: ParamSet):
        """Volume statement -> VolumeTable row (volumes/*.cpp params)."""
        p0 = params.find_point("p0", (0, 0, 0))
        p1 = params.find_point("p1", (1, 1, 1))
        common = dict(
            v2w=self.ctm, p0=p0, p1=p1,
            sigma_a=params.find_spectrum("sigma_a", (1.0,) * 3),
            sigma_s=params.find_spectrum("sigma_s", (1.0,) * 3),
            le=params.find_spectrum("Le", (0.0,) * 3),
            g=params.find_one("g", 0.0))
        if kind == "homogeneous":
            self.builder.add_volume("homogeneous", **common)
        elif kind == "exponential":
            self.builder.add_volume(
                "exponential", a=params.find_one("a", 1.0),
                b=params.find_one("b", 1.0),
                updir=params.find_point("updir", (0, 1, 0)), **common)
        elif kind == "volumegrid":
            nx = params.find_one("nx", 1)
            ny = params.find_one("ny", 1)
            nz = params.find_one("nz", 1)
            dens = params.find_floats("density")
            self.builder.add_volume("volumegrid", density=dens,
                                    density_shape=(nx, ny, nz), **common)

    # ------------------------------------------------------------------
    def finish(self):
        """MakeScene (api.cpp:484-529): build camera + scene + options."""
        from ..cameras import cameras as cam
        from .. import render as R

        xres = self.film_params.find_one("xresolution", 640)
        yres = self.film_params.find_one("yresolution", 480)
        crop = self.film_params.find_floats("cropwindow")
        crop = tuple(crop) if crop is not None else (0.0, 1.0, 0.0, 1.0)
        filename = self.film_params.find_one("filename", "pbrt.exr")
        writefrequency = self.film_params.find_one("writefrequency", -1)
        # Consumed-but-unsupported film params (no gamma-correcting TIFF
        # path here; develop() always writes linear EXR).
        self.film_params.find_one("premultiplyalpha", True)

        c2w = np.linalg.inv(self.camera_w2c).astype(np.float32)
        p = self.camera_params
        hither = max(1e-4, p.find_one("hither", 1e-3))
        yon = min(p.find_one("yon", 1e30), 1e30)
        sopen = p.find_one("shutteropen", 0.0)
        sclose = p.find_one("shutterclose", 1.0)
        lensr = p.find_one("lensradius", 0.0)
        focal = p.find_one("focaldistance", 1e30)
        frameaspect = p.find_one("frameaspectratio",
                                 float(xres) / float(yres))
        screen = p.find_floats("screenwindow")
        if screen is None:
            screen = cam.default_screen_window(xres, yres, frameaspect)
        if self.camera_name == "perspective":
            fov = p.find_one("fov", 90.0)
            self.builder.set_camera(cam.build_projective(
                D.CAMERA_PERSPECTIVE, c2w,
                np.asarray(tfm.perspective(fov, hither, yon)), screen,
                xres, yres, hither, yon, sopen, sclose, lensr, focal))
        elif self.camera_name == "orthographic":
            self.builder.set_camera(cam.build_projective(
                D.CAMERA_ORTHOGRAPHIC, c2w,
                np.asarray(tfm.orthographic(hither, yon)), screen,
                xres, yres, hither, yon, sopen, sclose, lensr, focal))
        else:
            self.builder.set_camera(cam.build_environment(
                c2w, xres, yres, hither, yon, sopen, sclose))

        # Sampler.
        sp = self.sampler_params
        if self.sampler_name == "stratified":
            scfg = SamplerConfig(kind="stratified",
                                 xsamples=sp.find_one("xsamples", 2),
                                 ysamples=sp.find_one("ysamples", 2),
                                 jitter=sp.find_one("jitter", True))
        elif self.sampler_name == "random":
            scfg = SamplerConfig(kind="random",
                                 pixelsamples=sp.find_one("pixelsamples", 4))
        else:
            scfg = SamplerConfig(kind="lowdiscrepancy",
                                 pixelsamples=sp.find_one("pixelsamples", 4))

        fw = DEFAULT_WIDTHS.get(self.filter_name, (2.0, 2.0))
        integ = self.integrator_name
        integ_map = {"whitted": "whitted", "path": "path",
                     "directlighting": "directlighting", "debug": "debug",
                     "photonmap": "photonmap",
                     "exphotonmap": "exphotonmap",
                     "igi": "igi", "bidirectional": "bidirectional",
                     "irradiancecache": "irradiancecache"}
        irrad = ()
        if integ == "irradiancecache":
            # CreateSurfaceIntegrator params (irradiancecache.cpp:363-370).
            from ..integrators.irradiancecache import IrradParams
            ip = self.integrator_params
            irrad = IrradParams(
                maxerror=ip.find_one("maxerror", 0.2),
                maxspeculardepth=ip.find_one("maxspeculardepth", 5),
                maxindirectdepth=ip.find_one("maxindirectdepth", 3),
                nsamples=ip.find_one("nsamples", 4096))
        photon = ()
        igi_p = ()
        if integ == "igi":
            # CreateSurfaceIntegrator params (igi.cpp:288-295).
            from ..integrators.igi import IgiParams
            ip = self.integrator_params
            igi_p = IgiParams(
                nlights=ip.find_one("nlights", 64),
                nsets=ip.find_one("nsets", 4),
                mindist=ip.find_one("mindist", 0.1),
                rrthreshold=ip.find_one("rrthreshold", 0.05),
                indirectscale=ip.find_one("indirectscale", 1.0))
        if integ == "photonmap":
            # CreateSurfaceIntegrator params (photonmap.cpp:511-524).
            from ..integrators.photonmap import PhotonParams
            ip = self.integrator_params
            photon = PhotonParams(
                caustic=ip.find_one("causticphotons", 20000),
                direct=ip.find_one("directphotons", 100000),
                indirect=ip.find_one("indirectphotons", 100000),
                max_dist=ip.find_one("maxdist", 0.1),
                final_gather=bool(ip.find_one("finalgather", True)),
                gather_samples=ip.find_one("finalgathersamples", 32),
                direct_with_photons=bool(ip.find_one("directwithphotons",
                                                     False)))
        elif integ == "exphotonmap":
            # CreateSurfaceIntegrator params (exphotonmap.cpp:709-727).
            from ..integrators.exphotonmap import ExPhotonParams
            ip = self.integrator_params
            photon = ExPhotonParams(
                caustic=ip.find_one("causticphotons", 20000),
                indirect=ip.find_one("indirectphotons", 100000),
                direct=ip.find_one("directphotons", 100000),
                max_dist=ip.find_one("maxdist", 0.1),
                final_gather=bool(ip.find_one("finalgather", True)),
                gather_samples=ip.find_one("finalgathersamples", 32),
                gather_angle=ip.find_one("gatherangle", 10.0),
                max_specular_depth=ip.find_one("maxspeculardepth", 5))
        opts = R.RenderOptions(
            xres=xres, yres=yres, sampler=scfg,
            filter_kind=self.filter_name,
            filter_xwidth=self.filter_params.find_one("xwidth", fw[0]),
            filter_ywidth=self.filter_params.find_one("ywidth", fw[1]),
            integrator=integ_map.get(integ, "directlighting"),
            volume_integrator=("single" if self.volume_integrator_name ==
                               "single" else "emission"),
            max_depth=self.integrator_params.find_one("maxdepth", 5),
            filename=filename, writefrequency=writefrequency,
            crop=crop, photon=photon, igi=igi_p, irrad=irrad)
        for ps, where in ((self.camera_params,
                           f'Camera "{self.camera_name}"'),
                          (self.sampler_params,
                           f'Sampler "{self.sampler_name}"'),
                          (self.film_params, 'Film "image"'),
                          (self.filter_params,
                           f'PixelFilter "{self.filter_name}"'),
                          (self.integrator_params,
                           f'SurfaceIntegrator "{self.integrator_name}"'),
                          (self.accel_params,
                           f'Accelerator "{self.accel_name}"')):
            ps.report_unused(where)
        scene = self.builder.build()
        return scene, opts


def load_scene(path: str):
    p = PbrtParser(os.path.dirname(path) or ".")
    p.parse_file(path)
    return p.finish()


def load_scene_string(text: str, basedir: str = "."):
    p = PbrtParser(basedir)
    p.parse_string(text)
    return p.finish()

#!/usr/bin/env python
"""Generate the BASELINE.json parity scenes as .pbrt text.

One scene file per config, consumed byte-identically by BOTH renderers
(the reference binary and prt), so golden-image comparisons test the
renderer, not the scene encoding. Meshes are procedural (icosphere,
sine terrain) because no external assets ship with the repo.

Usage: python tools/make_scenes.py [outdir] [--big]
  --big also emits the ~100K-triangle bench variant of config 4.
"""
import os
import sys

import numpy as np


def icosphere(subdiv=3):
    """Unit icosphere: returns (verts f32[V,3], faces i32[F,3])."""
    t = (1.0 + 5 ** 0.5) / 2.0
    v = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
        np.int64)
    for _ in range(subdiv):
        cache = {}
        verts = list(v)

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = verts[a] + verts[b]
                m /= np.linalg.norm(m)
                cache[key] = len(verts)
                verts.append(m)
            return cache[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        v = np.asarray(verts)
        f = np.asarray(nf, np.int64)
    return v.astype(np.float32), f.astype(np.int32)


def terrain(n=101, amp=0.35):
    """Sine-bump terrain grid in [-1,1]^2: (verts, faces)."""
    xs = np.linspace(-1, 1, n, dtype=np.float32)
    X, Z = np.meshgrid(xs, xs)
    Y = amp * (np.sin(3.1 * X) * np.cos(2.7 * Z) +
               0.4 * np.sin(7.3 * X + 1.1) * np.sin(6.1 * Z))
    verts = np.stack([X, Y, Z], -1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(n * n).reshape(n, n)
    a = idx[:-1, :-1].ravel()
    b = idx[:-1, 1:].ravel()
    c = idx[1:, :-1].ravel()
    d = idx[1:, 1:].ravel()
    faces = np.concatenate(
        [np.stack([a, b, c], 1), np.stack([b, d, c], 1)]).astype(np.int32)
    return verts, faces


def mesh_stanza(verts, faces, extra=""):
    pts = " ".join(f"{x:.6g}" for x in verts.ravel())
    ids = " ".join(str(i) for i in faces.ravel())
    return (f'Shape "trianglemesh" "integer indices" [{ids}]\n'
            f'  "point P" [{pts}] {extra}\n')


CONFIG1 = """# BASELINE config 1: whitted sphere + point light
Film "image" "integer xresolution" [128] "integer yresolution" [128]
    "string filename" ["golden1.exr"]
LookAt 0 0 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [45]
Sampler "stratified" "integer xsamples" [2] "integer ysamples" [2]
PixelFilter "box" "float xwidth" [0.5] "float ywidth" [0.5]
SurfaceIntegrator "whitted"
WorldBegin
LightSource "point" "point from" [2 3 -3] "color I" [30 30 30]
Material "matte" "color Kd" [0.7 0.25 0.2]
Shape "sphere" "float radius" [1]
WorldEnd
"""


def config2():
    v, f = icosphere(3)   # 1280 tris
    return f"""# BASELINE config 2: grid-accelerated mesh, matte+plastic, area light
Film "image" "integer xresolution" [128] "integer yresolution" [128]
    "string filename" ["golden2.exr"]
LookAt 0 1.2 -3.5  0 0 0  0 1 0
Camera "perspective" "float fov" [50]
Sampler "lowdiscrepancy" "integer pixelsamples" [8]
PixelFilter "box" "float xwidth" [0.5] "float ywidth" [0.5]
SurfaceIntegrator "directlighting"
Accelerator "grid"
WorldBegin
AttributeBegin
  AreaLightSource "area" "color L" [14 14 14]
  Translate 0 2.4 0
  Rotate 90 1 0 0
  Shape "disk" "float radius" [0.7]
AttributeEnd
AttributeBegin
  Material "plastic" "color Kd" [0.2 0.3 0.65] "color Ks" [0.35 0.35 0.35]
      "float roughness" [0.08]
  {mesh_stanza(*icosphere(3))}
AttributeEnd
AttributeBegin
  Material "matte" "color Kd" [0.6 0.6 0.55]
  Translate 0 -1.02 0
  Scale 6 1 6
  {mesh_stanza(np.asarray([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]],
                          np.float32),
               np.asarray([[0, 1, 2], [0, 2, 3]], np.int32))}
AttributeEnd
WorldEnd
"""


CONFIG3 = """# BASELINE config 3: path-traced Cornell-style box, glass+mirror
Film "image" "integer xresolution" [96] "integer yresolution" [96]
    "string filename" ["golden3.exr"]
LookAt 0 0 -3.6  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
Sampler "lowdiscrepancy" "integer pixelsamples" [32]
PixelFilter "box" "float xwidth" [0.5] "float ywidth" [0.5]
SurfaceIntegrator "path" "integer maxdepth" [5]
WorldBegin
AttributeBegin
  AreaLightSource "area" "color L" [12 12 12]
  Translate 0 0.98 0
  Rotate 90 1 0 0
  Shape "disk" "float radius" [0.3]
AttributeEnd
Material "matte" "color Kd" [0.73 0.73 0.73]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-1 -1 -1  1 -1 -1  1 -1 1  -1 -1 1]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-1 1 -1  -1 1 1  1 1 1  1 1 -1]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-1 -1 1  1 -1 1  1 1 1  -1 1 1]
AttributeBegin
  Material "matte" "color Kd" [0.65 0.05 0.05]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-1 -1 -1  -1 -1 1  -1 1 1  -1 1 -1]
AttributeEnd
AttributeBegin
  Material "matte" "color Kd" [0.12 0.45 0.15]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [1 -1 -1  1 1 -1  1 1 1  1 -1 1]
AttributeEnd
AttributeBegin
  Material "glass"
  Translate -0.4 -0.6 0.2
  Shape "sphere" "float radius" [0.4]
AttributeEnd
AttributeBegin
  Material "mirror"
  Translate 0.45 -0.65 -0.1
  Shape "sphere" "float radius" [0.35]
AttributeEnd
WorldEnd
"""


def config4(n=101):
    v, f = terrain(n)
    return f"""# BASELINE config 4: kd-tree mesh + checkerboard + infinite light
Film "image" "integer xresolution" [128] "integer yresolution" [128]
    "string filename" ["golden4.exr"]
LookAt 0 1.1 -2.6  0 0 0  0 1 0
Camera "perspective" "float fov" [55]
Sampler "lowdiscrepancy" "integer pixelsamples" [4]
PixelFilter "box" "float xwidth" [0.5] "float ywidth" [0.5]
SurfaceIntegrator "directlighting"
Accelerator "kdtree"
WorldBegin
LightSource "infinite" "color L" [0.8 0.9 1.1]
LightSource "distant" "point from" [3 6 -4] "point to" [0 0 0]
    "color L" [2.2 2.1 1.9]
Texture "checks" "color" "checkerboard" "float uscale" [16]
    "float vscale" [16] "color tex1" [0.85 0.8 0.7] "color tex2" [0.22 0.3 0.2]
Material "matte" "texture Kd" "checks"
{mesh_stanza(v, f, extra=uv_stanza(n))}
WorldEnd
"""


def uv_stanza(n):
    us = np.linspace(0, 1, n, dtype=np.float32)
    U, V = np.meshgrid(us, us)
    uv = np.stack([U, V], -1).reshape(-1, 2)
    return '"float uv" [' + " ".join(f"{x:.6g}" for x in uv.ravel()) + "]"


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 and not sys.argv[1].startswith(
        "--") else "scenes"
    os.makedirs(outdir, exist_ok=True)
    open(os.path.join(outdir, "config1.pbrt"), "w").write(CONFIG1)
    open(os.path.join(outdir, "config2.pbrt"), "w").write(config2())
    open(os.path.join(outdir, "config3.pbrt"), "w").write(CONFIG3)
    open(os.path.join(outdir, "config4.pbrt"), "w").write(config4(101))
    # Perf-bench variant of config 3 at the resolution measured on the
    # reference (tools/build_reference.md): 256^2, 32 spp.
    bench3 = CONFIG3.replace("[96]", "[256]").replace("golden3", "bench3")
    open(os.path.join(outdir, "bench3.pbrt"), "w").write(bench3)
    if "--big" in sys.argv:
        # ~100K-triangle bench variant (config 4 shape at full scale).
        big = config4(224).replace("golden4.exr", "bench4.exr")
        big = big.replace('"integer xresolution" [128]',
                          '"integer xresolution" [512]')
        big = big.replace('"integer yresolution" [128]',
                          '"integer yresolution" [512]')
        open(os.path.join(outdir, "config4_big.pbrt"), "w").write(big)
    if "--huge" in sys.argv:
        # 1M-triangle scale workload (bench.py config5): plain matte (no
        # texture) so the stanza stays one mesh; written on demand only
        # (the text form is ~50 MB — used for reference cross-runs).
        v, f = terrain(708)
        huge = f"""# config5: 1M-tri terrain, directlighting
Film "image" "integer xresolution" [512] "integer yresolution" [512]
    "string filename" ["bench5.exr"]
LookAt 0 1.1 -2.6  0 0 0  0 1 0
Camera "perspective" "float fov" [55]
Sampler "lowdiscrepancy" "integer pixelsamples" [4]
PixelFilter "box" "float xwidth" [0.5] "float ywidth" [0.5]
SurfaceIntegrator "directlighting"
Accelerator "kdtree"
WorldBegin
LightSource "infinite" "color L" [0.8 0.9 1.1]
LightSource "distant" "point from" [3 6 -4] "point to" [0 0 0]
    "color L" [2.2 2.1 1.9]
Material "matte" "color Kd" [0.6 0.55 0.5]
{mesh_stanza(v, f)}
WorldEnd
"""
        open(os.path.join(outdir, "config5_huge.pbrt"), "w").write(huge)
    print(f"wrote scenes to {outdir}/")


if __name__ == "__main__":
    main()

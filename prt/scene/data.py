"""The compiled scene: frozen SoA array tables.

This is the replacement for the reference's object graph
(`Scene` owning `Primitive*`/`Light*`/`Material*` virtual hierarchies,
/root/reference/core/scene.h:31-59). Virtual dispatch becomes integer *kind*
tags into branchless kernels; per-object heap state becomes columns of flat
arrays. A `SceneData` is a pytree: donate it to jit, shard it, differentiate
through it.

Conventions:
  * every table is padded to its build-time length; count fields are static
    Python ints so shapes are known to XLA;
  * `-1` is the universal "no reference" id;
  * all geometry is stored in WORLD space (transforms were applied at build
    time except for quadrics, which keep object<->world matrices since their
    intersection math lives in object space, mirroring
    /root/reference/shapes/sphere.cpp:102-144).
"""
from __future__ import annotations

from typing import Any, Tuple

import jax.numpy as jnp

from ..core.pytree import pytree_dataclass, static

# --- kind tags ------------------------------------------------------------

QUADRIC_SPHERE = 0
QUADRIC_CYLINDER = 1
QUADRIC_DISK = 2
QUADRIC_CONE = 3
QUADRIC_PARABOLOID = 4
QUADRIC_HYPERBOLOID = 5

LIGHT_POINT = 0
LIGHT_SPOT = 1
LIGHT_DISTANT = 2
LIGHT_AREA = 3
LIGHT_INFINITE = 4
LIGHT_PROJECTION = 5
LIGHT_GONIOMETRIC = 6

CAMERA_PERSPECTIVE = 0
CAMERA_ORTHOGRAPHIC = 1
CAMERA_ENVIRONMENT = 2

# Area-light geometry reference kinds.
AREA_GEOM_QUADRIC = 0
AREA_GEOM_TRIS = 1
# Emitting geometry lives in the INSTANCE table (object space, shared
# across instances); the light's l2w IS the instance transform.
AREA_GEOM_INST = 2


@pytree_dataclass
class QuadricTable:
    """All quadric shapes in one table (sphere/cylinder/disk/cone/
    paraboloid/hyperboloid — /root/reference/shapes/*.cpp). ``params``
    packs per-kind scalars:
      sphere:      [radius, zmin, zmax, phimax_rad, thetamin, thetamax, 0, 0]
      cylinder:    [radius, zmin, zmax, phimax_rad, ...]
      disk:        [height, radius, inner_radius, phimax_rad, ...]
      cone:        [radius, height, phimax_rad, ...]
      paraboloid:  [radius, zmin, zmax, phimax_rad, ...]
      hyperboloid: [p1x,p1y,p1z,p2x,p2y,p2z, phimax_rad, zmax... packed 8]
    """
    kind: jnp.ndarray        # i32[Q]
    o2w: jnp.ndarray         # f32[Q,4,4]
    w2o: jnp.ndarray         # f32[Q,4,4]
    params: jnp.ndarray      # f32[Q,8]
    material: jnp.ndarray    # i32[Q]
    area_light: jnp.ndarray  # i32[Q], -1 if not emissive
    flip_normal: jnp.ndarray # f32[Q], +-1: reverseOrientation ^ swapsHandedness
    count: int = static(default=0)
    # Static set of quadric kinds present — kernels skip absent kinds.
    kinds_present: Tuple = static(default=())
    # Per-row build-time facts (kind, phi_full, z_full) driving the unrolled
    # small-scene brute-force path (accel/intersect.py): phi_full — phimax
    # covers the whole circle so the atan2 clip is skipped; z_full — the
    # z-range clips nothing. None = facts unavailable (fall back to the
    # batched [N,Q] kernel).
    static_rows: Tuple = static(default=None)


@pytree_dataclass
class TriangleTable:
    """All triangles (from meshes, subdivs, NURBS, heightfields — refined on
    the host exactly as the reference's Refine() chain does lazily,
    /root/reference/shapes/trianglemesh.cpp:189-197)."""
    verts: jnp.ndarray       # f32[V,3] world space
    idx: jnp.ndarray         # i32[T,3]
    normals: jnp.ndarray     # f32[V,3] shading normals (zeros if none)
    uv: jnp.ndarray          # f32[V,2]
    tangents: jnp.ndarray    # f32[V,3] shading tangents (zeros if none)
    has_normals: jnp.ndarray # bool[T]
    has_tangents: jnp.ndarray# bool[T]
    material: jnp.ndarray    # i32[T]
    area_light: jnp.ndarray  # i32[T]
    flip_normal: jnp.ndarray # f32[T]
    count: int = static(default=0)


@pytree_dataclass
class MaterialTable:
    """Material = kind tag + texture-slot references + precompiled lobe
    templates. Mirrors the parameter surface of
    /root/reference/materials/*.cpp. ``tex`` holds texture node ids per
    named slot (meaning depends on kind; see materials/factory.py).

    The lobe-template columns [M, L] encode, per material, how each BSDF
    lobe is assembled from the slot values — computed ONCE at scene build on
    the host so the shading wavefront only does gathers + a few selects
    (the traced-masked-write alternative costs ~500 graph ops per bounce).
    Op codes are defined in materials/factory.py."""
    kind: jnp.ndarray        # i32[M]
    tex: jnp.ndarray         # i32[M, 8] texture ids per slot, -1 = unset
    bump: jnp.ndarray        # i32[M] texture id or -1
    # Lobe templates [M, L]:
    t_kind: jnp.ndarray = None   # i32 BxDF kind (-1 = no lobe)
    t_flags: jnp.ndarray = None  # i32 BxDFType bits
    t_flip: jnp.ndarray = None   # bool BRDFToBTDF
    t_aux0: jnp.ndarray = None   # i32 fresnel kind / measured id
    t_aux1: jnp.ndarray = None   # i32 distribution kind
    t_rop: jnp.ndarray = None    # i32 R op code
    t_ra: jnp.ndarray = None     # i32 slot column a
    t_rb: jnp.ndarray = None     # i32 slot column b
    t_eop: jnp.ndarray = None    # i32 eta/k op code
    t_ea: jnp.ndarray = None     # i32 eta slot column
    t_pop: jnp.ndarray = None    # i32 p op code
    t_pa: jnp.ndarray = None     # i32 p slot column a
    t_pb: jnp.ndarray = None     # i32 p slot column b
    count: int = static(default=0)
    # Static sets of BxDF lobe kinds / distribution kinds present across all
    # materials — BSDF kernels skip absent formulas.
    lobe_kinds: Tuple = static(default=())
    dist_kinds: Tuple = static(default=())
    # True iff any material has a bump texture: gates the two extra texture
    # graph evaluations bump mapping needs (core/material.cpp:29-71).
    has_bump: bool = static(default=False)


# Texture graphs live in textures/graph.py (TexGraph): static node topology
# (kinds/children/mappings are scene structure, like a model architecture)
# plus device parameter arrays (differentiable constants, matrices).


@pytree_dataclass
class ImagePyramid:
    """One mip pyramid, stored as a tuple of f32[h,w,3] levels (static
    structure). Replaces MIPMap<Spectrum> (/root/reference/core/mipmap.h)."""
    levels: Tuple[jnp.ndarray, ...]
    wrap: int = static(default=0)  # 0 repeat, 1 black, 2 clamp


@pytree_dataclass
class LightTable:
    """All non-area analytic lights + area lights + env lights in one table
    (/root/reference/lights/*.cpp). ``params`` per kind:
      point:       spectrum=I
      spot:        spectrum=I, params=[cosTotalWidth, cosFalloffStart]
      distant:     spectrum=L, params stores world direction in [0:3]
      area:        spectrum=Lemit; geometry via area_* fields
      infinite:    spectrum=L scale; env image id in params[0] (as int), -1 none
      projection:  spectrum=I, params=[fov stuff]; image id
      goniometric: spectrum=I; image id
    """
    kind: jnp.ndarray        # i32[L]
    l2w: jnp.ndarray         # f32[L,4,4]
    w2l: jnp.ndarray         # f32[L,4,4]
    spectrum: jnp.ndarray    # f32[L,3]
    params: jnp.ndarray      # f32[L,8]
    nsamples: jnp.ndarray    # i32[L]
    image: jnp.ndarray       # i32[L] image id (env/projection/gonio) or -1
    # Area-light geometry: which prims emit this light.
    area_geom_kind: jnp.ndarray   # i32[L] AREA_GEOM_*
    area_first: jnp.ndarray       # i32[L] quadric id / first triangle id
    area_count: jnp.ndarray       # i32[L] number of triangles (1 for quadric)
    area_total_area: jnp.ndarray  # f32[L]
    # Flat per-light triangle-area CDF, ragged-packed: cdf_offset[l] indexes
    # into area_cdf; length area_count[l]+1. (ShapeSet area CDF,
    # /root/reference/core/shape.h:112-171.)
    cdf_offset: jnp.ndarray       # i32[L]
    area_cdf: jnp.ndarray         # f32[sum(counts+1)]
    count: int = static(default=0)
    # Static set of light kinds present — sampling skips absent kinds.
    kinds_present: Tuple = static(default=())
    # Static per-light kind roster (kinds_list[i] == kind of light i):
    # lets per-light unrolled estimators (directlighting "all", whitted)
    # specialize at trace time — a delta light needs no BSDF-strategy ray,
    # so its traversal is skipped entirely instead of masked.
    kinds_list: Tuple = static(default=())
    # Static roster of (light_id, image_id, importance: bool) for infinite
    # lights — image structure is static so env lookups unroll per light.
    infinite_meta: Tuple = static(default=())
    # Static roster of (light_id, image_id) for projection/goniometric maps.
    dir_map_meta: Tuple = static(default=())
    max_area_count: int = static(default=1)
    # Any AREA_GEOM_INST lights present (sampling adds the instance-table
    # branch only when true — trace-time static).
    inst_area: bool = static(default=False)
    # Importance tables for infinite lights (lights/infinitesample.cpp) are
    # attached per-scene in SceneData.env_importance.


@pytree_dataclass
class EnvDist:
    """Importance tables for one infinitesample env light
    (/root/reference/lights/infinitesample.cpp:32-138): a marginal CDF over
    image columns (u = phi axis) and per-column conditional CDFs over rows
    (v = theta axis), built from luminance * sin(theta). CDFs are the
    reference's ComputeStep1dCDF form: cdf[i+1]-cdf[i] = func[i]/(n*funcInt),
    sample pdf = func[offset]/funcInt."""
    func_u: jnp.ndarray   # f32[nu]
    cdf_u: jnp.ndarray    # f32[nu+1]
    int_u: jnp.ndarray    # f32[] funcInt of the marginal
    func_v: jnp.ndarray   # f32[nu, nv]
    cdf_v: jnp.ndarray    # f32[nu, nv+1]
    int_v: jnp.ndarray    # f32[nu]
    nu: int = static(default=1)
    nv: int = static(default=1)


@pytree_dataclass
class VolumeTable:
    """Volume regions (/root/reference/volumes/*.cpp). kinds:
    0 homogeneous, 1 exponential, 2 grid. Bounds in world space via w2v box
    [0,1]^3; sigma/emission constant or modulated by density."""
    kind: jnp.ndarray        # i32[R]
    w2v: jnp.ndarray         # f32[R,4,4]  world -> unit-box volume space
    v2w: jnp.ndarray         # f32[R,4,4]
    bound_lo: jnp.ndarray    # f32[R,3] world AABB
    bound_hi: jnp.ndarray    # f32[R,3]
    sigma_a: jnp.ndarray     # f32[R,3]
    sigma_s: jnp.ndarray     # f32[R,3]
    le: jnp.ndarray          # f32[R,3]
    g: jnp.ndarray           # f32[R]
    params: jnp.ndarray      # f32[R,4]  exponential: [a, b, upx.. packed]
    updir: jnp.ndarray       # f32[R,3]
    density: Any = None      # tuple of f32[nz,ny,nx] grids (static structure)
    count: int = static(default=0)


@pytree_dataclass
class CameraData:
    kind: int = static(default=CAMERA_PERSPECTIVE)
    cam2world: jnp.ndarray = None   # f32[4,4]
    world2cam: jnp.ndarray = None
    raster2cam: jnp.ndarray = None  # f32[4,4] (projective cameras)
    cam2screen: jnp.ndarray = None
    lens_radius: jnp.ndarray = None     # f32[]
    focal_distance: jnp.ndarray = None  # f32[]
    shutter_open: jnp.ndarray = None    # f32[]
    shutter_close: jnp.ndarray = None   # f32[]
    cliphither: float = static(default=1e-3)
    clipyon: float = static(default=1e30)


@pytree_dataclass
class GridAccel:
    """Uniform-grid accelerator arrays (built host-side with the reference's
    resolution heuristic, /root/reference/accelerators/grid.cpp:146-151).
    Primitive ids: quadric q -> q, triangle t -> NQ + t."""
    nvoxels: Tuple[int, int, int] = static(default=(1, 1, 1))
    bounds_lo: jnp.ndarray = None  # f32[3]
    bounds_hi: jnp.ndarray = None  # f32[3]
    width: jnp.ndarray = None      # f32[3] voxel width
    inv_width: jnp.ndarray = None  # f32[3]
    cell_start: jnp.ndarray = None # i32[nx*ny*nz+1] offsets into prim_ids
    prim_ids: jnp.ndarray = None   # i32[P] concatenated per-voxel prim lists
    max_per_voxel: int = static(default=0)


@pytree_dataclass
class KdTreeAccel:
    """SAH kd-tree accelerator as flat SoA node columns (built host-side by
    the native builder, prt/native/csrc/kdtree_build.cpp — the analogue
    of /root/reference/accelerators/kdtree.cpp:141-311). Traversal is the
    stackless kd-restart walk in accel/kdtree.py: per-lane stacks scatter
    poorly on a vector machine, so lanes re-descend from the root with an
    advancing [tmin, tmax] window instead (no divergence, pure gathers)."""
    bounds_lo: jnp.ndarray = None   # f32[3]
    bounds_hi: jnp.ndarray = None   # f32[3]
    node_flags: jnp.ndarray = None  # i32[NN]: 0/1/2 split axis, 3 leaf
    node_split: jnp.ndarray = None  # f32[NN]
    node_above: jnp.ndarray = None  # i32[NN]: above child / leaf prim offset
    node_nprims: jnp.ndarray = None # i32[NN]: leaf prim count
    prim_ids: jnp.ndarray = None    # i32[P]
    max_depth: int = static(default=1)       # deepest node (descend bound)
    max_leaf_prims: int = static(default=1)  # widest leaf (test-loop bound)


@pytree_dataclass
class BvhAccel:
    """Skip-link ("threaded") BVH in preorder: traversal is a stackless
    link-walk — next = hit ? node+1 : skip — reading ONE packed node row
    per visited node (built by accel/bvh_build.py; traversal accel/bvh.py,
    ops/bvh_walk.py). kd-restart (KdTreeAccel) re-descends from the root
    per leaf instead."""
    # Packed 96-float rows:
    #   [lo(3), hi(3), skip, nprims,
    #    interior: rank-indexed child preorder ids (cols 8..15) + the 3
    #              split-level axes (cols 16..18);
    #    leaf:     8 x 9 inlined triangle vertices (cols 8..79) + 8
    #              global prim ids (cols 80..87)]
    nodes: jnp.ndarray = None       # f32[NN, 96]
    prim_ids: jnp.ndarray = None    # i32[NN*K], -1 padded
    n_nodes: int = static(default=1)
    leaf_k: int = static(default=4)
    n_quadrics: int = static(default=0)
    # "auto": the platform's route (ops/bvh_walk.use_kernel); "jnp": the
    # reference walk on any platform. Static, so it keys compiled renders.
    traversal: str = static(default="auto")


@pytree_dataclass
class InstanceTable:
    """Ray-transform instancing (the reference's InstancePrimitive,
    /root/reference/core/primitive.cpp:66-85 + api.cpp ObjectInstance):
    prototype triangle geometry stored ONCE in object space with a
    per-prototype BLAS; instances carry only transforms. Memory is
    O(prototypes + instances) instead of the duplication path's product.
    Traversal (ops/bvh_walk.traverse_instanced) moves each ray into an
    instance's object space and walks that prototype's node range; hits
    come back as (world t, proto tri id, instance id)."""
    # Prototype geometry (OBJECT space), concatenated across prototypes.
    verts: jnp.ndarray        # f32[V,3]
    idx: jnp.ndarray          # i32[T,3]
    uv: jnp.ndarray           # f32[V,2]
    normals: jnp.ndarray      # f32[V,3] (zeros if none)
    has_normals: jnp.ndarray  # bool[T]
    material: jnp.ndarray     # i32[T]
    flip_normal: jnp.ndarray  # f32[T]
    # Concatenated per-prototype BLAS rows (bvh_build8 rows; leaf prim ids
    # are GLOBAL proto tri ids). Node/skip ids are proto-local.
    nodes: jnp.ndarray        # f32[NN, 96]
    # Instances.
    inst_o2w: jnp.ndarray     # f32[I,4,4]
    inst_w2o: jnp.ndarray     # f32[I,4,4]
    inst_bbox: jnp.ndarray    # f32[I,6] world bbox (lo3, hi3)
    inst_range: jnp.ndarray   # i32[I,2] (first row, node count) of its BLAS
    bounds_lo: jnp.ndarray = None   # f32[3] world bounds over instances
    bounds_hi: jnp.ndarray = None
    # Per-instance orientation sign: -1 when the instance o2w swaps
    # handedness (mirror transforms), folded into the hit normal so a
    # mirrored ObjectInstance matches the duplication path's flip
    # (ADVICE r4; reference folds it via ctm @ sctm at shape build).
    inst_sign: jnp.ndarray = None   # f32[I]
    # Instanced area emitters (AREA_GEOM_INST lights): proto tris that
    # belong to an emissive shape, and each instance's light id (-1 =
    # not an emitter). Geometry stays O(proto); each instance adds one
    # LightTable row + one CDF segment.
    tri_emissive: jnp.ndarray = None   # bool[T]
    inst_area_light: jnp.ndarray = None  # i32[I]
    count: int = static(default=0)        # instances
    n_tris: int = static(default=0)       # total prototype triangles
    leaf_k: int = static(default=8)


@pytree_dataclass
class SceneData:
    quadrics: QuadricTable = None
    triangles: TriangleTable = None
    materials: MaterialTable = None
    textures: Any = None            # textures.graph.TexGraph
    images: Tuple[ImagePyramid, ...] = ()
    lights: LightTable = None
    volumes: VolumeTable = None
    camera: CameraData = None
    accel: Any = None               # GridAccel | None (brute force)
    instances: InstanceTable = None  # ray-transform instancing, or None
    # Env-light importance tables (infinitesample): per env image id.
    env_importance: Any = None
    world_bound_lo: jnp.ndarray = None  # f32[3]
    world_bound_hi: jnp.ndarray = None


def num_prims(scene: SceneData) -> int:
    return scene.quadrics.count + scene.triangles.count

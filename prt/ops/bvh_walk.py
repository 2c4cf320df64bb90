"""Per-ray skip-link walk of the wide BVH: a GPU kernel and its jnp twin.

The node rows (accel/bvh_build.py) are in preorder with skip links: a ray
at node n tests n's box and moves to n+1 when it enters an interior box,
else to skip(n). The cursor only ever increases, and skip links are
relative to a tree's first row, so an instanced prototype is walked as
the range [base, base + nn) of the concatenated table.

Row layout (f32[NN, 96]): lo(3) hi(3) skip nprims | leaf: LEAF_K x 9
inlined triangle vertices from col 8, LEAF_K prim ids from col 80.

`walk` holds the loop once and reads rows through a `rows(node)` callback:

  * the kernel (`traverse`, `traverse_instanced`) runs it for BLOCK rays in
    one Pallas program (Triton route). Each lane loads the bbox, skip and
    nprims of its own node per visit, and the triangle columns only on leaf
    lanes (masked loads). The node table stays in device memory and is
    served from L2. A block ends when its own rays end;
  * the jnp reference (`walk_rays`, `walk_instanced`) runs it over the
    whole batch, one [N, 96] row gather per step, and every lane waits for
    the slowest.

The same arithmetic in the same order runs in both, so they find the same
hits and prim ids, and t to rounding (compilers may contract a multiply
and an add differently).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_BIG = 1e30
TRI_COL = 8       # first inlined triangle column of a leaf row
PID_COL = 80      # first leaf prim-id column
# Rays per kernel program, one ray per thread. On an H100 64 rays in 2
# warps beat 128/4 and 256/8 on config4_big and config5_huge (CHANGES.md).
BLOCK = 64
NUM_WARPS = 2


def use_kernel(traversal: str = "auto") -> bool:
    """The traversal route: the kernel on a GPU, the jnp walk on the CPU
    or when a table asks for the reference walk (traversal="jnp")."""
    if traversal == "jnp":
        return False
    backend = jax.default_backend()
    if backend == "gpu":
        return True
    if backend == "cpu":
        return False
    raise RuntimeError(f"no BVH traversal for platform {backend!r}")


def _safe_inv(v):
    tiny = jnp.where(v < 0, -1e-12, 1e-12)
    return 1.0 / jnp.where(jnp.abs(v) < 1e-12, tiny, v)


def _box_window(lo, hi, o, inv, mint, tmax):
    """Slab test: (t0, t1) of the ray's window inside [lo, hi]."""
    t0, t1 = mint, tmax
    for a in range(3):
        ta = (lo[a] - o[a]) * inv[a]
        tb = (hi[a] - o[a]) * inv[a]
        t0 = jnp.maximum(jnp.minimum(ta, tb), t0)
        t1 = jnp.minimum(jnp.maximum(ta, tb), t1)
    return t0, t1


def _moller_trumbore(p, o, d, mint, maxt):
    """(t, valid) of the triangle p = 9 vertex components."""
    p0x, p0y, p0z, p1x, p1y, p1z, p2x, p2y, p2z = p
    ox, oy, oz = o
    dx, dy, dz = d
    e1x, e1y, e1z = p1x - p0x, p1y - p0y, p1z - p0z
    e2x, e2y, e2z = p2x - p0x, p2y - p0y, p2z - p0z
    s1x = dy * e2z - dz * e2y
    s1y = dz * e2x - dx * e2z
    s1z = dx * e2y - dy * e2x
    div = s1x * e1x + s1y * e1y + s1z * e1z
    ok = jnp.abs(div) > 1e-12
    inv = 1.0 / jnp.where(ok, div, 1.0)
    sx, sy, sz = ox - p0x, oy - p0y, oz - p0z
    b1 = (sx * s1x + sy * s1y + sz * s1z) * inv
    s2x = sy * e1z - sz * e1y
    s2y = sz * e1x - sx * e1z
    s2z = sx * e1y - sy * e1x
    b2 = (dx * s2x + dy * s2y + dz * s2z) * inv
    t = (e2x * s2x + e2y * s2y + e2z * s2z) * inv
    valid = ok & (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0) & \
        (t > mint) & (t < maxt)
    return t, valid


def walk(rows, o, d, mint, maxt, best_t, best_id, active, *, stop,
         leaf_k: int, any_hit: bool, leaf_test=None):
    """Skip-link walk of preorder nodes [0, stop) for every lane.

    rows(node) -> get(col, mask=None): the columns of each lane's row.
    leaf_test(pid, in_leaf, tmax) -> (t, valid) replaces the inlined
    triangle test (trees holding quadrics). Returns (best_t, best_id)."""
    inv = tuple(_safe_inv(c) for c in d)

    def cond(c):
        return jnp.max(c[3].astype(jnp.int32)) > 0

    def body(c):
        node, bt, bi, act = c
        get = rows(jnp.minimum(node, stop - 1))
        lo = (get(0), get(1), get(2))
        hi = (get(3), get(4), get(5))
        skip = get(6).astype(jnp.int32)
        nprims = get(7).astype(jnp.int32)
        t0, t1 = _box_window(lo, hi, o, inv, mint,
                             jnp.minimum(maxt, bt) * (1.0 + 1e-6))
        hit_box = (t0 <= t1) & act
        leaf = hit_box & (nprims > 0)
        for j in range(leaf_k):
            in_leaf = leaf & (j < nprims)
            pid = get(PID_COL + j, in_leaf).astype(jnp.int32)
            tmax = jnp.minimum(maxt, bt)
            if leaf_test is None:
                base = TRI_COL + 9 * j
                p = tuple(get(base + k, in_leaf) for k in range(9))
                t, valid = _moller_trumbore(p, o, d, mint, tmax)
            else:
                t, valid = leaf_test(pid, in_leaf, tmax)
            upd = valid & in_leaf & (t < bt)
            bt = jnp.where(upd, t, bt)
            bi = jnp.where(upd, pid, bi)
        node = jnp.where(hit_box & (nprims == 0), node + 1, skip)
        act = act & (node < stop)
        if any_hit:
            act = act & (bi < 0)
        return node, bt, bi, act

    node0 = jnp.zeros(best_id.shape, jnp.int32)
    _, best_t, best_id, _ = jax.lax.while_loop(
        cond, body, (node0, best_t, best_id, active))
    return best_t, best_id


def _walk_entries(entry, rows_at, o, d, mint, maxt, best_t, best_id,
                  best_inst, *, n_entries: int, leaf_k: int, any_hit: bool):
    """Instanced walk: for each entry (one instance of one prototype), the
    rays that enter its world bbox are moved into object space by its w2o
    and walk the prototype's node range. The direction is not
    renormalised, so t stays the world-space parameter and hits of all
    entries compare directly. entry(e) -> (lo3, hi3, inst, base, nn, m12)
    scalars; rows_at(base) -> a `rows` callback for walk."""
    inv_w = tuple(_safe_inv(c) for c in d)

    def step(e, c):
        bt, bi, b_inst = c
        lo, hi, inst, base, nn, m = entry(e)
        t0, t1 = _box_window(lo, hi, o, inv_w, mint,
                             jnp.minimum(maxt, bt) * (1.0 + 1e-6))
        enter = (t0 <= t1) & (mint <= maxt)
        if any_hit:
            enter = enter & (bi < 0)
        oo = tuple(m[4 * r] * o[0] + m[4 * r + 1] * o[1] +
                   m[4 * r + 2] * o[2] + m[4 * r + 3] for r in range(3))
        od = tuple(m[4 * r] * d[0] + m[4 * r + 1] * d[1] +
                   m[4 * r + 2] * d[2] for r in range(3))
        nt, ni = walk(rows_at(base), oo, od, mint, maxt, bt, bi, enter,
                      stop=nn, leaf_k=leaf_k, any_hit=any_hit)
        b_inst = jnp.where(nt < bt, inst, b_inst)
        return nt, ni, b_inst

    return jax.lax.fori_loop(0, n_entries, step,
                             (best_t, best_id, best_inst))


# --- jnp reference -------------------------------------------------------

def _jnp_rows(nodes, base=0):
    def rows(node):
        r = nodes[base + node]                      # [N, 96]
        return lambda col, mask=None: r[:, col]
    return rows


def walk_rays(nodes, o, d, mint, maxt, *, nn: int, leaf_k: int,
              any_hit: bool = False, leaf_test=None):
    """jnp walk of rays o, d f32[N,3] -> (t f32[N], prim id i32[N])."""
    n = o.shape[0]
    return walk(_jnp_rows(nodes), tuple(o.T), tuple(d.T), mint, maxt,
                jnp.full((n,), _BIG, jnp.float32),
                jnp.full((n,), -1, jnp.int32), mint <= maxt,
                stop=nn, leaf_k=leaf_k, any_hit=any_hit, leaf_test=leaf_test)


def _entry_arrays(bbox, ranges, w2o16):
    def entry(e):
        return (tuple(bbox[e, k] for k in range(3)),
                tuple(bbox[e, 3 + k] for k in range(3)),
                e, ranges[e, 0], ranges[e, 1],
                tuple(w2o16[e, k] for k in range(12)))
    return entry


def walk_instanced(nodes, bbox, ranges, w2o16, o, d, mint, maxt, *,
                   leaf_k: int, any_hit: bool = False):
    """jnp instanced walk -> (t, proto tri id, instance id), -1 on miss."""
    n = o.shape[0]
    return _walk_entries(
        _entry_arrays(bbox, ranges, w2o16),
        lambda base: _jnp_rows(nodes, base), tuple(o.T), tuple(d.T), mint,
        maxt, jnp.full((n,), _BIG, jnp.float32),
        jnp.full((n,), -1, jnp.int32), jnp.full((n,), -1, jnp.int32),
        n_entries=bbox.shape[0], leaf_k=leaf_k, any_hit=any_hit)


# --- kernel --------------------------------------------------------------

def _ref_rows(nodes_ref, base=0):
    from jax.experimental.pallas import triton as plgpu

    def rows(node):
        row = base + node

        def get(col, mask=None):
            if mask is None:
                return nodes_ref[row, col]
            return plgpu.load(nodes_ref.at[row, col], mask=mask, other=0.0)
        return get
    return rows


def _ray_block(rays_ref):
    o = tuple(rays_ref[k, :] for k in range(3))
    d = tuple(rays_ref[3 + k, :] for k in range(3))
    return o, d, rays_ref[6, :], rays_ref[7, :]


def _pack_rays(o, d, mint, maxt):
    """f32[8, Np] ray block, Np a BLOCK multiple; padding rays carry an
    empty window (mint 1 > maxt -1) and stay inactive."""
    n = o.shape[0]
    rays = jnp.concatenate([o.T, d.T, mint[None], maxt[None]], axis=0)
    np_ = -(-max(n, 1) // BLOCK) * BLOCK
    if np_ != n:
        pad = jnp.zeros((8, np_ - n), jnp.float32).at[6].set(1.0).at[7] \
            .set(-1.0)
        rays = jnp.concatenate([rays, pad], axis=1)
    return rays


def _whole(a):
    """The whole array as one block (read by gathers, never copied)."""
    from jax.experimental import pallas as pl
    return pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)


def _call(kernel, n_out_i32, np_, in_specs, interpret, name):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu
    out = [jax.ShapeDtypeStruct((np_,), jnp.float32)] + \
        [jax.ShapeDtypeStruct((np_,), jnp.int32)] * n_out_i32
    return pl.pallas_call(
        kernel, out_shape=out, grid=(np_ // BLOCK,),
        in_specs=in_specs,
        out_specs=[pl.BlockSpec((BLOCK,), lambda i: (i,))] * len(out),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret, name=name)


@functools.partial(jax.jit, static_argnames=("nn", "leaf_k", "any_hit",
                                             "interpret"))
def traverse(nodes, o, d, mint, maxt, *, nn: int, leaf_k: int,
             any_hit: bool = False, interpret: bool = False):
    """Kernel walk of rays o, d f32[N,3] -> (t f32[N], prim id i32[N])."""
    from jax.experimental import pallas as pl
    n = o.shape[0]
    rays = _pack_rays(o, d, mint, maxt)

    def kernel(nodes_ref, rays_ref, t_ref, id_ref):
        o_, d_, mint_, maxt_ = _ray_block(rays_ref)
        t, ids = walk(_ref_rows(nodes_ref), o_, d_, mint_, maxt_,
                      jnp.full((BLOCK,), _BIG, jnp.float32),
                      jnp.full((BLOCK,), -1, jnp.int32), mint_ <= maxt_,
                      stop=nn, leaf_k=leaf_k, any_hit=any_hit)
        t_ref[...] = t
        id_ref[...] = ids

    t, ids = _call(kernel, 1, rays.shape[1],
                   [_whole(nodes), pl.BlockSpec((8, BLOCK), lambda i: (0, i))],
                   interpret, "bvh_walk")(nodes, rays)
    return t[:n], ids[:n]


@functools.partial(jax.jit, static_argnames=("leaf_k", "any_hit",
                                             "interpret"))
def traverse_instanced(nodes, bbox, ranges, w2o16, o, d, mint, maxt, *,
                       leaf_k: int, any_hit: bool = False,
                       interpret: bool = False):
    """Kernel instanced walk -> (t, proto tri id, instance id)."""
    from jax.experimental import pallas as pl
    n = o.shape[0]
    n_entries = bbox.shape[0]
    rays = _pack_rays(o, d, mint, maxt)

    def kernel(bbox_ref, ranges_ref, w2o_ref, nodes_ref, rays_ref, t_ref,
               id_ref, inst_ref):
        o_, d_, mint_, maxt_ = _ray_block(rays_ref)

        def entry(e):
            return (tuple(bbox_ref[e, k] for k in range(3)),
                    tuple(bbox_ref[e, 3 + k] for k in range(3)),
                    e, ranges_ref[e, 0], ranges_ref[e, 1],
                    tuple(w2o_ref[e, k] for k in range(12)))

        t, ids, inst = _walk_entries(
            entry, lambda base: _ref_rows(nodes_ref, base), o_, d_, mint_,
            maxt_, jnp.full((BLOCK,), _BIG, jnp.float32),
            jnp.full((BLOCK,), -1, jnp.int32),
            jnp.full((BLOCK,), -1, jnp.int32),
            n_entries=n_entries, leaf_k=leaf_k, any_hit=any_hit)
        t_ref[...] = t
        id_ref[...] = ids
        inst_ref[...] = inst

    t, ids, inst = _call(
        kernel, 2, rays.shape[1],
        [_whole(bbox), _whole(ranges), _whole(w2o16), _whole(nodes),
         pl.BlockSpec((8, BLOCK), lambda i: (0, i))],
        interpret, "bvh_walk_instanced")(bbox, ranges, w2o16, nodes, rays)
    return t[:n], ids[:n], inst[:n]

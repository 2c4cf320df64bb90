"""Grid-hash photon storage + fixed-radius density-estimation lookup.

Replacement for the pointer-chasing generic KdTree the reference
uses for photon maps (/root/reference/core/kdtree.h:48-171 +
integrators/photonmap.cpp:433-483). Photons are bucketed by hashed grid
cell (cell size = lookup radius) and sorted by bucket, so a lookup scans
the 27 neighbor cells with bounded, maskable loops — no recursion, no
stacks, fully vectorized over the query wavefront.

Divergence from the reference (documented): the reference keeps the
nLookup-NEAREST photons with a shrinking max-heap radius; we use
FIXED-RADIUS density estimation (all photons within maxDist, capped per
bucket) — the classic alternative estimator, consistent as photon count
grows, and vastly better suited to a vector machine than per-lane heaps.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import jax.numpy as jnp

from ..core.pytree import pytree_dataclass, static

_HX, _HY, _HZ = 73856093, 19349663, 83492791


@pytree_dataclass
class PhotonGrid:
    """One photon map. Photon arrays are sorted by hash bucket."""
    p: jnp.ndarray        # f32[N,3] position
    wi: jnp.ndarray       # f32[N,3] arrival direction (toward the light)
    alpha: jnp.ndarray    # f32[N,3] power carried
    packed: jnp.ndarray   # f32[N,12] [p, wi, alpha, pad] — the lookup
                          # loop fetches ONE contiguous row per photon
                          # instead of three scattered 12-byte gathers
    start: jnp.ndarray    # i32[M+1] bucket start offsets into the arrays
    n_paths: jnp.ndarray  # f32[] paths shot to fill this map (normalizer)
    radius: float = static(default=0.1)
    n_buckets: int = static(default=1)      # M (power of two)
    bucket_cap: int = static(default=8)     # static per-bucket scan bound
    count: int = static(default=0)


def _cell_hash(ix, iy, iz, m):
    h = (ix * _HX) ^ (iy * _HY) ^ (iz * _HZ)
    return h & (m - 1)


def build_photon_grid(p: np.ndarray, wi: np.ndarray, alpha: np.ndarray,
                      radius: float, n_paths: float,
                      max_bucket_cap: int = 32) -> PhotonGrid:
    """Host-side build: hash to buckets, sort, record starts.

    max_bucket_cap bounds the lookup loop's per-bucket scan; buckets over
    it keep an RR-scaled random subset (unbiased). 32 (was 64 in r4) cuts
    the density-estimation sweep 2x at photon-map-typical radii where
    dense cells hold tens of photons; the estimate stays unbiased with
    mildly higher variance exactly where photon density (and thus
    relative accuracy) is highest."""
    n = p.shape[0]
    if n == 0:
        return PhotonGrid(p=jnp.zeros((1, 3)), wi=jnp.zeros((1, 3)),
                          alpha=jnp.zeros((1, 3)),
                          packed=jnp.zeros((1, 12)),
                          start=jnp.zeros((2,), jnp.int32),
                          n_paths=jnp.asarray(max(n_paths, 1.0), jnp.float32),
                          radius=float(radius), n_buckets=1, bucket_cap=0,
                          count=0)
    m = 1
    while m < 2 * n:
        m *= 2
    cells = np.floor(p / radius).astype(np.int64)
    h = _cell_hash(cells[:, 0], cells[:, 1], cells[:, 2], m).astype(np.int64)
    order = np.argsort(h, kind="stable")
    p, wi, alpha, hs = p[order], wi[order], alpha[order], h[order]

    # Unbiased sparsification: buckets over the cap keep a random subset
    # with alpha scaled by count/cap (Russian-roulette style; expectation
    # of the density estimate is unchanged, unlike silent truncation).
    start = np.searchsorted(hs, np.arange(m + 1))
    counts = np.diff(start)
    over = np.nonzero(counts > max_bucket_cap)[0]
    if len(over):
        rng_ = np.random.default_rng(0x9e3779b9)
        alpha = alpha.copy()
        keep = np.ones(len(p), bool)
        for b in over:
            s, c = start[b], counts[b]
            sel = rng_.permutation(c)[:max_bucket_cap] + s
            keep[s:s + c] = False
            keep[sel] = True
            alpha[sel] *= c / max_bucket_cap
        p, wi, alpha, hs = p[keep], wi[keep], alpha[keep], hs[keep]
        start = np.searchsorted(hs, np.arange(m + 1))
        counts = np.diff(start)
        n = len(p)
    cap = int(min(max(counts.max(), 1), max_bucket_cap))
    return PhotonGrid(
        p=jnp.asarray(p, jnp.float32),
        wi=jnp.asarray(wi, jnp.float32),
        alpha=jnp.asarray(alpha, jnp.float32),
        packed=jnp.asarray(
            np.concatenate([p, wi, alpha, np.zeros((n, 3), np.float32)],
                           axis=1), jnp.float32),
        start=jnp.asarray(start, jnp.int32),
        n_paths=jnp.asarray(max(n_paths, 1.0), jnp.float32),
        radius=float(radius), n_buckets=m, bucket_cap=cap, count=n)


_NBR = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1],
                            indexing="ij"), -1).reshape(27, 3)

# Widened-gather budget: the 27 neighbor cells are processed in blocks of
# _cell_block(B) at a time, keeping B x block <= ~1.2M effective gather
# lanes. The cap was inherited from an earlier build, where larger
# widths faulted; it is not yet measured on the H100 (ROADMAP A4). Far
# below it the per-step fixed cost of the bucket loop dominates.
_WIDTH_BUDGET = 1 << 20


def _cell_block(B: int) -> int:
    for cb in (27, 9, 3):
        if B * cb <= _WIDTH_BUDGET:
            return cb
    return 1


def gather_photons(grid: PhotonGrid, q, accum, init):
    """Scan photons within `radius` of each query point q f32[B,3].

    accum(carry, wi, alpha, w[, d2]) is called with [B,cb,...]-shaped
    photon batches (wi/alpha are [B,cb,3], cb = _cell_block(B) neighbor
    cells at a time); w is True only for in-range photons; accept a 5th
    argument to receive squared distances (kernel estimators). Returns
    the final carry (a pytree of arrays).

    Cell blocking balances two failure modes the fixed [B,27] batch form
    had: its gather temporaries at large B overflow the device
    (UNAVAILABLE faults — the r4 4-16K lane caps), while a fully
    sequential [B,1] sweep pays the bucket loop's fixed cost 27x.
    """
    if grid.count == 0 or grid.bucket_cap == 0:
        return init
    import inspect
    import jax
    wants_d2 = len(inspect.signature(accum).parameters) >= 5
    r2 = jnp.float32(grid.radius * grid.radius)
    base = jnp.floor(q / grid.radius).astype(jnp.int32)
    cells = base[..., None, :] + jnp.asarray(_NBR, jnp.int32)   # [B,27,3]
    b = _cell_hash(cells[..., 0], cells[..., 1], cells[..., 2],
                   grid.n_buckets)                               # [B,27]
    s_all = grid.start[b]
    cnt_all = grid.start[b + 1] - s_all
    B = int(np.prod(q.shape[:-1]))
    cb = _cell_block(B)

    def make_body(s, cnt):
        def body(j, carry2):
            idx = jnp.minimum(s + j, grid.count - 1)            # [B,cb]
            rows = grid.packed[idx]                             # [B,cb,12]
            pp = rows[..., 0:3]
            d2 = jnp.sum((pp - q[..., None, :]) ** 2, -1)
            w = (j < cnt) & (d2 < r2)
            if wants_d2:
                return accum(carry2, rows[..., 3:6], rows[..., 6:9], w,
                             d2)
            return accum(carry2, rows[..., 3:6], rows[..., 6:9], w)
        return body

    carry = init
    for c0 in range(0, 27, cb):
        c1 = min(27, c0 + cb)
        carry = jax.lax.fori_loop(
            0, grid.bucket_cap,
            make_body(s_all[..., c0:c1], cnt_all[..., c0:c1]), carry)
    return carry


@pytree_dataclass
class PointGrid:
    """Generic hashed point cache (the replacement for the reference's
    generic Octree, core/octree.h:42-147): points + arbitrary payload
    columns, bucketed by cell of size `radius`, queried over 27 neighbor
    cells. Used by the irradiance cache."""
    p: jnp.ndarray                  # f32[N,3]
    payload: Tuple[jnp.ndarray, ...]  # each f32[N,...]
    start: jnp.ndarray              # i32[M+1]
    radius: float = static(default=0.1)
    n_buckets: int = static(default=1)
    bucket_cap: int = static(default=8)
    count: int = static(default=0)


def build_point_grid(p: np.ndarray, payload, radius: float,
                     max_bucket_cap: int = 64) -> PointGrid:
    n = p.shape[0]
    if n == 0:
        return PointGrid(p=jnp.zeros((1, 3)),
                         payload=tuple(jnp.asarray(x) for x in payload),
                         start=jnp.zeros((2,), jnp.int32),
                         radius=float(radius), n_buckets=1, bucket_cap=0,
                         count=0)
    m = 1
    while m < 2 * n:
        m *= 2
    cells = np.floor(p / radius).astype(np.int64)
    h = _cell_hash(cells[:, 0], cells[:, 1], cells[:, 2], m).astype(np.int64)
    order = np.argsort(h, kind="stable")
    hs = h[order]
    start = np.searchsorted(hs, np.arange(m + 1))
    cap = int(min(max(np.diff(start).max(), 1), max_bucket_cap))
    return PointGrid(
        p=jnp.asarray(p[order], jnp.float32),
        payload=tuple(jnp.asarray(np.asarray(x)[order]) for x in payload),
        start=jnp.asarray(start, jnp.int32),
        radius=float(radius), n_buckets=m, bucket_cap=cap, count=n)


def gather_points(grid: PointGrid, q, accum, init):
    """Like gather_photons but payload-generic: accum(carry, pp, payload
    tuple, in_bucket_mask) with [B,1,...]-shaped gathers per step (cells
    scanned sequentially — see gather_photons). The accum callback
    applies its own radius/validity tests."""
    if grid.count == 0 or grid.bucket_cap == 0:
        return init
    import jax
    base = jnp.floor(q / grid.radius).astype(jnp.int32)
    cells = base[..., None, :] + jnp.asarray(_NBR, jnp.int32)
    b = _cell_hash(cells[..., 0], cells[..., 1], cells[..., 2],
                   grid.n_buckets)
    s_all = grid.start[b]
    cnt_all = grid.start[b + 1] - s_all
    B = int(np.prod(q.shape[:-1]))
    cb = _cell_block(B)

    def make_body(s, cnt):
        def body(j, carry2):
            idx = jnp.minimum(s + j, grid.count - 1)
            pp = grid.p[idx]
            pay = tuple(x[idx] for x in grid.payload)
            return accum(carry2, pp, pay, j < cnt)
        return body

    carry = init
    for c0 in range(0, 27, cb):
        c1 = min(27, c0 + cb)
        carry = jax.lax.fori_loop(
            0, grid.bucket_cap,
            make_body(s_all[..., c0:c1], cnt_all[..., c0:c1]), carry)
    return carry

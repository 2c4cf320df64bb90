"""Best-candidate sample-table generator — the host-side analogue of the
reference's offline samplepat tool (/root/reference/tools/samplepat.cpp:39-
116 + core/sampling.cpp BestCandidate2D), which bakes a 4096-entry 5D
table shipped as generated source (samplers/sampledata.cpp). Here the
table ships as bc_table.npy (regenerate with `python -m
prt.samplers.bc_gen`).

Columns: [image_x, image_y, time, lens_u, lens_v], all in [0,1).

  * image xy: progressive toroidal best-candidate (dart throwing — each
    accepted point maximizes its min toroidal distance to all previous
    points over a candidate pool that grows with the point count, the
    BestCandidate2D construction).
  * time: stratified values (i+u)/N, greedily reassigned so each sample's
    time maximizes the min |dt| against its spatial grid neighbors
    (samplepat.cpp:46-96).
  * lens: an independent toroidal best-candidate 2D set, greedily
    assigned to maximize min 2D toroidal distance against spatial
    neighbors (samplepat's Redistribute2D).
"""
from __future__ import annotations

import os

import numpy as np

TABLE_SIZE = 4096
GRID = 40          # BC_GRID_SIZE in the reference


def _toroidal_d2(a, b):
    d = np.abs(a[..., None, :] - b[None, ...]) if a.ndim == 2 else \
        np.abs(a - b)
    d = np.minimum(d, 1.0 - d)
    return (d * d).sum(-1)


def best_candidate_2d(n, rng, k0=10):
    pts = np.empty((n, 2), np.float32)
    pts[0] = rng.random(2)
    # Candidate pool capped at 128 (the reference grows it linearly with
    # the point count, but past ~100 candidates the min-distance gain is
    # marginal while the cost is O(k n^2)).
    for i in range(1, n):
        k = min(k0 * (i + 1) // 2 + 1, 128)
        cand = rng.random((k, 2)).astype(np.float32)
        # toroidal min distance of each candidate to the accepted set
        d = np.abs(cand[:, None, :] - pts[None, :i, :])
        d = np.minimum(d, 1.0 - d)
        mind = (d * d).sum(-1).min(1)
        pts[i] = cand[np.argmax(mind)]
    return pts


def _grid_neighbors(pts):
    """For each point: indices of points in its 3x3 toroidal grid cells."""
    cells = {}
    ij = (pts * GRID).astype(int) % GRID
    for idx, (u, v) in enumerate(ij):
        cells.setdefault((u, v), []).append(idx)
    neigh = []
    for idx, (u, v) in enumerate(ij):
        ns = []
        for du in (-1, 0, 1):
            for dv in (-1, 0, 1):
                ns += cells.get(((u + du) % GRID, (v + dv) % GRID), [])
        neigh.append(np.asarray([j for j in ns if j != idx], int))
    return neigh


def generate_table(n=TABLE_SIZE, seed=0):
    rng = np.random.default_rng(seed)
    xy = best_candidate_2d(n, rng)
    neigh = _grid_neighbors(xy)

    # Times: stratified pool, greedily assigned (samplepat.cpp:46-96).
    pool = ((np.arange(n) + rng.random(n)) / n).astype(np.float32)
    times = np.empty(n, np.float32)
    times[0] = pool[0]
    remaining = list(range(1, n))
    assigned = np.zeros(n, bool)
    assigned[0] = True
    for i in range(1, n):
        prev = neigh[i][assigned[neigh[i]]]
        cand = pool[remaining]
        if len(prev):
            dt = np.abs(cand[:, None] - times[prev][None, :])
            dt = np.minimum(dt, 1.0 - dt)
            best = int(np.argmax(dt.min(1)))
        else:
            best = 0
        times[i] = cand[best]
        assigned[i] = True
        remaining.pop(best)

    # Lens: independent BC 2D set, greedily assigned by 2D toroidal
    # distance to spatial neighbors' lens values (Redistribute2D).
    lens_pool = best_candidate_2d(n, rng, k0=4)
    lens = np.empty((n, 2), np.float32)
    lens[0] = lens_pool[0]
    remaining = list(range(1, n))
    assigned[:] = False
    assigned[0] = True
    for i in range(1, n):
        prev = neigh[i][assigned[neigh[i]]]
        cand = lens_pool[remaining]
        if len(prev):
            d = np.abs(cand[:, None, :] - lens[prev][None, :, :])
            d = np.minimum(d, 1.0 - d)
            best = int(np.argmax((d * d).sum(-1).min(1)))
        else:
            best = 0
        lens[i] = cand[best]
        assigned[i] = True
        remaining.pop(best)

    return np.concatenate([xy, times[:, None], lens], axis=1)


_TABLE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "bc_table.npy")


def load_table() -> np.ndarray:
    """The baked table (generated once, committed like the reference's
    sampledata.cpp); regenerates if missing."""
    if os.path.exists(_TABLE_PATH):
        return np.load(_TABLE_PATH)
    t = generate_table()
    try:
        np.save(_TABLE_PATH, t)
    except OSError:
        pass
    return t


if __name__ == "__main__":
    t = generate_table()
    np.save(_TABLE_PATH, t)
    d = np.abs(t[:, None, 0:2] - t[None, :, 0:2])
    d = np.minimum(d, 1.0 - d)
    d2 = (d * d).sum(-1) + np.eye(len(t)) * 10
    print(f"wrote {_TABLE_PATH}: {t.shape}, "
          f"min image dist {np.sqrt(d2.min()):.5f} "
          f"(random-expected ~{0.5 / np.sqrt(len(t)):.5f})")

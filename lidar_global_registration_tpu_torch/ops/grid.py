"""Fixed-radius neighbours of arbitrary positions
(lidar_global_registration_tpu/ops/grid.py `build_grid` +
`radius_neighbors`).

The JAX package hashes the support cloud into a capped cell list
(`cell_cap` points per cell, the rest dropped in cloud order) and takes
`lax.approx_min_k` on the TPU.  Here the query walks the support cloud's
CSR plan (ops/cellgrid.plan_grid, cell >= radius): a position's 9 stencil
column ranges come from the plan's sorted cell keys (cellgrid.position_cols;
the position's own cell may be empty), every point of those columns is a
candidate, and the k nearest within r are kept by an exact top-k.  Exact
and uncapped, like the reference's radiusSearch and the JAX package's CPU
path.

knn (grid.knn over the cloud itself, as the normal estimation asks it, or
of other positions on the cloud, as the pyramid's keypoint normals ask it) and
nearest_within (grid.radius_neighbors with k = 1, as the analysis and the
closest-plane metric ask it) are exact too, where the JAX package's capped
cells (cell_cap = 64) drop points of overfull cells in cloud order.
"""
from __future__ import annotations

import torch

from lidar_global_registration_tpu_torch.ops import cellgrid
from lidar_global_registration_tpu_torch.ops.density import knn_nonself

BIG = 3.0e38


def radius_neighbors(plan: cellgrid.GridPlan, queries: torch.Tensor, qvalid: torch.Tensor,
                     radius: float, k: int):
    """The k nearest support points within `radius` (self included,
    d2 <= r2) of each query f32[M, 3] (grid.radius_neighbors with
    include_self), found over query chunks whose candidate blocks hold
    about cellgrid._CHUNK_PAIRS slots.  Returns (idx i64[M, K], dist
    f32[M, K], mask bool[M, K]) sorted by distance, K = min(k, the most
    neighbours a query has), at least 1; idx are input rows of the plan's
    cloud (0 where masked), dist is BIG where masked."""
    if radius > plan.cell:
        raise ValueError(f"radius {radius} exceeds the plan's cell {plan.cell}")
    r2 = cellgrid._f32_square(radius)
    cols = cellgrid.position_cols(plan, queries)
    lens = (cols[..., 1] - cols[..., 0]).sum(1)
    parts = []
    for a, b in cellgrid._chunk_ranges(lens):
        ids, ok = cellgrid.candidates_from_cols(cols[a:b])
        d = plan.pts[ids, :3] - queries[a:b, None, :]
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        d2 = dx * dx + dy * dy + dz * dz
        ok = ok & qvalid[a:b, None] & (d2 <= r2)
        kk = max(1, min(k, int(ok.sum(1).max())))
        d2_sel, sel = torch.topk(torch.where(ok, d2, BIG), kk, dim=1, largest=False, sorted=True)
        mask = (d2_sel <= r2) & qvalid[a:b, None]
        parts.append((a, b, plan.order[ids.gather(1, sel)], d2_sel, mask))
    M = queries.shape[0]
    K = max([p[2].shape[1] for p in parts], default=1)
    dev = queries.device
    idx = torch.zeros((M, K), dtype=torch.int64, device=dev)
    dist = torch.full((M, K), BIG, dtype=torch.float32, device=dev)
    mask = torch.zeros((M, K), dtype=torch.bool, device=dev)
    for a, b, i, d2_sel, m in parts:
        kk = i.shape[1]
        idx[a:b, :kk] = torch.where(m, i, 0)
        dist[a:b, :kk] = torch.where(m, d2_sel.clamp_min(0.0).sqrt(), BIG)
        mask[a:b, :kk] = m
    return idx, dist, mask


def knn(xyz: torch.Tensor, valid: torch.Tensor, k: int, queries: torch.Tensor | None = None,
        qvalid: torch.Tensor | None = None):
    """The k nearest valid points of every valid row of the cloud, itself
    first (grid.knn with include_self over the cloud's own grid, whose
    27-cell envelope the JAX package grows until it holds the k-th
    neighbour), or with `queries` (f32[M, 3], valid where qvalid) the k
    nearest valid points of the cloud to each query position at any
    distance (grid.knn of the queries on the cloud's grid): exact, from
    ops/density.knn_nonself.  Returns (idx i64[N or M, k] input rows, dist
    f32 ascending, mask bool); masked entries (invalid rows, clouds of
    fewer than k points) hold 0 and BIG."""
    dev = xyz.device
    rows = torch.nonzero(valid).squeeze(1)
    if queries is None:
        N = xyz.shape[0]
        qrows = rows
        d, j = knn_nonself(xyz[rows], k - 1)
        d = torch.cat([torch.zeros_like(d[:, :1]), d], 1)
        j = torch.cat([torch.arange(rows.shape[0], device=dev)[:, None], j], 1)
    else:
        N = queries.shape[0]
        qrows = (torch.nonzero(qvalid).squeeze(1) if qvalid is not None
                 else torch.arange(N, device=dev))
        d, j = knn_nonself(xyz[rows], k, queries=queries[qrows])
    ok = torch.isfinite(d)
    idx = torch.zeros((N, k), dtype=torch.int64, device=dev)
    dist = torch.full((N, k), BIG, dtype=torch.float32, device=dev)
    mask = torch.zeros((N, k), dtype=torch.bool, device=dev)
    idx[qrows] = torch.where(ok, rows[j], 0)
    dist[qrows] = torch.where(ok, d, BIG)
    mask[qrows] = ok
    return idx, dist, mask


def nearest_within(xyz: torch.Tensor, valid: torch.Tensor, queries: torch.Tensor,
                   qvalid: torch.Tensor, radius: float):
    """The nearest valid point of the cloud within `radius` (d2 <= r2) of
    each query position f32[M, 3] (grid.radius_neighbors(..., k=1)).
    Exact, in passes at radius / 8, / 4, / 2 and radius, each over a plan
    of that cell: a query whose nearest point lies within a pass's radius
    is answered there (every point that near is in its stencil); only the
    rest go on, so a dense cloud is searched with a few candidates a query.
    Returns (idx i64[M], dist f32[M], found bool[M]); 0 and BIG where
    nothing lies within `radius`."""
    M = queries.shape[0]
    dev = queries.device
    idx = torch.zeros((M,), dtype=torch.int64, device=dev)
    dist = torch.full((M,), BIG, dtype=torch.float32, device=dev)
    found = torch.zeros((M,), dtype=torch.bool, device=dev)
    todo = torch.nonzero(qvalid).squeeze(1)
    if not bool(valid.any()):
        return idx, dist, found
    for f in (0.125, 0.25, 0.5, 1.0):
        if todo.numel() == 0:
            break
        rho = radius * f
        plan = cellgrid.plan_grid(xyz, valid, rho)
        i, d, m = radius_neighbors(plan, queries[todo], torch.ones_like(todo, dtype=torch.bool),
                                   rho, 1)
        hit = m[:, 0]
        rows = todo[hit]
        idx[rows], dist[rows], found[rows] = i[hit, 0], d[hit, 0], True
        todo = todo[~hit]
    return idx, dist, found

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
"""
from __future__ import annotations

import torch

from lidar_global_registration_tpu_torch.ops import cellgrid

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

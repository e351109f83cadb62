"""Point density and the radii derived from it
(lidar_global_registration_tpu/ops/density.py, bench.py `_derive_radii`).

smoothed density(i) = min(d_k(i), d_k(j)), d_k the distance to the k-th
nearest neighbour (self included, PCL's convention) and j the nearest
non-self neighbour; the cloud density is the 0.8-quantile of the k=8
smoothed densities with the reference's nth_element indexing
(common.cpp:202-208, 531-547).

The neighbours come from the cell-list plan of ops/cellgrid.py, as the JAX
package's come from its grid hash (density.knn_distances,
_auto_cell_size): an automatic cell from the cloud's extent, doubled while
fewer than 99.9 % of the points have their k-th neighbour within one cell.
A row whose k-th neighbour lies within the cell is exact (every point that
near is in the 27-cell stencil); only the rows not yet exact are queried
again at the doubled cell, and the few left after the last doubling are
finished against the whole cloud.  So the result equals a brute-force
kNN.  This is set-up work run once per scene, in plain PyTorch.
"""
from __future__ import annotations

import math

import torch

from lidar_global_registration_tpu_torch.ops import cellgrid
from lidar_global_registration_tpu_torch.types import (
    FEATURE_NR_POINTS,
    NORMAL_NR_POINTS,
)
from lidar_global_registration_tpu_torch.utils import profiling

_BRUTE_CHUNK_PAIRS = 1 << 26  # distance slots per query chunk of the finish


def _auto_cell(pts: torch.Tensor, k: int) -> float:
    """density._auto_cell_size: points live on 2D surfaces, so the k-NN
    radius scales like spacing * sqrt(k / pi), spacing ~ diag / sqrt(n)."""
    n = max(pts.shape[0], 1)
    diag = float((pts.amax(0) - pts.amin(0)).pow(2).sum().sqrt()) if pts.shape[0] else 0.0
    spacing = diag / max(math.sqrt(n), 1.0)
    return max(spacing * math.sqrt(max(k, 2) / math.pi) * 1.5, 1e-12)


def _knn_topk(d2: torch.Tensor, k: int):
    """Ascending k smallest d2 per row (self and absent = inf), padded with
    inf / 0 where a row has fewer than k columns."""
    vals, ids = torch.topk(d2, min(k, d2.shape[1]), dim=1, largest=False, sorted=True)
    if vals.shape[1] < k:
        pad = k - vals.shape[1]
        vals = torch.nn.functional.pad(vals, (0, pad), value=torch.inf)
        ids = torch.nn.functional.pad(ids, (0, pad), value=0)
    return vals, ids


def _knn_brute(pts: torch.Tensor, rows: torch.Tensor, k: int,
               queries: torch.Tensor | None = None):
    """Exact kNN of pts[rows] (at nonzero distance) or of the positions
    queries[rows] (at any distance) against the whole cloud."""
    n = pts.shape[0]
    q = pts[rows] if queries is None else queries[rows]
    dist = torch.empty((rows.shape[0], k), dtype=torch.float32, device=pts.device)
    idx = torch.empty((rows.shape[0], k), dtype=torch.int64, device=pts.device)
    cx, cy, cz = pts[:, 0][None, :], pts[:, 1][None, :], pts[:, 2][None, :]
    chunk = max(1, _BRUTE_CHUNK_PAIRS // max(n, 1))
    for s in range(0, rows.shape[0], chunk):
        qs = q[s:s + chunk]
        dx, dy, dz = cx - qs[:, 0:1], cy - qs[:, 1:2], cz - qs[:, 2:3]
        d2 = dx * dx + dy * dy + dz * dz
        vals, ids = _knn_topk(torch.where(d2 > 0.0, d2, torch.inf) if queries is None else d2, k)
        dist[s:s + chunk] = vals.sqrt()
        idx[s:s + chunk] = ids
    return dist, idx


def _stencil_blocks(plan: cellgrid.GridPlan, todo: torch.Tensor, queries):
    """(a, b, ids, ok, d2) over query chunks of `todo`: every candidate of
    each query's 27-cell stencil (sorted slots ids, ok) with its squared
    distance.  The queries are the plan's own rows todo (queries None,
    zero distances dropped: self-exclusion) or the positions queries[todo],
    in order of their cells."""
    if queries is None:
        slots = cellgrid.slot_of(plan)[todo]
        for (a, b), sl in cellgrid._slot_chunks(plan, slots):
            ids, ok = cellgrid.candidates_at(plan, sl)
            d2 = cellgrid._pair_d2(plan, sl, ids)[3]
            yield a, b, ids, ok & (d2 > 0.0), d2
        return
    cols = cellgrid.position_cols(plan, queries[todo])
    lens = (cols[..., 1] - cols[..., 0]).sum(1)
    for a, b in cellgrid._chunk_ranges(lens):
        ids, ok = cellgrid.candidates_from_cols(cols[a:b])
        d = plan.pts[ids, :3] - queries[todo[a:b], None, :]
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        yield a, b, ids, ok, dx * dx + dy * dy + dz * dz


def knn_nonself(pts: torch.Tensor, k: int, max_doublings: int = 8,
                min_covered: float = 0.999, queries: torch.Tensor | None = None):
    """Exact k nearest neighbours at nonzero distance among `pts` [n, 3]
    (density.knn_distances on the cell-list plan, see the module
    docstring).  Self-exclusion is by zero distance (the framework-wide
    include_self=False convention, ops/grid.py).  With `queries` (positions
    f32[m, 3], e.g. keypoints against a coarser surface) the k nearest
    points of pts to each position at any distance, by the same passes
    (grid.knn of one cloud against another).  Returns (dist f32[m, k]
    ascending, idx i64[m, k] rows of pts); rows with fewer than k such
    neighbours carry inf."""
    dev = pts.device
    n = pts.shape[0]
    m = n if queries is None else queries.shape[0]
    dist = torch.full((m, k), torch.inf, dtype=torch.float32, device=dev)
    idx = torch.zeros((m, k), dtype=torch.int64, device=dev)
    if n == 0 or m == 0:
        return dist, idx
    valid = torch.ones((n,), dtype=torch.bool, device=dev)
    todo = torch.arange(m, device=dev)
    cell = _auto_cell(pts, k + 1)
    for _ in range(max_doublings):
        plan = cellgrid.plan_grid(pts, valid, cell)
        if queries is not None:  # cell order, so that a chunk's candidate rows are alike
            todo = todo[cellgrid.position_cols(plan, queries[todo])[:, 4, 0].argsort(stable=True)]
        done = torch.zeros((todo.shape[0],), dtype=torch.bool, device=dev)
        for a, b, ids, ok, d2 in _stencil_blocks(plan, todo, queries):
            vals, j = _knn_topk(torch.where(ok, d2, torch.inf), k)
            dk = vals.sqrt()
            # exact when the k-th neighbour lies within one cell
            cov = dk[:, k - 1] <= cell
            rows = todo[a:b][cov]
            dist[rows] = dk[cov]
            idx[rows] = plan.order[ids.gather(1, j)][cov]
            done[a:b] = cov
        todo = todo[~done]
        if todo.shape[0] <= (1.0 - min_covered) * m:
            break
        cell *= 2.0
    if todo.shape[0]:
        dist[todo], idx[todo] = _knn_brute(pts, todo, k, queries)
    return dist, idx


def knn_window(xyz: torch.Tensor, valid: torch.Tensor, window: float, k: int) -> torch.Tensor:
    """Distances f32[N, k] (ascending) from every valid row to its k nearest
    valid points within `window` (d2 <= window^2), itself included; inf
    where fewer lie in the window, and on invalid rows.

    Exact, in passes over cell-list plans at window / 4, window / 2 and
    window: a row whose k-th neighbour lies within a pass's radius has all
    its k nearest in that plan's 27-cell stencil and is done; only the
    rest are queried at the next radius (on a cloud of even spacing the
    first pass, with a sixteenth of the window's candidates, finishes most
    rows).  Each pass runs in query chunks of about cellgrid._CHUNK_PAIRS
    candidates."""
    dev = xyz.device
    out = torch.full((xyz.shape[0], k), torch.inf, dtype=torch.float32, device=dev)
    todo = torch.nonzero(valid).squeeze(1)
    for radius in (0.25 * window, 0.5 * window, window):
        if todo.numel() == 0:
            break
        plan = cellgrid.plan_grid(xyz, valid, radius)
        r2 = cellgrid._f32_square(radius)
        # cell order, so that a chunk's candidate rows are alike
        slots, order = cellgrid.slot_of(plan)[todo].sort()
        todo = todo[order]
        parts = []
        for _ab, sl in cellgrid._slot_chunks(plan, slots):
            ids, ok = cellgrid.candidates_at(plan, sl)
            d2 = cellgrid._pair_d2(plan, sl, ids)[3]
            parts.append(_knn_topk(torch.where(ok & (d2 <= r2), d2, torch.inf), k)[0])
        dist = torch.cat(parts).sqrt()
        done = torch.isfinite(dist[:, k - 1])
        if radius == window:
            done = torch.ones_like(done)
        out[todo[done]] = dist[done]
        todo = todo[~done]
    return out


def smoothed_densities(pts: torch.Tensor, k: int = 2) -> torch.Tensor:
    """k-smoothed densities of `pts` [n, 3] (PCL self-inclusive k); 0 where a
    point has too few neighbours."""
    kk = max(k - 1, 1)
    dist, idx = knn_nonself(pts, kk)
    d_raw = dist[:, kk - 1]
    d_nn = torch.where(torch.isfinite(dist[:, 0]), d_raw[idx[:, 0]], torch.inf)
    out = torch.minimum(d_raw, d_nn)
    return torch.where(torch.isfinite(out), out, 0.0)


def cloud_density(xyz: torch.Tensor, valid: torch.Tensor | None = None,
                  quantile: float = 0.8) -> float:
    """Reference common.cpp:202-208: nth_element at k = clamp(q*n - 1)."""
    pts = xyz if valid is None else xyz[valid]
    n = pts.shape[0]
    if n == 0:
        return 0.0
    d = smoothed_densities(pts, k=8)
    kth = min(max(int(quantile * n - 1), 0), n - 1)
    return float(torch.kthvalue(d.cpu(), kth + 1).values)


def derive_radii(a: torch.Tensor, b: torch.Tensor, valid_a=None, valid_b=None):
    """Density-derived parameters with the formulas of bench.py:105-140
    (the reference's auto-derivation, common.cpp:268, 327-333); the span
    lgr.setup.radii."""
    with profiling.span("lgr.setup.radii"):
        ds = cloud_density(a, valid_a)
        dt = cloud_density(b, valid_b)
    d = max(ds, dt)
    return dict(
        normal_cell=float(math.sqrt(NORMAL_NR_POINTS * d * d / math.pi)),
        iss_src=2.0 * ds,
        iss_tgt=2.0 * dt,
        feature=float(math.sqrt(FEATURE_NR_POINTS * d * d / math.pi)),
        thr=4.0 * d,
        density_src=ds,
        density_tgt=dt,
    )

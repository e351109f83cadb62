"""Point density and the radii derived from it
(lidar_global_registration_tpu/ops/density.py, bench.py `_derive_radii`).

smoothed density(i) = min(d_k(i), d_k(j)), d_k the distance to the k-th
nearest neighbour (self included, PCL's convention) and j the nearest
non-self neighbour; the cloud density is the 0.8-quantile of the k=8
smoothed densities with the reference's nth_element indexing
(common.cpp:202-208, 531-547).

The JAX package finds the neighbours with a grid-hash envelope search; here
an exact brute-force kNN in query chunks takes its place.  This is set-up
work run once per scene, not a kernel of the registration path.
"""
from __future__ import annotations

import math

import torch

from lidar_global_registration_tpu_torch.types import (
    FEATURE_NR_POINTS,
    NORMAL_NR_POINTS,
)


def knn_nonself(pts: torch.Tensor, k: int, chunk: int = 1024):
    """Exact k nearest neighbours at nonzero distance among `pts` [n, 3].

    Self-exclusion is by zero distance (the framework-wide include_self=False
    convention, ops/grid.py).  Returns (dist f32[n, k] ascending, idx
    i64[n, k]); rows with fewer than k such neighbours carry inf."""
    n = pts.shape[0]
    dist = torch.empty((n, k), dtype=torch.float32, device=pts.device)
    idx = torch.empty((n, k), dtype=torch.int64, device=pts.device)
    cx, cy, cz = pts[:, 0][None, :], pts[:, 1][None, :], pts[:, 2][None, :]
    for s in range(0, n, chunk):
        q = pts[s:s + chunk]
        dx = cx - q[:, 0:1]
        dy = cy - q[:, 1:2]
        dz = cz - q[:, 2:3]
        d2 = dx * dx + dy * dy + dz * dz
        d2 = torch.where(d2 > 0.0, d2, torch.inf)
        vals, ids = torch.topk(d2, min(k, n), dim=1, largest=False, sorted=True)
        if vals.shape[1] < k:  # tiny clouds: pad the missing neighbours
            pad = k - vals.shape[1]
            vals = torch.nn.functional.pad(vals, (0, pad), value=torch.inf)
            ids = torch.nn.functional.pad(ids, (0, pad), value=0)
        dist[s:s + chunk] = vals.sqrt()
        idx[s:s + chunk] = ids
    return dist, idx


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
    (the reference's auto-derivation, common.cpp:268, 327-333)."""
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

"""kNN-PCA normal estimation with viewpoint orientation and postprocessing
(lidar_global_registration_tpu/ops/normals.py).

Reference: src/common.cpp:593-655 (estimateNormalsPoints via
pcl::NormalEstimationOMP + postprocessNormals).  PCA covariance over the k
nearest neighbours (self inclusive), normal = eigenvector of the smallest
eigenvalue, curvature = l0 / (l0 + l1 + l2), flipped toward the viewpoint.
The neighbours are exact (ops/grid.knn), as the reference's kd-tree's; the
JAX package's capped grid drops points of overfull cells.
"""
from __future__ import annotations

import dataclasses

import torch

from lidar_global_registration_tpu_torch.ops.eigen3 import smallest_eigvec_sym3
from lidar_global_registration_tpu_torch.ops.grid import knn
from lidar_global_registration_tpu_torch.types import Cloud

_ROWS = 1 << 18  # query rows per covariance chunk: [rows, k] gathers per coordinate


def covariance_from_neighbors(xyz_all: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor):
    """Masked mean-centred covariance per query: xyz_all f32[N, 3], idx
    i64[M, K], mask bool[M, K] -> (cov f32[M, 3, 3], mean f32[M, 3], count
    i32[M]), in the JAX function's order of operations."""
    w = mask.to(torch.float32)
    cnt = w.sum(1)
    safe = cnt.clamp_min(1.0)
    comps, means = [], []
    for d in range(3):
        xd = xyz_all[:, d][idx]
        md = (xd * w).sum(1) / safe
        comps.append((xd - md[:, None]) * w)
        means.append(md)
    rows = []
    for i in range(3):
        row = []
        for j in range(3):
            row.append(rows[j][i] if j < i else (comps[i] * comps[j]).sum(1) / safe)
        rows.append(row)
    cov = torch.stack([torch.stack(r, -1) for r in rows], -2)
    return cov, torch.stack(means, -1), cnt.to(torch.int32)


def normals_from_neighbors(points: torch.Tensor, xyz_surface: torch.Tensor, idx: torch.Tensor,
                           mask: torch.Tensor, viewpoint=None):
    """PCA normals and curvature of `points` f32[M, 3] from neighbour
    lists on `xyz_surface`.  Returns (normal f32[M, 3], curvature f32[M],
    ok bool[M]); ok needs 3 neighbours, normals are 0 where not ok."""
    cov, _mean, cnt = covariance_from_neighbors(xyz_surface, idx, mask)
    eig, v = smallest_eigvec_sym3(cov)
    lam = eig.clamp_min(0.0)
    tot = lam.sum(-1)
    curvature = torch.where(tot > 0, lam[:, 0] / tot.clamp_min(1e-30), 0.0)
    ok = cnt >= 3
    vp = torch.zeros(3, dtype=torch.float32, device=points.device) if viewpoint is None else (
        torch.as_tensor(viewpoint, dtype=torch.float32, device=points.device))
    flip = (v * (vp[None, :] - points)).sum(-1) < 0.0
    v = torch.where(flip[:, None], -v, v)
    return torch.where(ok[:, None], v, 0.0), curvature, ok


def postprocess_normals(normal, curvature, ok, file_normal, normals_available: bool):
    """Reference common.cpp:593-628: with file normals, failed estimates take
    the file's normal and estimates that disagree with it flip; then every
    nonzero normal is renormalised.  A zero normal plays PCL's NaN."""
    if normals_available:
        has_file = (file_normal * file_normal).sum(-1) > 0
        normal = torch.where((~ok & has_file)[:, None], file_normal, normal)
        ok = ok | has_file
        flip = has_file & ((normal * file_normal).sum(-1) < 0)
        normal = torch.where(flip[:, None], -normal, normal)
    n = (normal * normal).sum(-1, keepdim=True).sqrt()
    normal = torch.where(n > 1e-30, normal / n.clamp_min(1e-30), normal)
    return normal, curvature, ok


def estimate_normals_knn(cloud: Cloud, surface: Cloud | None = None, k: int = 30,
                         viewpoint=None, normals_available: bool = False) -> Cloud:
    """estimateNormalsPoints (common.cpp:644-655): for each point of `cloud`
    the k nearest points of `surface` (the cloud itself when None; self
    included), their PCA normal oriented to `viewpoint` (the origin when
    None), then postprocess_normals against the cloud's own normals (file
    normals, or the normals a keypoint already has).  The covariances run
    in chunks of _ROWS queries."""
    surf = cloud if surface is None else surface
    if surface is None:
        idx, _dist, mask = knn(cloud.xyz, cloud.valid, k)
    else:
        idx, _dist, mask = knn(surf.xyz, surf.valid, k, queries=cloud.xyz, qvalid=cloud.valid)
    normal = torch.zeros_like(cloud.xyz)
    curvature = torch.zeros_like(cloud.weight)
    ok = torch.zeros_like(cloud.valid)
    for s in range(0, cloud.capacity, _ROWS):
        e = min(s + _ROWS, cloud.capacity)
        normal[s:e], curvature[s:e], ok[s:e] = normals_from_neighbors(
            cloud.xyz[s:e], surf.xyz, idx[s:e], mask[s:e], viewpoint)
    normal, curvature, ok = postprocess_normals(normal, curvature, ok, cloud.normal,
                                                normals_available)
    normal = torch.where(cloud.valid[:, None], normal, 0.0)
    curvature = torch.where(cloud.valid, curvature, 0.0)
    return dataclasses.replace(cloud, normal=normal, curvature=curvature)

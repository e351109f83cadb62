"""Per-point weight functions of the weighted_closest_plane metric
(lidar_global_registration_tpu/ops/weights.py).

Reference: src/weights.cpp: constant, exp_curvature, curvedness (principal
curvatures, pcl::PrincipalCurvaturesEstimation), harris / tomasi /
curvature (pcl::HarrisKeypoint3D responses over the normal covariance) and
nss (inverse normal-space histogram).  All but constant, curvature and nss
read one kNN per point (ops/grid.knn: exact, where the JAX package's cell
list keeps 64 points a cell) and a batched 3 x 3 eigen-analysis.

As in the JAX package, nss bins theta / pi and phi / 2 pi, where the
reference's findBin (weights.cpp:151-163) indexes theta * 8 and phi * 8 and
overflows its own 8 x 8 histogram.
"""
from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from lidar_global_registration_tpu_torch.ops.eigen3 import eigvals_sym3
from lidar_global_registration_tpu_torch.ops.grid import knn
from lidar_global_registration_tpu_torch.types import (
    METRIC_WEIGHT_CONSTANT,
    METRIC_WEIGHT_CURVATURE,
    METRIC_WEIGHT_CURVEDNESS,
    METRIC_WEIGHT_EXP_CURVATURE,
    METRIC_WEIGHT_HARRIS,
    METRIC_WEIGHT_NSS,
    METRIC_WEIGHT_TOMASI,
    Cloud,
)

NS_BIN = 8


def _cov(a: torch.Tensor, w: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """sum_k w a_k a_k^T / cnt for a f32[N, K, 3], w f32[N, K]: elementwise
    float32 sums (the JAX package's einsum at HIGHEST precision)."""
    c = {}
    for i in range(3):
        for j in range(i, 3):
            c[i, j] = c[j, i] = (w * a[..., i] * a[..., j]).sum(1) / cnt
    return torch.stack([torch.stack([c[i, j] for j in range(3)], -1) for i in range(3)], -2)


def principal_curvatures(cloud: Cloud, k: int):
    """pc1 >= pc2 per point: the two largest eigenvalues of the covariance
    of the neighbours' normals projected onto the point's tangent plane
    (PCL semantics; k nearest, self included)."""
    idx, _dist, mask = knn(cloud.xyz, cloud.valid, k)
    ni = cloud.normal[:, None, :]
    nj = cloud.normal[idx]
    proj = nj - (nj * ni).sum(-1, keepdim=True) * ni
    w = mask.to(torch.float32)
    cnt = w.sum(1).clamp_min(1.0)
    mean = (proj * w[..., None]).sum(1) / cnt[:, None]
    d = (proj - mean[:, None, :]) * w[..., None]
    eig = eigvals_sym3(_cov(d, torch.ones_like(w), cnt))  # ascending
    return eig[:, 2], eig[:, 1]


def _normal_covariance_eigs(cloud: Cloud, k: int):
    """The covariance of the k nearest neighbours' normals (those of norm
    > 0.5) and its eigenvalues, ascending."""
    idx, _dist, mask = knn(cloud.xyz, cloud.valid, k)
    nj = cloud.normal[idx]
    w = (mask & ((nj * nj).sum(-1) > 0.5)).to(torch.float32)
    cov = _cov(nj, w, w.sum(1).clamp_min(1.0))
    return cov, eigvals_sym3(cov)


def _quantile(values: np.ndarray, q: float) -> float:
    """The reference's quantile (utils.h:478-498): a linear blend of two
    nth elements."""
    v = np.asarray(values, np.float64)
    n = len(v)
    if n == 0:
        return float("nan")
    if n == 1:
        return float(v[0])
    i = int(np.floor(q * (n - 1)))
    j = min(i + 1, n - 1)
    vi = np.partition(v, i)[i]
    if i < j:
        vj = np.partition(v, j)[j]
        return float(vi * (n * q - i) + vj * (j - n * q))
    return float(vi)


def weight_function(weight_id: str, nr_points: int, cloud: Cloud) -> torch.Tensor:
    """getWeightFunction (weights.cpp:24-41): f32[N] on the cloud's
    device, 0 at invalid rows.  An unknown id warns and weighs every point
    1, as the reference does."""
    valid = cloud.valid
    if weight_id == METRIC_WEIGHT_CONSTANT:
        return valid.to(torch.float32)

    if weight_id == METRIC_WEIGHT_EXP_CURVATURE:
        pc1, pc2 = principal_curvatures(cloud, nr_points)
        max_pc = torch.where(valid, torch.maximum(pc1, pc2), 0.0)
        q = _quantile(max_pc[valid].cpu().numpy(), 0.8)
        lam = np.log(1.05) * q
        w = torch.where(max_pc > 0, torch.exp(-lam / max_pc.clamp_min(1e-30)), 0.0)
        return torch.where(valid, w, 0.0)

    if weight_id == METRIC_WEIGHT_CURVEDNESS:
        pc1, pc2 = principal_curvatures(cloud, nr_points)
        w = torch.log(((pc1 * pc1 + pc2 * pc2) / 2.0).clamp_min(0.0).sqrt() + 1.0)
        return torch.where(valid, w, 0.0)

    if weight_id == METRIC_WEIGHT_CURVATURE:
        c = cloud.curvature
        return torch.where(valid & torch.isfinite(c), c, 0.0)

    if weight_id in (METRIC_WEIGHT_HARRIS, METRIC_WEIGHT_TOMASI):
        cov, eig = _normal_covariance_eigs(cloud, nr_points)
        if weight_id == METRIC_WEIGHT_TOMASI:
            return torch.where(valid, eig[:, 0], 0.0)
        tr = cov[:, 0, 0] + cov[:, 1, 1] + cov[:, 2, 2]
        return torch.where(valid, torch.linalg.det(cov) - 0.04 * tr * tr, 0.0)

    if weight_id == METRIC_WEIGHT_NSS:
        n = cloud.normal
        ok = valid & ((n * n).sum(-1) > 0.5)
        theta = torch.arccos(n[:, 2].clamp(-1.0, 1.0)) / math.pi  # [0, 1]
        phi = torch.remainder(torch.atan2(n[:, 1], n[:, 0]) + 2 * math.pi,
                              2 * math.pi) / (2 * math.pi)
        bt = torch.floor(theta * NS_BIN).clamp_max(NS_BIN - 1).long()
        bp = torch.floor(phi * NS_BIN).clamp_max(NS_BIN - 1).long()
        b = bt * NS_BIN + bp
        hist = torch.zeros((NS_BIN * NS_BIN,), dtype=torch.float32, device=n.device)
        hist.index_add_(0, b, ok.to(torch.float32))
        w = 1.0 / hist[b].clamp_min(1.0) / (NS_BIN * NS_BIN)
        return torch.where(ok, w, 0.0)

    warnings.warn(f"weight function {weight_id!r} isn't supported, using constant")
    return valid.to(torch.float32)

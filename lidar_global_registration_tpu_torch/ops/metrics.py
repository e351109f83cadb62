"""Metric estimators batched over a hypothesis axis
(lidar_global_registration_tpu/ops/metrics.py): the score functions, the
correspondence, uniformity and closest-plane metrics, the adaptive
iteration budget, and the MetricContext that the analysis and the `metric`
command score transforms with.

Reference: include/metric.h + src/metric.cpp; the score functions match
src/metric.cpp:55-81 (values relative to the per-correspondence adaptive
threshold).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from lidar_global_registration_tpu_torch.ops.grid import nearest_within
from lidar_global_registration_tpu_torch.types import (
    DIST_TO_PLANE_COEFFICIENT,
    METRIC_CLOSEST_PLANE,
    METRIC_COMBINATION,
    METRIC_SCORE_CONSTANT,
    METRIC_SCORE_EXP,
    METRIC_SCORE_MAE,
    METRIC_SCORE_MSE,
    METRIC_UNIFORMITY,
    METRIC_WEIGHTED_CLOSEST_PLANE,
)

BIG = 3.0e38


def score_values(dist: torch.Tensor, thr, score_id: str) -> torch.Tensor:
    """Per-inlier score (src/metric.cpp:55-81)."""
    if score_id == METRIC_SCORE_MAE:
        return (dist - thr).abs() / thr
    if score_id == METRIC_SCORE_MSE:
        return (dist - thr) * (dist - thr) / (thr * thr)
    if score_id == METRIC_SCORE_EXP:
        return torch.exp(-dist * dist / (2.0 * thr * thr))
    if score_id != METRIC_SCORE_CONSTANT:
        raise ValueError(f"unknown score function {score_id!r}")
    return torch.ones_like(dist)


def transform_points_soa(R: torch.Tensor, t: torch.Tensor, p: torch.Tensor):
    """R f32[B,3,3], t f32[B,3], p f32[M,3] -> 3 tensors f32[B,M]
    (explicit elementwise arithmetic: exact float32, no matmul)."""
    px, py, pz = p[:, 0][None, :], p[:, 1][None, :], p[:, 2][None, :]
    return tuple(
        R[:, i, 0][:, None] * px
        + R[:, i, 1][:, None] * py
        + R[:, i, 2][:, None] * pz
        + t[:, i][:, None]
        for i in range(3)
    )


def estimate_max_iterations(support, n_corr, confidence: float, n_samples: int):
    """Adaptive RANSAC budget (metric.cpp:103-123): supporting fraction / 4,
    iterations = log(1-conf)/log(1-frac^n), in float32 like the reference
    package.  support, n_corr: tensors; returns a float32 tensor."""
    support = torch.as_tensor(support)
    f32 = dict(dtype=torch.float32, device=support.device)
    n_corr = torch.as_tensor(n_corr, **f32)
    frac = support.to(torch.float32) / n_corr.clamp_min(1.0) / 4.0
    fn = frac**n_samples
    bad = (frac <= 0.0) | (fn >= 1.0)
    denom = torch.log((1.0 - fn).clamp_min(1e-38))
    iters = torch.log(torch.tensor(1.0 - confidence, **f32)) / denom.clamp_max(-1e-38)
    return torch.where(bad, torch.tensor(float(2**31 - 1), **f32), iters)


N_BINS = 100  # uniformity histogram resolution (src/analysis.cpp:15)


def uniformity_bins(p_src: torch.Tensor, bbox_lo: torch.Tensor, bbox_hi: torch.Tensor):
    """Per-correspondence 2D bin ids of the three projections
    (metrics.uniformity_bins, analysis.cpp:104-115): i64[3, M] for
    (y, z), (z, x), (x, y)."""
    rng = (bbox_hi - bbox_lo).clamp_min(1e-30)
    b = torch.floor((p_src - bbox_lo) / rng * N_BINS).clamp_max(N_BINS - 1.0)
    b = b.to(torch.int64).clamp_min(0)
    return torch.stack([b[:, 1] * N_BINS + b[:, 2], b[:, 2] * N_BINS + b[:, 0],
                        b[:, 0] * N_BINS + b[:, 1]])


def uniformity_entropy(mask: torch.Tensor, bins3: torch.Tensor) -> torch.Tensor:
    """Batched 3-axis projected entropy (metrics.uniformity_entropy,
    analysis.cpp:96-130): mask bool[B, M], bins3 i64[3, M] -> f32[B].  The
    batched bincount is one scatter_add_ over B x 100^2 bins per axis."""
    B, M = mask.shape
    w = mask.to(torch.float32)
    n = w.sum(1)
    nb2 = N_BINS * N_BINS
    log_bins = torch.log(torch.tensor(float(nb2), dtype=torch.float32, device=mask.device))
    prod = torch.ones((B,), dtype=torch.float32, device=mask.device)
    for bins in bins3:
        cnt = torch.zeros((B, nb2), dtype=torch.float32, device=mask.device)
        cnt.scatter_add_(1, bins[None, :].expand(B, M), w)
        p = cnt / n.clamp_min(1.0)[:, None]
        h = -torch.where(p > 0, p * torch.log(p.clamp_min(1e-30)), 0.0).sum(1)
        prod = prod * (h / log_bins)
    ent = prod.clamp_min(0.0).pow(1.0 / 3.0)
    return torch.where(n > 0, ent, 0.0)


# ---------------------------------------------------------------------------
# Correspondence inliers (CorrespondencesMetricEstimator, metric.cpp:125)
# ---------------------------------------------------------------------------
def corr_inlier_mask(R, t, p, q, thr, cvalid):
    """R f32[B, 3, 3], t f32[B, 3]; p, q f32[M, 3] -> (mask bool[B, M],
    dist f32[B, M]): inlier iff the moved p lies within its pair's thr."""
    tx, ty, tz = transform_points_soa(R, t, p)
    d2 = (tx - q[:, 0][None]) ** 2 + (ty - q[:, 1][None]) ** 2 + (tz - q[:, 2][None]) ** 2
    dist = d2.clamp_min(0.0).sqrt()
    return (dist < thr[None]) & cvalid[None], dist


def corr_metric(R, t, p, q, thr, cvalid, score_id: str):
    """metric = summed inlier score / number of correspondences; also the
    inlier count, the inliers' rmse (BIG without inliers), mask and dist."""
    mask, dist = corr_inlier_mask(R, t, p, q, thr, cvalid)
    sv = score_values(dist, thr[None], score_id)
    score = torch.where(mask, sv, 0.0).sum(1)
    n_corr = cvalid.to(torch.float32).sum().clamp_min(1.0)
    cnt = mask.sum(1)
    sq = torch.where(mask, dist * dist, 0.0).sum(1)
    rmse = torch.where(cnt > 0, (sq / cnt.clamp_min(1)).sqrt(), BIG)
    return score / n_corr, cnt, rmse, mask, dist


# ---------------------------------------------------------------------------
# Closest-plane inliers (buildClosestPlaneInliers, metric.cpp:10-53)
# ---------------------------------------------------------------------------
def closest_plane_metric(R, t, sample_xyz, sample_valid, tgt_xyz, tgt_valid, tgt_normal,
                         inlier_threshold: float, score_id: str, denom, weights=None):
    """Point-to-nearest-neighbour-plane scoring of B transforms x S samples:
    each moved sample takes its nearest target point within 2 x
    inlier_threshold (grid.nearest_within, exact) and is an inlier iff
    |n . (nn - p)| < inlier_threshold; a target normal of norm <= 0.5 falls
    back to the squared distance (metric.cpp:25-46).  `weights` (f32[S])
    scale each sample's score (the weighted metric).  Returns (metric
    f32[B], count i64[B], rmse f32[B])."""
    B, S = R.shape[0], sample_xyz.shape[0]
    tx, ty, tz = transform_points_soa(R, t, sample_xyz)
    tp = torch.stack([tx, ty, tz], -1)
    fvalid = sample_valid[None].expand(B, S).reshape(-1)
    radius = DIST_TO_PLANE_COEFFICIENT * inlier_threshold
    idx, dist, found = nearest_within(tgt_xyz, tgt_valid, tp.reshape(B * S, 3), fvalid,
                                      max(radius, 1e-12))
    nn = idx.reshape(B, S)
    found = found.reshape(B, S)
    npt, nnm = tgt_xyz[nn], tgt_normal[nn]
    d2p = (nnm * (npt - tp)).sum(-1).abs()
    nn_ok = (nnm * nnm).sum(-1) > 0.5
    d1 = dist.reshape(B, S)
    d2p = torch.where(nn_ok, d2p, d1 * d1)
    inlier = found & (d2p < inlier_threshold)
    sv = score_values(d2p, torch.full_like(d2p, inlier_threshold), score_id)
    if weights is not None:
        sv = sv * weights[None, :]
    score = torch.where(inlier, sv, 0.0).sum(1)
    cnt = inlier.sum(1)
    sq = torch.where(inlier, d2p * d2p, 0.0).sum(1)
    rmse = torch.where(cnt > 0, (sq / cnt.clamp_min(1)).sqrt(), BIG)
    return score / max(float(denom), 1e-30), cnt, rmse


@dataclass
class MetricContext:
    """What every hypothesis evaluation of one (src, tgt, correspondences)
    triple shares (metrics.MetricContext; a plain record here)."""

    metric_id: str
    score_id: str
    p: torch.Tensor  # f32[M, 3] source point of each correspondence
    q: torch.Tensor  # f32[M, 3] target point of each correspondence
    thr: torch.Tensor  # f32[M]
    cvalid: torch.Tensor  # bool[M]
    bins3: Optional[torch.Tensor] = None  # uniformity
    tgt_xyz: Optional[torch.Tensor] = None  # closest plane
    tgt_valid: Optional[torch.Tensor] = None
    tgt_normal: Optional[torch.Tensor] = None
    cp_threshold: float = 0.0
    sample_xyz: Optional[torch.Tensor] = None
    sample_valid: Optional[torch.Tensor] = None
    cp_denom: float = 1.0
    cp_weights: Optional[torch.Tensor] = None  # weighted closest plane, per sample

    def min_tolerable_metric(self) -> float:
        """metric.h: 0.3 for uniformity, 0 for the others."""
        return 0.3 if self.metric_id == METRIC_UNIFORMITY else 0.0


def evaluate(ctx: MetricContext, R: torch.Tensor, t: torch.Tensor) -> dict:
    """Score B hypotheses: metric[B], inliers[B], support[B] (the
    correspondence inliers, for the iteration budget), rmse[B] and the
    correspondence inlier mask corr_mask[B, M] (metrics.evaluate)."""
    metric_c, cnt_c, rmse_c, mask_c, _dist = corr_metric(R, t, ctx.p, ctx.q, ctx.thr,
                                                         ctx.cvalid, ctx.score_id)
    out = {"support": cnt_c, "corr_mask": mask_c}
    mid = ctx.metric_id

    if mid in (METRIC_CLOSEST_PLANE, METRIC_WEIGHTED_CLOSEST_PLANE, METRIC_COMBINATION):
        # the combination metric scores the samples unweighted
        m, cnt, rmse = closest_plane_metric(
            R, t, ctx.sample_xyz, ctx.sample_valid, ctx.tgt_xyz, ctx.tgt_valid, ctx.tgt_normal,
            ctx.cp_threshold, ctx.score_id, ctx.cp_denom,
            None if mid == METRIC_COMBINATION else ctx.cp_weights)
    if mid == METRIC_UNIFORMITY:
        ent = uniformity_entropy(mask_c, ctx.bins3)
        out.update(metric=torch.where(cnt_c > 0, ent, 0.0), inliers=cnt_c, rmse=rmse_c)
    elif mid in (METRIC_CLOSEST_PLANE, METRIC_WEIGHTED_CLOSEST_PLANE):
        out.update(metric=m, inliers=cnt, rmse=rmse)
    elif mid == METRIC_COMBINATION:
        # combination inliers come from the correspondence estimator
        # (metric.cpp:233-246)
        out.update(metric=metric_c * m, inliers=cnt_c, rmse=rmse_c)
    else:
        # correspondences; the reference falls back to it with a warning
        out.update(metric=metric_c, inliers=cnt_c, rmse=rmse_c)
    return out

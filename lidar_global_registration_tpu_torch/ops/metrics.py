"""The parts of lidar_global_registration_tpu/ops/metrics.py the RANSAC
stage reads: batched point transforms, the adaptive iteration budget and
the uniformity score."""
from __future__ import annotations

import torch


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

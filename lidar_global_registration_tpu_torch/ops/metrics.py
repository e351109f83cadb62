"""The parts of lidar_global_registration_tpu/ops/metrics.py the RANSAC
stage reads: batched point transforms and the adaptive iteration budget."""
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

"""Device-side sampler of the bench's box + mound scene
(__graft_entry__._synthetic_scene_pair_device).

The patch tables (ground square, five faces per box, hemispherical
mounds) are the numpy tables of __graft_entry__._scene_tables, passed in
by the caller; only they cross to the device, so a 10M-point pair is
sampled where it is used.  Same scene statistics as the JAX sampler, not
the same points (the two generators differ, and the JAX sampler is not
bit-identical to its host counterpart either).
"""
from __future__ import annotations

import math

import numpy as np
import torch

ANGLE = 0.4  # the pair's known rotation about z and translation
OFFSET = (2.0, -1.0, 0.5)
NOISE = 0.008  # scanner-like noise (m)


def _rotation() -> np.ndarray:
    c, s = math.cos(ANGLE), math.sin(ANGLE)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def patch_weights(tables, graded: bool) -> np.ndarray:
    """Sampling probability of each patch (flat patches, then mounds): its
    share of the area; graded, that share over 1 + (d / 15)^2 for the
    distance d of the patch's centre to a scanner at (2, 2), a range
    falloff that spreads the keypoints' feature radii over several octaves
    (the pyramid's regime; __graft_entry__.py:181-187)."""
    origins, eus, evs, m_c, _m_r, areas = (np.asarray(a, np.float64) for a in tables)
    weights = areas / areas.sum()
    if graded:
        centres = np.concatenate([origins[:, :2] + 0.5 * (eus[:, :2] + evs[:, :2]), m_c])
        dist = np.linalg.norm(centres - np.array([2.0, 2.0]), axis=1)
        weights = weights / (1.0 + (dist / 15.0) ** 2)
        weights = weights / weights.sum()
    return weights


def _sample(tables, weights, m: int, generator: torch.Generator, device) -> torch.Tensor:
    origins, eus, evs, m_c, m_r, _areas = (torch.as_tensor(np.asarray(a), device=device)
                                           for a in tables)
    n_flat = origins.shape[0]
    cdf = torch.cumsum(torch.as_tensor(weights, dtype=torch.float64, device=device), 0)
    u = torch.rand((m,), generator=generator, device=device, dtype=torch.float64)
    pid = torch.searchsorted(cdf, u, right=True).clamp_max(cdf.shape[0] - 1)
    uv = torch.rand((m, 2), generator=generator, device=device)
    f = pid.clamp_max(n_flat - 1)
    flat = origins[f] + uv[:, :1] * eus[f] + uv[:, 1:] * evs[f]
    mid = (pid - n_flat).clamp(0, m_r.shape[0] - 1)
    rr = m_r[mid]
    cen = m_c[mid]
    z = rr * uv[:, 0]
    rho = (rr * rr - z * z).clamp_min(0.0).sqrt()
    phi = 2.0 * math.pi * uv[:, 1]
    mound = torch.stack([cen[:, 0] + rho * torch.cos(phi), cen[:, 1] + rho * torch.sin(phi), z],
                        1)
    pts = torch.where((pid >= n_flat)[:, None], mound, flat)
    noise = torch.randn((m, 3), generator=generator, device=device)
    return pts + NOISE * noise


def scene_pair(tables, n: int, extent: float, seed: int, device, graded: bool = False):
    """The scene sampled twice (seeds seed + 10 and seed + 20), the second
    moved into its own frame b = (b_world - t) R; `graded` samples the
    patches with patch_weights' range falloff.  Returns (a f32[n, 3],
    b f32[n, 3], vp_a f32[3], vp_b f32[3], T_gt f32[4, 4]) with T_gt
    mapping a's frame onto b's, all on `device`."""
    out = []
    weights = patch_weights(tables, graded)
    for s in (seed + 10, seed + 20):
        g = torch.Generator(device=device).manual_seed(s)
        out.append(_sample(tables, weights, n, g, device))
    R = _rotation()
    t = np.array(OFFSET, np.float32)
    Rd = torch.from_numpy(R).to(device)
    a = out[0]
    b = (out[1] - torch.from_numpy(t).to(device)) @ Rd
    vp_a = np.array([extent / 2, extent / 2, 25.0], np.float32)
    vp_b = (R.T @ (vp_a - t)).astype(np.float32)
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3] = R.T
    T_gt[:3, 3] = -R.T @ t
    return (a, b, torch.from_numpy(vp_a).to(device), torch.from_numpy(vp_b).to(device),
            torch.from_numpy(T_gt).to(device))

"""RoPS-135 descriptors (Rotational Projection Statistics;
lidar_global_registration_tpu/ops/rops.py).

Reference: the fork of PCL that takes given LRFs (rops_custom_lrf.hpp,
common.h:348-392): 3 rotation axes x 3 angles x 3 projection planes x 5
statistics (the central moments m11, m12, m21, m22 and the Shannon entropy
of a 5 x 5 distribution matrix) = 135 values.  The reference builds its
frames on a greedy-projection mesh and weights each triangle's vote by its
area; the JAX package has no mesh: the frame is the SHOT LRF over the same
neighbours unless frames are given, and each neighbour votes with an area
proxy, 1 / (its count of surface points within r / 5).

The neighbours are the k_neighbors nearest surface points within r
(ops/grid.radius_neighbors, exact; the JAX package keeps 128 points a
cell).  The r / 5 counts are K2's (ops/cellgrid.radius_counts, self
included), clamped to density_k + 1, which is the JAX package's
self-excluded density_k-nearest count plus one.  The rest is plain
PyTorch, as it is XLA in JAX: per-coordinate [M, K] gathers, and each
5 x 5 matrix an `index_add_` (the JAX package's segment sum).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from lidar_global_registration_tpu_torch.ops import cellgrid, grid
from lidar_global_registration_tpu_torch.ops.lrf import shot_lrf

N_BINS = 5
N_ROTATIONS = 3
DIM = 3 * N_ROTATIONS * 3 * 5  # 135
BIG = 3.0e38
_SLOTS = 1 << 22  # keypoint x neighbour slots per block


def _rotation_stack() -> np.ndarray:
    """f32[9, 3, 3]: for each LRF axis (x, y, z) and each of N_ROTATIONS
    angles 2 pi (r + 1) / (N_ROTATIONS + 1), the rotation about that axis."""
    mats = []
    for axis in range(3):
        for r in range(N_ROTATIONS):
            theta = 2.0 * np.pi * (r + 1) / (N_ROTATIONS + 1)
            c, s = np.cos(theta), np.sin(theta)
            if axis == 0:
                m = [[1, 0, 0], [0, c, -s], [0, s, c]]
            elif axis == 1:
                m = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
            else:
                m = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
            mats.append(m)
    return np.array(mats, np.float32)


_ROTS = _rotation_stack()


def _distribution_stats(u, v, w_mask, weights, cnt):
    """The 5 statistics of one projection (rops._distribution_stats): u, v
    [M, K] plane coordinates binned 5 x 5 over their masked range, each
    neighbour adding its weight, the matrix divided by cnt f32[M].
    Returns f32[M, 5]."""
    M = u.shape[0]
    umin = torch.where(w_mask, u, BIG).amin(1, keepdim=True)
    umax = torch.where(w_mask, u, -BIG).amax(1, keepdim=True)
    vmin = torch.where(w_mask, v, BIG).amin(1, keepdim=True)
    vmax = torch.where(w_mask, v, -BIG).amax(1, keepdim=True)
    ub = torch.floor((u - umin) / (umax - umin).clamp_min(1e-30) * N_BINS).clamp(0, N_BINS - 1)
    vb = torch.floor((v - vmin) / (vmax - vmin).clamp_min(1e-30) * N_BINS).clamp(0, N_BINS - 1)
    cell = ub.long() * N_BINS + vb.long()
    rows = torch.arange(M, device=u.device)[:, None] * (N_BINS * N_BINS)
    dm = torch.zeros((M * N_BINS * N_BINS,), dtype=torch.float32, device=u.device)
    dm.index_add_(0, (rows + cell).reshape(-1), torch.where(w_mask, weights, 0.0).reshape(-1))
    dm = dm.reshape(M, N_BINS, N_BINS) / cnt[:, None, None]
    ii = torch.arange(N_BINS, dtype=torch.float32, device=u.device)
    ci = (dm * ii[None, :, None]).sum((1, 2))
    cj = (dm * ii[None, None, :]).sum((1, 2))
    di = ii[None, :, None] - ci[:, None, None]
    dj = ii[None, None, :] - cj[:, None, None]
    m11 = (dm * di * dj).sum((1, 2))
    m12 = (dm * di * dj * dj).sum((1, 2))
    m21 = (dm * di * di * dj).sum((1, 2))
    m22 = (dm * di * di * dj * dj).sum((1, 2))
    ent = -torch.where(dm > 0, dm * torch.log(dm.clamp_min(1e-30)), 0.0).sum((1, 2))
    return torch.stack([m11, m12, m21, m22, ent], -1)


def rops_from_neighbors(kp_xyz, frames, surface_xyz, idx, mask, weights=None):
    """Descriptors of the keypoints kp_xyz f32[M, 3] with frames
    f32[M, 3, 3] (rows x, y, z) over their neighbours idx i64[M, K] (mask
    bool[M, K]) of surface_xyz, each weighted by `weights` f32[M, K] (1 by
    default) (rops.rops_from_neighbors).  Returns f32[M, 135], ordered
    [rotation][projection][statistic] as the JAX package's."""
    d = [surface_xyz[:, c][idx] - kp_xyz[:, c][:, None] for c in range(3)]
    loc = [d[0] * frames[:, j, 0:1] + d[1] * frames[:, j, 1:2] + d[2] * frames[:, j, 2:3]
           for j in range(3)]
    if weights is None:
        weights = torch.ones(mask.shape, dtype=torch.float32, device=mask.device)
    cnt = torch.where(mask, weights, 0.0).sum(1).clamp_min(1e-30)
    per_proj = [[], [], []]
    for r in range(9):
        Rm = _ROTS[r]
        rot = [float(Rm[i, 0]) * loc[0] + float(Rm[i, 1]) * loc[1] + float(Rm[i, 2]) * loc[2]
               for i in range(3)]
        for p, (a, b) in enumerate(((1, 2), (0, 2), (0, 1))):
            per_proj[p].append(_distribution_stats(rot[a], rot[b], mask, weights, cnt))
    feats = [torch.stack(per_proj[p], 1) for p in range(3)]  # [M, 9, 5] each
    return torch.cat(feats, -1).reshape(kp_xyz.shape[0], DIM)


def density_weights(surface_xyz, surface_valid, radius: float, density_k: int) -> torch.Tensor:
    """Per surface row the count of surface points within radius / 5, self
    included, capped at density_k + 1 (the JAX package's self-excluded
    density_k-nearest count plus one), at least 1.  f32[N]."""
    counts = cellgrid.radius_counts(surface_xyz, surface_valid, radius / 5.0)
    return counts.clamp(1, density_k + 1).to(torch.float32)


def per_keypoint(kp_xyz, kp_valid, surface_xyz, surface_valid, radius: float, frames,
                 k_neighbors: int, dim: int, body):
    """The descriptor driver that RoPS and USC share: per block of
    keypoints the k_neighbors nearest surface points within radius
    (ops/grid.radius_neighbors, exact), the given frames or the SHOT LRF
    over them, then body(q, frames, idx, mask) -> f32[B, dim].  Returns
    (desc f32[M, dim], ok bool[M] = valid with at least 5 neighbours); desc
    is 0 where not ok."""
    dev = kp_xyz.device
    M = kp_xyz.shape[0]
    plan = cellgrid.plan_grid(surface_xyz, surface_valid, radius)
    desc = torch.zeros((M, dim), dtype=torch.float32, device=dev)
    ok = torch.zeros((M,), dtype=torch.bool, device=dev)
    rows = torch.nonzero(kp_valid).squeeze(1)
    step = max(1, _SLOTS // k_neighbors)
    for a in range(0, rows.shape[0], step):
        rr = rows[a:a + step]
        q = kp_xyz[rr]
        idx, _dist, mask = grid.radius_neighbors(plan, q, torch.ones_like(rr, dtype=torch.bool),
                                                 radius, k_neighbors)
        fr = shot_lrf(q, radius, surface_xyz, idx, mask)[0] if frames is None else frames[rr]
        okb = mask.sum(1) >= 5
        desc[rr] = torch.where(okb[:, None], body(q, fr, idx, mask), 0.0)
        ok[rr] = okb
    return desc, ok


def rops(kp_xyz, kp_valid, surface_xyz, surface_valid, radius, frames=None,
         k_neighbors: int = 384, density_k: int = 48, area_weighting: bool = True):
    """RoPS-135 of the keypoints kp_xyz f32[M, 3] (kp_valid bool[M]) over
    the surface within `radius` (rops.rops): the k_neighbors nearest
    surface points within r, the given frames or the SHOT LRF over them,
    each neighbour weighted by 1 / its r / 5 count (area_weighting).
    Returns (desc f32[M, 135], ok bool[M] = valid with at least 5
    neighbours); desc is 0 where not ok."""
    radius = float(radius)
    counts = (density_weights(surface_xyz, surface_valid, radius, density_k)
              if area_weighting else None)

    def body(q, fr, idx, mask):
        w = None if counts is None else 1.0 / counts[idx]
        return rops_from_neighbors(q, fr, surface_xyz, idx, mask, w)

    return per_keypoint(kp_xyz, kp_valid, surface_xyz, surface_valid, radius, frames,
                        k_neighbors, DIM, body)

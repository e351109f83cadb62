"""USC-1960 descriptors (Unique Shape Context;
lidar_global_registration_tpu/ops/usc.py).

Reference: estimateFeatures<USC> -> pcl::UniqueShapeContext1960 with
minimal_radius = r / 10, point_density_radius = r / 5, local_radius = r
(include/common.h:334-346).  10 radial shells (logarithmic from r / 10,
closer neighbours in the first), 14 elevation and 14 azimuth bins (linear,
against the frame's z and x), each neighbour adding 1 / (its density x
cbrt(its bin's volume)), the density being its count of surface points
within r / 5, itself included.  The layout is azimuth-major (PCL's
v_index), and the histogram is not normalised.

The neighbours are the k_neighbors nearest surface points within r
(ops/rops.per_keypoint, exact; the JAX package keeps 128 points a cell);
the r / 5 counts are ops/rops.density_weights' (K2, clamped to the
JAX package's density_k + 1).  The histogram is plain PyTorch, one
`index_add_` into [M * 1960] (the JAX package's segment sum).  torch has
no cbrt: x^(1/3) by `pow`, which may differ from jnp.cbrt in the last bit.
"""
from __future__ import annotations

import math

import torch

from lidar_global_registration_tpu_torch.ops.rops import density_weights, per_keypoint

N_RAD = 10
N_ELEV = 14
N_AZIM = 14
DIM = N_RAD * N_ELEV * N_AZIM  # 1960


def bin_index(rb, eb, ab):
    """PCL's v_index: azimuth-major, then elevation, then radius."""
    return (ab * N_ELEV + eb) * N_RAD + rb


def _bin_volumes(radius: torch.Tensor) -> torch.Tensor:
    """The Frome bin volumes in PCL order, f32[1960] (usc.py:102-108)."""
    dev = radius.device
    r_min = radius / 10.0
    edges = r_min * (radius / r_min) ** (torch.arange(N_RAD + 1, dtype=torch.float32,
                                                      device=dev) / N_RAD)
    el_edges = torch.arange(N_ELEV + 1, dtype=torch.float32, device=dev) / N_ELEV * math.pi
    shell_vol = (edges[1:] ** 3 - edges[:-1] ** 3) / 3.0
    band = torch.cos(el_edges[:-1]) - torch.cos(el_edges[1:])
    vol_ker = shell_vol[None, :] * band[:, None] * (2 * math.pi / N_AZIM)  # [E, R]
    return vol_ker.reshape(-1).repeat(N_AZIM)


def usc_from_neighbors(kp_xyz, frames, surface_xyz, idx, mask, nb_density, radius):
    """Raw USC-1960 of the keypoints kp_xyz f32[M, 3] with frames
    f32[M, 3, 3] (rows x, y, z) over their neighbours idx i64[M, K] (mask
    bool[M, K]) of surface_xyz, nb_density f32[M, K] each neighbour's r / 5
    count (usc.usc_from_neighbors).  Returns f32[M, 1960]."""
    M = mask.shape[0]
    dev = kp_xyz.device
    radius = torch.as_tensor(radius, dtype=torch.float32, device=dev)
    r_min = radius / 10.0
    d = [surface_xyz[:, c][idx] - kp_xyz[:, c][:, None] for c in range(3)]
    loc = [d[0] * frames[:, j, 0:1] + d[1] * frames[:, j, 1:2] + d[2] * frames[:, j, 2:3]
           for j in range(3)]
    dist = (loc[0] ** 2 + loc[1] ** 2 + loc[2] ** 2).clamp_min(0.0).sqrt()
    use = mask & (dist > 1e-12) & (dist <= radius)
    logr = torch.log(dist.clamp_min(1e-30) / r_min) / torch.log(radius / r_min)
    rb = torch.floor(logr * N_RAD).clamp(0, N_RAD - 1).long()
    cosel = (loc[2] / dist.clamp_min(1e-30)).clamp(-1.0, 1.0)
    eb = torch.floor(torch.arccos(cosel) / math.pi * N_ELEV).clamp(0, N_ELEV - 1).long()
    az = torch.remainder(torch.atan2(loc[1], loc[0]) + 2 * math.pi, 2 * math.pi)
    ab = torch.floor(az / (2 * math.pi) * N_AZIM).clamp(0, N_AZIM - 1).long()
    cell = bin_index(rb, eb, ab)
    vol = _bin_volumes(radius)
    w = torch.where(nb_density > 0, 1.0 / (nb_density.clamp_min(1e-30)
                                           * torch.pow(vol[cell].clamp_min(1e-30), 1.0 / 3.0)),
                    0.0)
    w = torch.where(use, w, 0.0)
    rows = torch.arange(M, device=dev)[:, None] * DIM
    desc = torch.zeros((M * DIM,), dtype=torch.float32, device=dev)
    desc.index_add_(0, (rows + cell).reshape(-1), w.reshape(-1))
    return desc.reshape(M, DIM)


def usc(kp_xyz, kp_valid, surface_xyz, surface_valid, radius, frames=None,
        k_neighbors: int = 384, density_k: int = 48):
    """USC-1960 of the keypoints kp_xyz f32[M, 3] (kp_valid bool[M]) over
    the surface within `radius` (usc.usc): the k_neighbors nearest surface
    points within r, the given frames or the SHOT LRF over them, each
    neighbour weighted by its r / 5 count.  Returns (desc f32[M, 1960],
    ok bool[M] = valid with at least 5 neighbours); desc is 0 where not
    ok."""
    radius = float(radius)
    counts = density_weights(surface_xyz, surface_valid, radius, density_k)
    return per_keypoint(
        kp_xyz, kp_valid, surface_xyz, surface_valid, radius, frames, k_neighbors, DIM,
        lambda q, fr, idx, mask: usc_from_neighbors(q, fr, surface_xyz, idx, mask, counts[idx],
                                                    radius))

"""SHOT-352 descriptors with quadrilinear interpolation
(lidar_global_registration_tpu/ops/shot.py; the reference's fork of
pcl::SHOTEstimationOMP, shot_debug.cpp:24-219).

Per keypoint with a local reference frame (rows x, y, z), every neighbour
within the radius votes into one of 32 volumes (8 azimuth sectors x 2
elevation halves x 2 radial shells) x 11 shape bins of the cosine between
its normal and z, with interpolation towards the adjacent bin, shell,
elevation half and sector; fewer than 5 neighbours give an invalid
descriptor; the histogram is L2-normalised.

Plain PyTorch, as the JAX package's is XLA (no Pallas kernel): neighbours
come as [M, K] index lists from ops/grid.py, every gathered quantity is a
per-coordinate [M, K] tensor, and each of the five interpolation
contributions is its own `index_add_` into [M * 352] (the JAX package's
segment-sum lowering; its one-hot MXU form is a TPU device).
"""
from __future__ import annotations

import math

import torch

from lidar_global_registration_tpu_torch.ops import cellgrid, grid
from lidar_global_registration_tpu_torch.ops import lrf as lrfmod

NR_BINS = 10  # shape bins per volume
NR_VOLUMES = 32
DIM = NR_VOLUMES * (NR_BINS + 1)  # 352
MAX_ANGULAR = 32
MIN_NEIGHBORS = 5
_CORE_SLOTS = 1 << 24  # neighbour slots (rows x K) per block of the LRF + histogram


def _f32(radius, device) -> torch.Tensor:
    return torch.as_tensor(radius, dtype=torch.float32, device=device)


def _gather(surface_xyz, surface_normal, kp_xyz, idx):
    """Per-coordinate neighbour offsets, normals and distances, [M, K] each."""
    d = [surface_xyz[:, c][idx] - kp_xyz[:, c][:, None] for c in range(3)]
    nn = [surface_normal[:, c][idx] for c in range(3)]
    dist = (d[0] ** 2 + d[1] ** 2 + d[2] ** 2).clamp_min(0.0).sqrt()
    return d, nn, dist


def shot_from_neighbors(kp_xyz, kp_frames, surface_xyz, surface_normal, idx, mask, radius):
    """Descriptors of the keypoints kp_xyz f32[M, 3] with frames
    f32[M, 3, 3] over the neighbours idx i64[M, K] (mask bool[M, K]) of
    the surface arrays (shot.shot_from_neighbors).  Returns (desc
    f32[M, 352], ok bool[M])."""
    d, nn, dist = _gather(surface_xyz, surface_normal, kp_xyz, idx)
    return _shot_hist(kp_frames, d, nn, dist, mask, _f32(radius, kp_xyz.device))


def _shot_hist(kp_frames, d, nn, dist, mask, radius):
    """The quadrilinear SHOT histogram from per-coordinate neighbour
    offsets d and normals nn (3 x f32[M, K]) (shot._shot_hist, the scatter
    lowering).  radius: f32 scalar tensor."""
    M = mask.shape[0]
    pi = math.pi

    def proj(axis_row):
        ax = kp_frames[:, axis_row, :]
        return d[0] * ax[:, 0:1] + d[1] * ax[:, 1:2] + d[2] * ax[:, 2:3]

    xr, yr, zr = proj(0), proj(1), proj(2)
    zax = kp_frames[:, 2, :]
    cos_desc = (nn[0] * zax[:, 0:1] + nn[1] * zax[:, 1:2] + nn[2] * zax[:, 2:3]).clamp(-1.0, 1.0)
    nrm_ok = (nn[0] ** 2 + nn[1] ** 2 + nn[2] ** 2) > 0.5
    bin_dist = (1.0 + cos_desc) * NR_BINS / 2.0
    use = mask & (dist > 1e-12) & nrm_ok

    # PCL zeroes tiny components before the sign logic
    xr = torch.where(xr.abs() < 1e-30, 0.0, xr)
    yr = torch.where(yr.abs() < 1e-30, 0.0, yr)
    zr = torch.where(zr.abs() < 1e-30, 0.0, zr)

    bit4 = ((yr > 0) | ((yr == 0.0) & (xr < 0))).to(torch.int64)
    bit3 = torch.where((xr > 0) | ((xr == 0.0) & (yr > 0)), 1 - bit4, bit4)
    desc_index = ((bit4 << 3) + (bit3 << 2)) << 1
    quad = torch.where((xr * yr > 0) | (xr == 0.0),
                       torch.where(xr.abs() >= yr.abs(), 0, 4),
                       torch.where(xr.abs() > yr.abs(), 4, 0))
    desc_index = desc_index + quad + (zr > 0).to(torch.int64)
    radius1_2 = radius / 2.0
    radius3_4 = radius * 3.0 / 4.0
    radius1_4 = radius / 4.0
    outer = dist > radius1_2
    desc_index = desc_index + torch.where(outer, 2, 0)

    step_index = torch.floor(bin_dist + 0.5).to(torch.int64)
    frac = bin_dist - step_index
    volume_index = desc_index * (NR_BINS + 1)
    int_weight = 1.0 - frac.abs()

    # shape-bin interpolation (adjacent bins, modular)
    bin_up = volume_index + (step_index + 1) % NR_BINS
    bin_dn = volume_index + (step_index - 1 + NR_BINS) % NR_BINS
    binterp_idx = torch.where(frac > 0, bin_up, bin_dn)
    binterp_val = frac.abs()

    # radial (shell) interpolation
    rd_out = (dist - radius3_4) / radius1_2
    rd_in = (dist - radius1_4) / radius1_2
    w_out = torch.where(dist > radius3_4, 1.0 - rd_out, 1.0 + rd_out)
    w_in = torch.where(dist < radius1_4, 1.0 + rd_in, 1.0 - rd_in)
    int_weight = int_weight + torch.where(outer, w_out, w_in)
    rinterp_idx = torch.where(outer, (desc_index - 2) * (NR_BINS + 1) + step_index,
                              (desc_index + 2) * (NR_BINS + 1) + step_index)
    rinterp_val = torch.where(outer, -rd_out, rd_in)
    r_has = torch.where(outer, ~(dist > radius3_4), ~(dist < radius1_4))
    rinterp_val = torch.where(r_has, rinterp_val, 0.0)

    # elevation interpolation
    incl = torch.acos((zr / dist.clamp_min(1e-30)).clamp(-1.0, 1.0))
    lower = (incl > pi / 2) | (((incl - pi / 2).abs() < 1e-30) & (zr <= 0))
    id_lo = (incl - 3.0 * pi / 4.0) / (pi / 2.0)
    id_hi = (incl - pi / 4.0) / (pi / 2.0)
    w_lo = torch.where(incl > 3.0 * pi / 4.0, 1.0 - id_lo, 1.0 + id_lo)
    w_hi = torch.where(incl < pi / 4.0, 1.0 + id_hi, 1.0 - id_hi)
    int_weight = int_weight + torch.where(lower, w_lo, w_hi)
    einterp_idx = torch.where(lower, (desc_index + 1) * (NR_BINS + 1) + step_index,
                              (desc_index - 1) * (NR_BINS + 1) + step_index)
    einterp_val = torch.where(lower, -id_lo, id_hi)
    e_has = torch.where(lower, ~(incl > 3.0 * pi / 4.0), ~(incl < pi / 4.0))
    einterp_val = torch.where(e_has, einterp_val, 0.0)

    # azimuth interpolation
    has_az = (yr != 0.0) | (xr != 0.0)
    azimuth = torch.atan2(yr, xr)
    sector_span = pi / 4.0
    az_d = (azimuth - (-pi * 7.0 / 8.0 + sector_span * (desc_index >> 2))) / sector_span
    az_d = az_d.clamp(-0.5, 0.5)
    az_pos = az_d > 0
    a_nb = torch.where(az_pos, (desc_index + 4) % MAX_ANGULAR,
                       (desc_index - 4 + MAX_ANGULAR) % MAX_ANGULAR)
    ainterp_idx = a_nb * (NR_BINS + 1) + step_index
    ainterp_val = torch.where(has_az, torch.where(az_pos, az_d, -az_d), 0.0)
    int_weight = int_weight + torch.where(has_az, 1.0 - az_d.abs(), 0.0)

    ways = (
        (volume_index + step_index, int_weight),
        (binterp_idx, binterp_val),
        (rinterp_idx, rinterp_val),
        (einterp_idx, einterp_val),
        (ainterp_idx, ainterp_val),
    )
    rows = torch.arange(M, device=mask.device)[:, None]
    desc = torch.zeros((M * DIM,), dtype=torch.float32, device=mask.device)
    for tgt_idx, val in ways:
        # each contribution summed on its own, then added, as the JAX
        # package's per-contribution segment sums
        flat = (rows * DIM + tgt_idx.clamp(0, DIM - 1)).reshape(-1)
        part = torch.zeros_like(desc).index_add_(0, flat, torch.where(use, val, 0.0).reshape(-1))
        desc = desc + part
    desc = desc.view(M, DIM)
    ok = (mask & (dist > 1e-12)).sum(1) >= MIN_NEIGHBORS
    norm = (desc * desc).sum(1, keepdim=True).clamp_min(1e-30).sqrt()
    return torch.where(ok[:, None], desc / norm, 0.0), ok


def _shot_core(kp_xyz, surface_xyz, surface_normal, idx, mask, radius, frames, fallback_mask,
               frames_mode: str):
    """LRF + histogram over one neighbour block (shot._shot_core): the
    [M, K] gathers are shared by the SHOT-LRF and the histogram.
    frames_mode 'lrf' (SHOT LRF), 'blend' (the given frames, with the
    SHOT LRF at fallback_mask rows) or 'given'.  Returns (desc, ok)."""
    d, nn, dist = _gather(surface_xyz, surface_normal, kp_xyz, idx)
    frames_ok = torch.ones((kp_xyz.shape[0],), dtype=torch.bool, device=kp_xyz.device)
    if frames_mode in ("lrf", "blend"):
        fb, fb_ok = lrfmod.shot_lrf(kp_xyz, radius, surface_xyz, idx, mask, diffs=d, dist=dist)
        if frames_mode == "lrf":
            frames, frames_ok = fb, fb_ok
        else:
            frames = torch.where(fallback_mask[:, None, None], fb, frames)
            frames_ok = torch.where(fallback_mask, fb_ok, True)
    desc, ok = _shot_hist(frames, d, nn, dist, mask, radius)
    ok = ok & frames_ok
    return torch.where(ok[:, None], desc, 0.0), ok


def shot(kp_xyz, kp_valid, surface_xyz, surface_normal, surface_valid, radius, frames=None,
         k_neighbors: int = 512, fallback_mask=None, plan=None):
    """SHOT-352 of the keypoints kp_xyz f32[M, 3] (kp_valid bool[M]) over
    the support surface (xyz, normals, validity in input order) within
    `radius` (shot.shot): the k_neighbors nearest support points within r
    (ops/grid.py, exact), then the frames and the histogram.  frames
    (f32[M, 3, 3], e.g. gravity frames) replaces the SHOT LRF; with
    fallback_mask (bool[M]) those rows take the SHOT LRF over the same
    neighbours.  `plan`: a plan of the support cloud whose
    cell holds the radius, reused instead of planning one.  Only the valid
    keypoints are computed.  Returns (desc f32[M, 352], ok bool[M]); desc
    is 0 where ok is False."""
    dev = kp_xyz.device
    M = kp_xyz.shape[0]
    if plan is None:
        plan = cellgrid.plan_grid(surface_xyz, surface_valid, radius)
    mode = "lrf" if frames is None else ("blend" if fallback_mask is not None else "given")
    r = _f32(radius, dev)
    desc = torch.zeros((M, DIM), dtype=torch.float32, device=dev)
    ok = torch.zeros((M,), dtype=torch.bool, device=dev)
    rows = torch.nonzero(kp_valid).squeeze(1)
    q = kp_xyz[rows]
    qv = torch.ones((rows.shape[0],), dtype=torch.bool, device=dev)
    # per block of rows, the query walks the plan in chunks, then the LRF +
    # histogram (a few hundred elementwise ops) runs once over the block
    step = max(1, _CORE_SLOTS // k_neighbors)
    for a in range(0, rows.shape[0], step):
        rr = rows[a:a + step]
        idx, _dist, mask = grid.radius_neighbors(plan, q[a:a + step], qv[a:a + step],
                                                 float(radius), k_neighbors)
        desc[rr], ok[rr] = _shot_core(
            q[a:a + step], surface_xyz, surface_normal, idx, mask, r,
            None if frames is None else frames[rr],
            None if fallback_mask is None else fallback_mask[rr], mode)
    return desc, ok

"""Local reference frames for SHOT (lidar_global_registration_tpu/ops/lrf.py;
the reference's estimateReferenceFrames, common.cpp:693-755).

  'default': the SHOT LRF (pcl::SHOTLocalReferenceFrameEstimation);
  'gravity': z = the point's normal, y = gravity x z, x = y x z, with the
             SHOT LRF where the normal lies within 0.04 rad of gravity;
  'gt':      one constant frame, the axes turned by inv(R_gt).

Frames are f32[M, 3, 3] with rows (x, y, z).
"""
from __future__ import annotations

import numpy as np
import torch

from lidar_global_registration_tpu_torch.ops.eigen3 import _cross, eigh_sym3

RF_MIN_ANGLE_RAD = 0.04  # common.cpp:21


def shot_lrf(xyz_q, radius, xyz_all, idx, mask, diffs=None, dist=None):
    """SHOT LRFs of the queries xyz_q f32[M, 3] over their neighbours
    (idx i64[M, K] rows of xyz_all, mask bool[M, K]) (lrf.shot_lrf): the
    (r - d)-weighted covariance of the offsets, x = its largest and z its
    smallest eigenvector, each turned towards the side holding more
    neighbours, y = z x x.  `diffs` (3 per-coordinate offsets f32[M, K])
    and `dist` reuse a caller's gathers.  Returns (frames f32[M, 3, 3],
    ok bool[M] = some neighbour has weight)."""
    if diffs is None:
        diffs = [xyz_all[:, c][idx] - xyz_q[:, c][:, None] for c in range(3)]
    if dist is None:
        dist = (diffs[0] ** 2 + diffs[1] ** 2 + diffs[2] ** 2).clamp_min(0.0).sqrt()
    w = torch.where(mask, (radius - dist).clamp_min(0.0), 0.0)
    wsum = w.sum(1)
    c = {}
    for i in range(3):
        for j in range(i, 3):
            c[i, j] = c[j, i] = (w * diffs[i] * diffs[j]).sum(1)
    cov = torch.stack([torch.stack([c[i, j] for j in range(3)], -1) for i in range(3)], -2)
    cov = cov / wsum.clamp_min(1e-30)[:, None, None]
    _eig, V = eigh_sym3(cov)  # ascending: column 0 smallest
    x = V[..., :, 2]
    z = V[..., :, 0]
    proj_x = diffs[0] * x[:, 0:1] + diffs[1] * x[:, 1:2] + diffs[2] * x[:, 2:3]
    proj_z = diffs[0] * z[:, 0:1] + diffs[1] * z[:, 1:2] + diffs[2] * z[:, 2:3]
    px = torch.where(mask, torch.sign(proj_x), 0.0).sum(1)
    pz = torch.where(mask, torch.sign(proj_z), 0.0).sum(1)
    x = torch.where((px < 0)[:, None], -x, x)
    z = torch.where((pz < 0)[:, None], -z, z)
    return torch.stack([x, _cross(z, x), z], 1), wsum > 0


def gravity_lrf(normals: torch.Tensor, gravity=None):
    """Gravity-aligned frames (lrf.gravity_lrf, common.cpp:712-734):
    (frames f32[M, 3, 3], needs_fallback bool[M] where the normal lies
    within RF_MIN_ANGLE_RAD of gravity).  The axes are normalised."""
    if gravity is None:
        gravity = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=normals.device)
    z = normals
    cosang = (z * gravity[None, :]).sum(-1).abs().clamp(0.0, 1.0)
    needs_fallback = torch.acos(cosang) <= RF_MIN_ANGLE_RAD
    y = _cross(gravity.expand_as(z), z)
    y = y / (y * y).sum(-1, keepdim=True).clamp_min(1e-30).sqrt()
    x = _cross(y, z)
    x = x / (x * x).sum(-1, keepdim=True).clamp_min(1e-30).sqrt()
    return torch.stack([x, y, z], 1), needs_fallback


def gt_lrf(n: int, ground_truth, device) -> torch.Tensor:
    """The ground-truth frame (lrf.gt_lrf, common.cpp:697-711): the axes of
    inv(R_gt) (its columns, the reference's x, y, z) as the rows of one
    frame, repeated for n points.  The float32 inverse is taken on the host
    (a 3 x 3 solve), as the JAX package's is.  Returns f32[n, 3, 3]."""
    R = np.asarray(ground_truth, np.float32)[:3, :3]
    frame = torch.from_numpy(np.ascontiguousarray(np.linalg.inv(R).T)).to(device)
    return frame[None].expand(n, 3, 3).contiguous()

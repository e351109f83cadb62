"""ISS keypoint detection (lidar_global_registration_tpu/ops/iss.py).

Reference: common.cpp:657-691 configures pcl::ISSKeypoint3D with salient =
non-max radius = iss_radius, gamma21 = gamma32 = 0.975, min_neighbors = 4:
the 1/count-weighted scatter of each point's neighbourhood, saliency = its
smallest eigenvalue where both eigenvalue ratios pass the gammas, keypoint
iff the saliency is a strict local maximum over at least min_neighbors
neighbours.

This is the JAX package's accelerator route: one cell-list plan at the ISS
radius, then K2 (count), K3 (saliency) and K4 (non-maximum suppression) of
ops/cellgrid.iss_pass, the CUDA kernels on a CUDA tensor and their plain
versions on a CPU tensor.  The JAX package's XLA fallback keeps at most 32
points a cell and 64 neighbours a point; the kernels keep every neighbour,
as the reference's radius search does.
"""
from __future__ import annotations

import torch

from lidar_global_registration_tpu_torch.ops import cellgrid
from lidar_global_registration_tpu_torch.types import KEYPOINT_ISS, Cloud


def iss_keypoints(cloud: Cloud, iss_radius: float, gamma21: float = 0.975,
                  gamma32: float = 0.975, min_neighbors: int = 4):
    """(is_keypoint bool[N], saliency f32[N]) in the cloud's row order,
    False / 0 at invalid rows (iss.iss_keypoints)."""
    plan = cellgrid.plan_grid(cloud.xyz, cloud.valid, iss_radius)
    return cellgrid.iss_pass(plan, iss_radius, gamma21, gamma32, min_neighbors)


def detect_keypoints(cloud: Cloud, keypoint_id: str, iss_radius: float) -> torch.Tensor:
    """detectKeyPoints (common.cpp:657-691): the ISS keypoints for 'iss',
    every valid row otherwise.  Returns the rows i64[M], ascending (the
    reference's order under fix_seed, common.cpp:674-676), on the cloud's
    device."""
    keep = cloud.valid
    if keypoint_id == KEYPOINT_ISS:
        keep = iss_keypoints(cloud, iss_radius)[0] & keep
    return torch.nonzero(keep).squeeze(1)


def subvoxel_iss_keypoints(cloud: Cloud, iss_radius: float, max_keypoints: int = 10):
    """ISS keypoints refined to sub-voxel positions by the quadric fit of
    their saliencies (iss.subvoxel_iss_keypoints; iss_debug.cpp:171-219 +
    quadric.cpp): the first max_keypoints sorted keypoints, each with its 6
    nearest points of the cloud (itself included; exact, ops/grid.knn) and
    the PCA normal of those 6.  Returns (refined f32[n, 3], rows i64[n],
    ok bool[n]) on the cloud's device."""
    from lidar_global_registration_tpu_torch.ops.grid import knn
    from lidar_global_registration_tpu_torch.ops.normals import normals_from_neighbors
    from lidar_global_registration_tpu_torch.ops.quadric import subvoxel_keypoints

    is_kp, saliency = iss_keypoints(cloud, iss_radius)
    rows = torch.nonzero(is_kp & cloud.valid).squeeze(1)[:max_keypoints]
    kp_xyz = cloud.xyz[rows]
    nidx, _dist, nmask = knn(cloud.xyz, cloud.valid, 6, queries=kp_xyz)
    normal, _c, _ok = normals_from_neighbors(kp_xyz, cloud.xyz, nidx, nmask)
    refined, ok = subvoxel_keypoints(kp_xyz, normal, cloud.xyz[nidx], saliency[nidx], nmask,
                                     iss_radius)
    return refined, rows, ok

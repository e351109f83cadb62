"""Quadric saliency fitting for sub-voxel keypoint refinement
(lidar_global_registration_tpu/ops/quadric.py).

Reference: src/quadric.cpp + ISSKeypoint3DDebug::estimateSubVoxelKeyPoints
(src/pcl/iss_debug.cpp:171-219): fit z = a x^2 + b xy + c y^2 + d x + e y + f
to the ISS third-eigenvalue saliencies of a keypoint's 6 nearest neighbours
in a normal-aligned frame, take the analytic maximum of the paraboloid, and
accept it if it stays within the salient radius.

Plain PyTorch in float32, as the JAX package computes it in XLA: the
rotation is a batched Rodrigues rotation, the least-squares fit a batched
6x6 normal-equations solve (torch.linalg.solve).
"""
from __future__ import annotations

import torch

MIN_ANGLE = 0.04  # quadric.cpp:8


def rotation_to_align_z(normals: torch.Tensor) -> torch.Tensor:
    """calculateRotationToAlignZAxis (quadric.cpp:124-131), batched.

    Returns R f32[..., 3, 3] = AngleAxis(angle(z, n), z x n), the rotation
    that maps +z onto the normal (the identity when they are within
    MIN_ANGLE).  The caller rotates points by R for the planar fit and maps
    the result back with R^T, as the reference does."""
    n = normals / torch.linalg.vector_norm(normals, dim=-1, keepdim=True).clamp_min(1e-30)
    z = torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype, device=n.device).expand(n.shape)
    c = (n * z).sum(-1).clamp(-1.0, 1.0)
    angle = torch.arccos(c)
    axis = torch.linalg.cross(z, n, dim=-1)
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True).clamp_min(1e-30)
    ca = torch.cos(angle)[..., None, None]
    sa = torch.sin(angle)[..., None, None]
    zz = torch.zeros_like(axis[..., 0])
    K = torch.stack([
        torch.stack([zz, -axis[..., 2], axis[..., 1]], -1),
        torch.stack([axis[..., 2], zz, -axis[..., 0]], -1),
        torch.stack([-axis[..., 1], axis[..., 0], zz], -1),
    ], -2)
    eye = torch.eye(3, dtype=n.dtype, device=n.device).expand(K.shape)
    outer = axis[..., :, None] * axis[..., None, :]
    R = ca * eye + sa * K + (1.0 - ca) * outer
    near = (angle.abs() < MIN_ANGLE)[..., None, None]
    return torch.where(near, eye, R)


def fit_quadric_2d(xs, ys, values, mask):
    """Least-squares coefficients of z = a x^2 + b xy + c y^2 + d x + e y + f
    over the masked samples, with a 1e-8 ridge on the normal equations.

    xs / ys / values / mask: [..., K].  Returns coefs f32[..., 6]."""
    one = torch.ones_like(xs)
    A = torch.stack([xs * xs, xs * ys, ys * ys, xs, ys, one], -1)  # [..., K, 6]
    Aw = A * mask.to(xs.dtype)[..., None]
    AtA = torch.einsum("...ki,...kj->...ij", Aw, A)
    Atb = torch.einsum("...ki,...k->...i", Aw, values)
    AtA = AtA + 1e-8 * torch.eye(6, dtype=xs.dtype, device=xs.device)
    return torch.linalg.solve(AtA, Atb[..., None])[..., 0]


def quadric_maximum(coefs):
    """Analytic stationary point of the paraboloid (quadric.cpp:88-95).

    Returns ((x, y) f32[..., 2], ok bool[...]): ok where the 2x2 system's
    determinant is not 0 (|det| > 1e-20)."""
    a, b, c, d, e = (coefs[..., i] for i in range(5))
    det = 4.0 * a * c - b * b
    ok = det.abs() > 1e-20
    safe = torch.where(ok, det, 1.0)
    x = (-2.0 * c * d + b * e) / safe
    y = (-2.0 * a * e + b * d) / safe
    return torch.stack([x, y], -1), ok


def subvoxel_keypoints(kp_xyz, kp_normal, nb_xyz, nb_saliency, nb_mask, salient_radius: float):
    """estimateSubVoxelKeyPoints, batched over keypoints.

    kp_xyz f32[M, 3], kp_normal f32[M, 3]; nb_xyz f32[M, K, 3] the
    keypoint's nearest neighbours (K >= 6), nb_saliency f32[M, K] their ISS
    saliencies, nb_mask bool[M, K].  Returns (refined f32[M, 3], ok
    bool[M]): the refined positions, and ok = False (the keypoint's own
    position kept) where the paraboloid has no maximum, its maximum lies
    outside the neighbours' extent about the most salient neighbour, or the
    refined point is not within salient_radius of the keypoint."""
    R = rotation_to_align_z(kp_normal)  # [M, 3, 3]
    rot = torch.einsum("mij,mkj->mki", R, nb_xyz)
    xs, ys, zs = rot[..., 0], rot[..., 1], rot[..., 2]
    coefs = fit_quadric_2d(xs, ys, nb_saliency, nb_mask)
    mx, ok2 = quadric_maximum(coefs)
    # radius guard in the rotated plane about the most salient neighbour
    # (placeCenterAtBeginning + estimateRadius)
    anchor = torch.argmax(torch.where(nb_mask, nb_saliency, -3.0e38), -1)
    ax = xs.gather(1, anchor[:, None])[:, 0]
    ay = ys.gather(1, anchor[:, None])[:, 0]
    rad2 = torch.where(nb_mask, (xs - ax[:, None]) ** 2 + (ys - ay[:, None]) ** 2, 0.0).amax(-1)
    inside = (mx[:, 0] - ax) ** 2 + (mx[:, 1] - ay) ** 2 < rad2
    # the height at the maximum from a quadric fit of the neighbours' z
    a, b, c, d, e, f = (fit_quadric_2d(xs, ys, zs, nb_mask)[..., i] for i in range(6))
    x, y = mx[:, 0], mx[:, 1]
    z = a * x ** 2 + b * x * y + c * y ** 2 + d * x + e * y + f
    refined = torch.einsum("mji,mj->mi", R, torch.stack([x, y, z], -1))  # R^T local
    close = torch.linalg.vector_norm(refined - kp_xyz, dim=-1) < salient_radius
    ok = ok2 & inside & close
    return torch.where(ok[:, None], refined, kp_xyz), ok

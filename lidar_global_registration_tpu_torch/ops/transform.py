"""Rigid-transform estimation (lidar_global_registration_tpu/ops/transform.py).

Horn's quaternion method: the optimal rotation is the eigenvector of the
largest eigenvalue of a 4x4 symmetric matrix built from the correlation
S = sum w (p - cp)(q - cq)^T.  Batched over any leading dimensions.  The
correlation is an explicit broadcast sum, so it stays full float32 whatever
the matmul precision settings are.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) [..., 4] -> rotation matrix [..., 3, 3]."""
    w, x, y, z = quat.unbind(-1)
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def kabsch(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor | None = None):
    """Optimal rigid transform aligning p -> q (batched, Horn's method).

    p, q: f32[..., N, 3]; w: optional f32[..., N] weights (the validity mask
    for padded sets).  Returns (R f32[..., 3, 3], t f32[..., 3]), q ~ R p + t."""
    if w is None:
        w = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    wsum = w.sum(-1, keepdim=True).clamp_min(_EPS)
    wn = w / wsum
    cp = (p * wn[..., None]).sum(-2)
    cq = (q * wn[..., None]).sum(-2)
    pc = (p - cp[..., None, :]) * w[..., None]
    qc = q - cq[..., None, :]
    S = (pc[..., :, :, None] * qc[..., :, None, :]).sum(-3)
    scale = S.abs().amax(dim=(-2, -1)).clamp_min(_EPS)
    S = S / scale[..., None, None]
    s00, s01, s02 = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    s10, s11, s12 = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    s20, s21, s22 = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    K = torch.stack(
        [
            torch.stack([s00 + s11 + s22, s12 - s21, s20 - s02, s01 - s10], -1),
            torch.stack([s12 - s21, s00 - s11 - s22, s01 + s10, s02 + s20], -1),
            torch.stack([s20 - s02, s01 + s10, -s00 + s11 - s22, s12 + s21], -1),
            torch.stack([s01 - s10, s02 + s20, s12 + s21, -s00 - s11 + s22], -1),
        ],
        dim=-2,
    )
    _vals, vecs = torch.linalg.eigh(K)
    R = quat_to_rotmat(vecs[..., :, -1])  # eigenvector of the largest eigenvalue
    t = cq - (R * cp[..., None, :]).sum(-1)
    return R, t


def umeyama(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor | None = None):
    """Rigid (no-scale) Umeyama == Kabsch: the named alias of
    pcl::umeyama(cloud_src, cloud_tgt, false) in GROR's refine step."""
    return kabsch(p, q, w)


def to_matrix4(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def rotation_translation_error(T1: torch.Tensor, T2: torch.Tensor):
    """angle(R1^-1 R2), ||t1 - t2|| (reference: src/analysis.cpp:19-24)."""
    R1, t1 = T1[..., :3, :3], T1[..., :3, 3]
    R2, t2 = T2[..., :3, :3], T2[..., :3, 3]
    Rd = (R1.transpose(-1, -2)[..., :, :, None] * R2[..., None, :, :]).sum(-2)
    tr = Rd[..., 0, 0] + Rd[..., 1, 1] + Rd[..., 2, 2]
    ang = torch.arccos(((tr - 1.0) / 2.0).clamp(-1.0, 1.0))
    terr = ((t1 - t2) ** 2).sum(-1).sqrt()
    return ang, terr

"""Closed-form symmetric 3x3 eigendecomposition
(lidar_global_registration_tpu/ops/eigen3.py).

The trigonometric (Smith) eigenvalues and cross-product eigenvectors of
the JAX package, operation for operation, so that the SHOT local
reference frames round as they do there (`torch.linalg.eigh` would pick
its own signs and roundings).  Batched over any leading dimensions.
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-20


def _cross(a, b):
    """a x b over the last dimension, written out (jnp.cross's formula)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def _dot(a, b):
    return (a * b).sum(-1)


def _scale(A):
    return A.abs().amax((-2, -1)).clamp_min(_EPS)


def eigvals_sym3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric matrices f32[..., 3, 3], ascending
    (eigen3.eigvals_sym3)."""
    scale = _scale(A)
    B = A / scale[..., None, None]
    a00, a11, a22 = B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]
    a01, a02, a12 = B[..., 0, 1], B[..., 0, 2], B[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = (p2 / 6.0).clamp_min(0.0).sqrt()
    safe_p = p.clamp_min(_EPS)
    c00, c11, c22 = b00 / safe_p, b11 / safe_p, b22 / safe_p
    c01, c02, c12 = a01 / safe_p, a02 / safe_p, a12 / safe_p
    det = (c00 * (c11 * c22 - c12 * c12) - c01 * (c01 * c22 - c12 * c02)
           + c02 * (c01 * c12 - c11 * c02))
    r = (det / 2.0).clamp(-1.0, 1.0)
    phi = torch.acos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    iso = p <= _EPS
    e_hi = torch.where(iso, q, e_hi)
    e_mid = torch.where(iso, q, e_mid)
    e_lo = torch.where(iso, q, e_lo)
    return torch.stack([e_lo, e_mid, e_hi], -1) * scale[..., None]


def _eigvec_for(B: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of symmetric B[..., 3, 3] for eigenvalue lam: the
    largest cross product of two rows of (B - lam I); where all three
    vanish, an axis orthogonal to the strongest row (+z if B - lam I ~ 0)
    (eigen3._eigvec_for)."""
    M = B - lam[..., None, None] * torch.eye(3, dtype=B.dtype, device=B.device)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    cs = torch.stack([_cross(r0, r1), _cross(r0, r2), _cross(r1, r2)], -2)
    ns = (cs * cs).sum(-1)
    best = torch.argmax(ns, -1)  # the first maximum, as jnp.argmax
    v = torch.gather(cs, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    nbest = torch.gather(ns, -1, best[..., None])[..., 0]
    rn = torch.stack([_dot(r0, r0), _dot(r1, r1), _dot(r2, r2)], -1)
    ridx = torch.argmax(rn, -1)
    rbest = torch.gather(M, -2, ridx[..., None, None].expand(*ridx.shape, 1, 3))[..., 0, :]
    rbn = torch.gather(rn, -1, ridx[..., None])[..., 0]
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=B.dtype, device=B.device).expand_as(rbest)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=B.dtype, device=B.device).expand_as(rbest)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=B.dtype, device=B.device).expand_as(rbest)
    cx = _cross(rbest, ex)
    cy = _cross(rbest, ey)
    use_y = _dot(cx, cx) < _dot(cy, cy)
    fall = torch.where(use_y[..., None], cy, cx)
    fall = torch.where((rbn <= _EPS)[..., None], ez, fall)
    v = torch.where((nbest <= _EPS * 10.0)[..., None], fall, v)
    norm = _dot(v, v)[..., None].clamp_min(_EPS).sqrt()
    return v / norm


def eigh_sym3(A: torch.Tensor):
    """(eigvals f32[..., 3] ascending, eigvecs f32[..., 3, 3]) with
    eigvecs[..., :, k] the unit eigenvector of eigvals[..., k]
    (eigen3.eigh_sym3): v2 and v0 from cross products, v0 made orthogonal
    to v2, v1 = v2 x v0."""
    scale = _scale(A)
    B = A / scale[..., None, None]
    eig = eigvals_sym3(A) / scale[..., None]
    v2 = _eigvec_for(B, eig[..., 2])
    v0 = _eigvec_for(B, eig[..., 0])
    v0 = v0 - _dot(v0, v2)[..., None] * v2
    n0sq = _dot(v0, v0)
    axis = torch.argmin(v2.abs(), -1)
    e = torch.nn.functional.one_hot(axis, 3).to(B.dtype)
    alt = e - _dot(e, v2)[..., None] * v2
    v0 = torch.where((n0sq <= 1e-12)[..., None], alt, v0)
    v0 = v0 / _dot(v0, v0)[..., None].clamp_min(_EPS).sqrt()
    v1 = _cross(v2, v0)
    v1 = v1 / _dot(v1, v1)[..., None].clamp_min(_EPS).sqrt()
    return eig * scale[..., None], torch.stack([v0, v1, v2], -1)


def smallest_eigvec_sym3(A: torch.Tensor):
    """(eigvals f32[..., 3] ascending, unit eigenvector f32[..., 3] of the
    smallest) (eigen3.smallest_eigvec_sym3: the normal estimation's path,
    one cross-product eigenvector)."""
    scale = _scale(A)
    B = A / scale[..., None, None]
    eig = eigvals_sym3(A) / scale[..., None]
    return eig * scale[..., None], _eigvec_for(B, eig[..., 0])

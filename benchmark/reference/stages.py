"""The plain reference of the stages the benchmark checks, worked out again
from the inputs the benchmark hands the program: the cloud density and the
radii derived from it, the voxel pre-downsample and the ISS keypoints.
Plain PyTorch (float64 where a sum or an eigenproblem is formed), on any
device; it imports nothing of the program.

Definitions (the reference registration's, common.cpp and PCL's ISS, as
the configuration states them):
- density: the 0.8-quantile (nth_element at clamp(0.8 n - 1)) of the k = 8
  smoothed densities min(d_7(i), d_7(j)), d_7 the distance to the 7th
  nearest other point (PCL's k counts the point itself) and j the nearest
  other point; 0 where a point has fewer than 7.
- radii: normal cell sqrt(30 d^2 / pi), feature radius sqrt(352 d^2 / pi),
  ISS radius 2 d_side, distance threshold 4 d, d the larger density.
- pre-downsample: centroids of a voxel grid of side 2 d_side anchored at
  the scan's bounds' low corner less half a voxel, voxel index
  floor((x - origin) / voxel) in float32, voxels in z-major order.
- ISS: neighbours within r (float32 d2 <= r^2); weights 1 / (the
  neighbour's count within r, itself included); the weighted scatter
  about the point, self excluded; eigenvalues l3 <= l2 <= l1; a point is
  salient where l2 / l1 < 0.975, l3 / l2 < 0.975 and l3 > 0, and a
  keypoint where it is salient, has at least 4 neighbours and a larger l3
  than every neighbour.

These stages form no matrix product, so the control leaves them as they
are.  `matmul` is every route's one matrix product, in float32 or, for the
control, in TF32: on a CUDA card with TF32 switched on for the product, on
the CPU with the operands rounded to TF32's 10-bit mantissa and a float32
product.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from benchmark.reference.neighbours import knn_nonself, pairs_within


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 value (10-bit mantissa,
    ties to even)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def _tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in float32, or in TF32 (see the module's docstring)."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    low = precision == "tf32"
    if low and not a.is_cuda:
        return tf32(a) @ tf32(b)
    with _tf32(low):
        return a @ b


def smoothed_densities(pts: torch.Tensor, k: int = 8) -> torch.Tensor:
    kk = k - 1
    dist, idx = knn_nonself(pts, kk)
    d_raw = dist[:, kk - 1]
    d_nn = torch.where(torch.isfinite(dist[:, 0]), d_raw[idx[:, 0]], torch.inf)
    out = torch.minimum(d_raw, d_nn)
    return torch.where(torch.isfinite(out), out, 0.0)


def cloud_density(pts: torch.Tensor, k: int = 8, quantile: float = 0.8) -> float:
    n = pts.shape[0]
    if n == 0:
        return 0.0
    d = smoothed_densities(pts, k)
    kth = min(max(int(quantile * n - 1), 0), n - 1)
    return float(torch.kthvalue(d.cpu(), kth + 1).values)


def radii(ds: float, dt: float, normal_nr: int = 30, feature_nr: int = 352) -> dict:
    d = max(ds, dt)
    return dict(normal_cell=math.sqrt(normal_nr * d * d / math.pi), density_src=ds,
                density_tgt=dt, iss_src=2.0 * ds, iss_tgt=2.0 * dt,
                feature=math.sqrt(feature_nr * d * d / math.pi), thr=4.0 * d)


class VoxelGrid:
    """The pre-downsample's voxel grid of one scan: origin = the scan's
    bounds' low corner less half a voxel, index floor((x - origin) / voxel)
    in float32, keys in z-major order."""

    def __init__(self, xyz: torch.Tensor, voxel: float, lo: np.ndarray):
        self.voxel = float(voxel)
        self.origin = torch.from_numpy(np.asarray(lo, np.float32)
                                       - np.float32(0.5 * voxel)).to(xyz.device)
        self.vox = torch.tensor(voxel, dtype=torch.float32, device=xyz.device)
        self.dims = self.cells(xyz).amax(0) + 1

    def cells(self, xyz: torch.Tensor) -> torch.Tensor:
        return torch.floor((xyz - self.origin[None, :]) / self.vox).clamp_min(0).to(torch.int64)

    def keys(self, xyz: torch.Tensor) -> torch.Tensor:
        c, d = self.cells(xyz), self.dims
        return (c[:, 2] * d[1] + c[:, 1]) * d[0] + c[:, 0]


def voxel_centroids(xyz: torch.Tensor, voxel: float, lo: np.ndarray):
    """(centroids f32[m, 3] of the occupied voxels in z-major order, their
    keys i64[m], the grid)."""
    grid = VoxelGrid(xyz, voxel, lo)
    uk, inv = torch.unique(grid.keys(xyz), return_inverse=True)
    sums = torch.zeros((uk.shape[0], 3), dtype=torch.float64, device=xyz.device)
    sums.index_add_(0, inv, xyz.to(torch.float64))
    cnt = torch.bincount(inv, minlength=uk.shape[0]).to(torch.float64)
    return (sums / cnt[:, None]).to(torch.float32), uk, grid


def eigvals3(a00, a01, a02, a11, a12, a22):
    """Eigenvalues (ascending) of symmetric 3x3 matrices given by their six
    float64 components, by the trigonometric closed form (exact acos)."""
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p = ((b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1) / 6.0).clamp_min(0.0).sqrt()
    ps = p.clamp_min(1e-300)
    det = (b00 * (b11 * b22 - a12 * a12) - a01 * (a01 * b22 - a12 * a02)
           + a02 * (a01 * a12 - b11 * a02)) / (ps * ps * ps)
    phi = torch.acos((det / 2.0).clamp(-1.0, 1.0)) / 3.0
    hi = torch.where(p > 0, q + 2.0 * p * torch.cos(phi), q)
    lo = torch.where(p > 0, q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0), q)
    return lo, 3.0 * q - hi - lo, hi


def iss_keypoints(pts: torch.Tensor, radius: float, gamma21: float = 0.975,
                  gamma32: float = 0.975, min_neighbors: int = 4) -> torch.Tensor:
    """ISS keypoint flags bool[n] of the rows of pts f32[n, 3]."""
    n = pts.shape[0]
    dev = pts.device
    r32 = np.float32(radius)
    q, j, dd = pairs_within(pts, float(r32 * r32), float(radius) * (1.0 + 1e-5))
    count = torch.bincount(q, minlength=n)
    inv = 1.0 / count.clamp_min(1).to(torch.float64)
    nb = dd > 0.0
    q, j = q[nb], j[nb]
    w = inv[j]
    d = (pts[j] - pts[q]).to(torch.float64)
    acc = torch.zeros((n, 7), dtype=torch.float64, device=dev)
    parts = [w, w * d[:, 0] * d[:, 0], w * d[:, 0] * d[:, 1], w * d[:, 0] * d[:, 2],
             w * d[:, 1] * d[:, 1], w * d[:, 1] * d[:, 2], w * d[:, 2] * d[:, 2]]
    acc.index_add_(0, q, torch.stack(parts, 1))
    ws = acc[:, 0]
    c = acc[:, 1:] / ws.clamp_min(1e-300)[:, None]
    l3, l2, l1 = eigvals3(*c.unbind(1))
    good = ((ws > 0) & (l2 / l1.clamp_min(1e-300) < gamma21)
            & (l3 / l2.clamp_min(1e-300) < gamma32) & (l3 > 0))
    sal = torch.where(good, l3, 0.0)
    nnb = torch.bincount(q, minlength=n)
    nb_max = torch.full((n,), -math.inf, dtype=torch.float64, device=dev)
    nb_max.scatter_reduce_(0, q, sal[j], reduce="amax")
    return good & (nnb >= min_neighbors) & (sal > nb_max)


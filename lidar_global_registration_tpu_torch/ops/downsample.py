"""Voxel-centroid downsampling (lidar_global_registration_tpu/ops/downsample.py).

One int64 sort of the voxel keys and segment sums (`index_add_`) replace
the JAX package's two routes (a 3-key lexsort with segment_sum, and a
packed int32 key with a suffix-sum by prefix doubling, which is a TPU
device).  What both JAX routes share, and this module keeps exactly:

  - the grid anchor: the cloud's own masked min - voxel / 2 in float32
    (or the caller's origin, voxel_centroids_packed);
  - the key order: z-major (cz primary, then cy, then cx), so voxels come
    out in the same order and `row_of` and the counts are equal;
  - output rows compacted to the front in key order.

Coordinates are summed as residuals against each voxel's base corner, as
the packed JAX route does, so the centroid's rounding stays near
ulp(voxel) whatever the scene's extent.  The residual sums accumulate in
float64 (the CUDA `index_add_` adds atomically in no fixed order; in
float64 the order does not show after the cast back to float32).  A voxel
of one point takes the arithmetic of the JAX route its caller mirrors, the
same bits on the CPU and the card: (x * w) / w in voxel_downsample (the
segment-sum route), corner + (x - corner) in voxel_centroids_packed and
voxel_centroids_map (the packed routes, which the JAX staged path runs for
its feature-scale maps whenever the caller gives the scene's bounds, as the
CLI does).

voxel_downsample (the loader's fine downsample, downsample.py:288-352) is
the same body with each point weighted by its accumulated weight and the
normals averaged too; dedup_points (the loader's exact-duplicate removal)
sorts the coordinates' bit patterns.
"""
from __future__ import annotations

import torch

from lidar_global_registration_tpu_torch.types import Cloud

_BIG = 3.0e37


def aabb(xyz: torch.Tensor, valid: torch.Tensor):
    """Masked axis-aligned bounding box (lo f32[3], hi f32[3]) of the valid
    rows (downsample.aabb; +-3e37 for an empty cloud)."""
    lo = torch.where(valid[:, None], xyz, _BIG).amin(0)
    hi = torch.where(valid[:, None], xyz, -_BIG).amax(0)
    return lo, hi


def masked_min(xyz: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-axis min of the valid rows (0 for an empty cloud), float32."""
    lo = aabb(xyz, valid)[0]
    return torch.where(lo < _BIG, lo, 0.0)


def _fma32(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x * y + z of float32 tensors rounded once to float32, as a fused
    multiply-add rounds: the product is exact in float64, and the float64
    sum is rounded to odd (its error from a TwoSum), so that the cast rounds
    as the exact sum would.  The same bits on the CPU and the card."""
    p = x.to(torch.float64) * y.to(torch.float64)
    z = z.to(torch.float64)
    s = p + z
    b = s - p
    err = (p - (s - b)) + (z - b)
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    odd = torch.where((err != 0) & (bits & 1 == 0), bits + step, bits)
    return odd.view(torch.float64).to(torch.float32)


def _lone_normal(n: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """JAX's renormalised weighted mean normal of one point, as XLA runs
    voxel_downsample on the CPU: (n * w) / (w * |(n * w) / w|), the squared
    norm a chain of fused multiply-adds (x0 x0, then + x1 x1, then + x2 x2)
    and the two divisions fused into one (A / B / C -> A / (B * C))."""
    nw = n * w
    m0, m1, m2 = (nw / w).unbind(1)
    nn = _fma32(m2, m2, _fma32(m1, m1, m0 * m0)).sqrt()[:, None]
    return nw / (w * torch.where(nn < 1e-5, 1.0, nn))


def _centroids(xyz: torch.Tensor, valid: torch.Tensor, voxel: float,
               origin: torch.Tensor, weight: torch.Tensor | None = None,
               normal: torch.Tensor | None = None, packed: bool = False):
    """Shared body: (out_xyz f32[N, 3] front-compacted centroids (0.0 on
    the rows past them), out_valid bool[N], row_of i64[N] output row of
    each valid input row (0 elsewhere), n_out i64[] on the device, acc):
    nothing here reads the device from the host.  With `weight` f32[N]
    (positive on valid rows) each point counts by its weight, and acc =
    (summed weight f32[N], weighted mean normal f32[N, 3] renormalised, or
    None when no `normal` is given); without it points count 1 and acc is
    None.

    A run of one valid row takes the JAX segment-sum route's arithmetic for
    it in float32 unless `packed`: xyz (x * w) / w, w its weight (1 without
    weights: the point itself), and the normal of _lone_normal; the summed
    weight is w either way.  One term has no summation order, so the CPU
    and the card give the same bits.  With `packed` it keeps the residual
    form, corner + (x - corner), which is the JAX packed routes' arithmetic
    for one point."""
    dev = xyz.device
    N = xyz.shape[0]
    vox = torch.tensor(voxel, dtype=torch.float32, device=dev)
    c = torch.floor((xyz - origin[None, :]) / vox.clamp_min(1e-30)).clamp_min(0)
    c = c.to(torch.int64)
    dims = torch.where(valid[:, None], c, 0).amax(0) + 1
    # z-major like the JAX lexsort((cx, cy, cz)) (last key primary)
    key = (c[:, 2] * dims[1] + c[:, 1]) * dims[0] + c[:, 0]
    key = torch.where(valid, key, torch.iinfo(torch.int64).max)
    ks, order = torch.sort(key, stable=True)
    first = torch.ones(N, dtype=torch.bool, device=dev)
    first[1:] = ks[1:] != ks[:-1]
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    svalid = valid[order]
    n_out = (first & svalid).sum()
    w = svalid.to(torch.float64)
    if weight is not None:
        w = torch.where(svalid, weight[order].to(torch.float64), 0.0)
    # residuals against the voxel base corner, summed per run
    cs = c[order].to(torch.float32)
    base = origin[None, :] + cs * vox
    res = torch.where(svalid[:, None], xyz[order] - base, 0.0).to(torch.float64)
    if weight is not None:
        res = res * w[:, None]
    sums = torch.zeros((N, 3), dtype=torch.float64, device=dev).index_add_(0, seg, res)
    cnt = torch.zeros((N,), dtype=torch.float64, device=dev).index_add_(0, seg, w)
    base_run = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    base_run[seg] = base  # every member of a run writes the same corner
    out_valid = torch.arange(N, device=dev) < n_out
    cent = base_run + (sums / cnt.clamp_min(1e-30)[:, None]).to(torch.float32)
    if not packed:
        # one-point runs from the run boundaries (the invalid rows' run sorts
        # last and stays padding); every member of a longer run writes False
        last = torch.ones_like(first)
        last[:-1] = first[1:]
        lone_run = torch.zeros((N, 1), dtype=torch.bool, device=dev)
        lone_run[seg, 0] = first & last & svalid

        def put(one: torch.Tensor, run: torch.Tensor) -> torch.Tensor:
            out = torch.empty_like(run)
            out[seg] = one  # read only at one-point runs, which have one writer
            return torch.where(lone_run, out, run)

        w32 = None if weight is None else weight[order][:, None]
        cent = put(xyz[order] if w32 is None else (xyz[order] * w32) / w32, cent)
    out_xyz = torch.where(out_valid[:, None], cent, 0.0)
    row_of = torch.zeros((N,), dtype=torch.int64, device=dev)
    row_of[order] = torch.where(svalid, seg, 0)
    acc = None
    if weight is not None:
        nrm = None
        if normal is not None:
            nsum = torch.zeros((N, 3), dtype=torch.float64, device=dev).index_add_(
                0, seg, normal[order].to(torch.float64) * w[:, None])
            nrm = (nsum / cnt.clamp_min(1e-30)[:, None]).to(torch.float32)
            # renormalised unless the norm is below 1e-5 (downsample.h:21-24)
            nn = nrm.square().sum(1, keepdim=True).sqrt()
            nrm = nrm / torch.where(nn < 1e-5, 1.0, nn)
            if not packed:
                nrm = put(_lone_normal(normal[order], w32), nrm)
        acc = (cnt.to(torch.float32), nrm)
    return out_xyz, out_valid, row_of, n_out, acc


def voxel_centroids_map(xyz: torch.Tensor, valid: torch.Tensor, voxel: float):
    """Voxel centroids with an input-row -> output-row map
    (downsample.voxel_centroids_map and voxel_centroids_map_packed, which
    give the same partition, order and map).  The grid anchors at the
    cloud's own min - voxel / 2 in float32.  A voxel of one point takes
    voxel_centroids_map_packed's arithmetic, corner + (x - corner): the JAX
    staged path runs that route whenever it is given the scene's bounds.
    Returns (out_xyz f32[N, 3], out_valid bool[N], row_of i64[N], n_out
    i64[] on the device); rows past the n_out centroids hold 0.0."""
    vox = torch.tensor(voxel, dtype=torch.float32, device=xyz.device)
    return _centroids(xyz, valid, voxel, masked_min(xyz, valid) - 0.5 * vox, packed=True)[:4]


def voxel_centroids_packed(xyz: torch.Tensor, valid: torch.Tensor, voxel: float,
                           origin: torch.Tensor):
    """Voxel centroids on a grid anchored at the caller's `origin` f32[3]
    (downsample.voxel_centroids_packed; the JAX function leaves its rows at
    each run's first sorted slot for flagship._compact_xyz to compact, this
    one returns them compacted already).  A voxel of one point keeps that
    route's arithmetic, corner + (x - corner) in float32, which can move
    the point by an ulp where the corner lies below half of it.  Returns
    (out_xyz, out_valid, n_out) as voxel_centroids_map."""
    out_xyz, out_valid, _row_of, n_out, _acc = _centroids(xyz, valid, voxel, origin,
                                                          packed=True)
    return out_xyz, out_valid, n_out


def voxel_downsample(cloud: Cloud, voxel: float) -> Cloud:
    """The loader's weighted voxel downsample into the same capacity
    (downsample.voxel_downsample, downsample.cpp:5-41): the grid anchors at
    the cloud's min - voxel / 2; each voxel averages its points' positions
    and normals weighted by their accumulated `weight`, keeps the summed
    weight, and renormalises the normal unless its norm is below 1e-5
    (downsample.h:21-24).  Output rows in the JAX lexsort order (z major),
    compacted to the front; padding rows hold PAD_COORD and zeros."""
    vox = torch.tensor(voxel, dtype=torch.float32, device=cloud.xyz.device)
    origin = masked_min(cloud.xyz, cloud.valid) - 0.5 * vox
    out_xyz, out_valid, _row_of, _n, (acc_w, nrm) = _centroids(
        cloud.xyz, cloud.valid, voxel, origin, cloud.weight, cloud.normal)
    v = out_valid[:, None]
    return Cloud(xyz=torch.where(v, out_xyz, Cloud.PAD_COORD), normal=torch.where(v, nrm, 0.0),
                 weight=torch.where(out_valid, acc_w, 0.0),
                 curvature=torch.zeros_like(acc_w), valid=out_valid)


def dedup_points(xyz: torch.Tensor) -> torch.Tensor:
    """Keep-mask bool[N] of the first occurrence of each exact xyz triple
    (the loader's duplicate filter, common.cpp:417-427; the JAX package's
    native.dedup_points).  Two stable sorts of the coordinates' int32 bit
    patterns (z, then x and y packed in one int64) bring equal triples
    together in row order; the lowest row of each run is kept.  Equality is
    of bits: -0.0 and 0.0 differ here (== in the native filter)."""
    n = xyz.shape[0]
    if n == 0:
        return torch.zeros((0,), dtype=torch.bool, device=xyz.device)
    bits = xyz.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    xy = (bits[:, 0] << 32) | (bits[:, 1] & 0xFFFFFFFF)
    order = torch.sort(bits[:, 2], stable=True)[1]
    order = order[torch.sort(xy[order], stable=True)[1]]
    sxy, sz = xy[order], bits[order, 2]
    first = torch.ones((n,), dtype=torch.bool, device=xyz.device)
    first[1:] = (sxy[1:] != sxy[:-1]) | (sz[1:] != sz[:-1])
    keep = torch.zeros((n,), dtype=torch.bool, device=xyz.device)
    keep[order] = first
    return keep

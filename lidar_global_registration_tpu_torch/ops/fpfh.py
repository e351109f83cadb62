"""FPFH-33 at keypoints over a support surface
(lidar_global_registration_tpu/ops/fpfh.py), the descriptor of the host
pyramid.

Reference: estimateFeatures<FPFH> delegates to pcl::FPFHEstimationOMP with a
radius search (include/common.h:322-332):

  SPFH(p): for each radius neighbour j != p, the Darboux pair features
    (f1 = alpha, f2 = phi, f3 = theta) binned 3 x 11 with increment
    100 / #neighbours; source and target swap so the normal with the
    smaller angle to the line leads.
  FPFH(p) = SPFH(p) + (1/k) sum_j SPFH(j) / d2(p, j), each 11-bin block
    rescaled to sum 100.

The SPFH of every surface point is K5's full form (ops/cellgrid.spfh_sorted
on a plan of cell = radius: the CUDA kernel on a CUDA tensor, its plain
version on a CPU tensor), where the JAX host path computes it in XLA.  The
keypoints are not rows of the surface, so the combine at them is plain
PyTorch over their exact radius neighbours (ops/grid.radius_neighbors on
the same plan), as it is XLA in JAX; its weighted sum is float32 where the
JAX package gathers the SPFH table in bfloat16.  fpfh() is these steps in
one call; a tp peer (parallel/batch.py) runs them apart: SPFH at its shard's
rows (K5's slot-list form, spfh_rows), the whole table gathered from its
peers, then the combine at its shard's keypoints (combine_at).
"""
from __future__ import annotations

import math

import torch

from lidar_global_registration_tpu_torch.ops import cellgrid, grid

NR_BINS = 11
DIM = 3 * NR_BINS
_SLOTS = 1 << 20  # keypoint x neighbour slots per block of the combine's [m, K, 33] gather


def pair_features(p1, n1, p2, n2):
    """pcl::computePairFeatures for [..., 3] tensors (the AoS form of
    pair_features_soa)."""
    return pair_features_soa([p2[..., c] - p1[..., c] for c in range(3)],
                             [n1[..., c] for c in range(3)], [n2[..., c] for c in range(3)])


def pair_features_soa(dp, n1, n2):
    """Darboux pair features from per-coordinate components: dp, n1, n2
    are lists of 3 broadcastable tensors (dp = p2 - p1).  Returns (f1, f2,
    f3, ok)."""
    d = (dp[0] ** 2 + dp[1] ** 2 + dp[2] ** 2).clamp_min(0.0).sqrt()
    dsafe = d.clamp_min(1e-30)
    a1 = (n1[0] * dp[0] + n1[1] * dp[1] + n1[2] * dp[2]) / dsafe
    a2 = (n2[0] * dp[0] + n2[1] * dp[1] + n2[2] * dp[2]) / dsafe
    # the normal with the SMALLER angle to the line is the source
    swap = torch.arccos(a1.abs().clamp(0, 1)) > torch.arccos(a2.abs().clamp(0, 1))
    ns = [torch.where(swap, b, a) for a, b in zip(n1, n2)]
    nt = [torch.where(swap, a, b) for a, b in zip(n1, n2)]
    dps = [torch.where(swap, -c, c) for c in dp]
    f3 = torch.where(swap, a2, a1)
    v = [dps[1] * ns[2] - dps[2] * ns[1], dps[2] * ns[0] - dps[0] * ns[2],
         dps[0] * ns[1] - dps[1] * ns[0]]
    vn = (v[0] ** 2 + v[1] ** 2 + v[2] ** 2).clamp_min(0.0).sqrt()
    ok = (d > 0) & (vn > 1e-12)
    vs = vn.clamp_min(1e-30)
    v = [c / vs for c in v]
    w = [ns[1] * v[2] - ns[2] * v[1], ns[2] * v[0] - ns[0] * v[2], ns[0] * v[1] - ns[1] * v[0]]
    f2 = v[0] * nt[0] + v[1] * nt[1] + v[2] * nt[2]
    f1 = torch.atan2(w[0] * nt[0] + w[1] * nt[1] + w[2] * nt[2],
                     ns[0] * nt[0] + ns[1] * nt[1] + ns[2] * nt[2])
    return f1, f2, f3, ok


def _bin_idx(f1, f2, f3):
    b1 = torch.floor(NR_BINS * (f1 + math.pi) / (2.0 * math.pi)).clamp(0, NR_BINS - 1)
    b2 = torch.floor(NR_BINS * (f2 + 1.0) / 2.0).clamp(0, NR_BINS - 1)
    b3 = torch.floor(NR_BINS * (f3 + 1.0) / 2.0).clamp(0, NR_BINS - 1)
    return b1.long(), b2.long(), b3.long()


def _spfh_histogram(f1, f2, f3, ok):
    """3 x 11 histograms [M, K] -> f32[M, 33], each pair adding 100 / #pairs."""
    cnt = ok.sum(1)
    incr = torch.where(cnt > 0, 100.0 / cnt.clamp_min(1).to(torch.float32), 0.0)
    bins = torch.arange(NR_BINS, device=f1.device)
    cols = [((b[..., None] == bins) & ok[..., None]).sum(1).to(torch.float32)
            for b in _bin_idx(f1, f2, f3)]
    return torch.cat(cols, 1) * incr[:, None]


def spfh(xyz, normal, idx, mask, query_xyz=None, query_normal=None):
    """SPFH of each query over its neighbours (fpfh.spfh): xyz / normal
    f32[N, 3], idx i64[Q, K] neighbour rows (self excluded), mask bool[Q, K];
    the queries are the cloud's rows unless query_xyz / query_normal give
    other points.  Normals of norm <= 0.5 take part in no pair.  Returns
    f32[Q, 33]."""
    query_xyz = xyz if query_xyz is None else query_xyz
    query_normal = normal if query_normal is None else query_normal
    dp = [xyz[:, c][idx] - query_xyz[:, c][:, None] for c in range(3)]
    n1 = [query_normal[:, c][:, None] for c in range(3)]
    n2 = [normal[:, c][idx] for c in range(3)]
    f1, f2, f3, ok = pair_features_soa(dp, n1, n2)
    ok = ok & mask & ((n1[0] ** 2 + n1[1] ** 2 + n1[2] ** 2) > 0.5)
    ok = ok & ((n2[0] ** 2 + n2[1] ** 2 + n2[2] ** 2) > 0.5)
    return _spfh_histogram(f1, f2, f3, ok)


def combine_spfh(kp_xyz, kp_normal, surface_xyz, surface_normal, spfh_all, kidx, kdist, kmask):
    """Keypoint FPFH from the neighbours' SPFH and the keypoint's own
    (PCL weightPointSPFHSignature; fpfh.combine_spfh): the 1 / d2-weighted
    mean of the neighbours' SPFH rows (a float32 sum), plus the SPFH of the
    keypoint's own pairs, each block rescaled to 100.  kidx / kdist / kmask
    [M, K] are the keypoints' radius neighbours on the surface; zero
    distances do not count.  Returns (feat f32[M, 33], neighbour count
    i64[M])."""
    m = kmask & (kdist > 1e-12)
    w = torch.where(m, 1.0 / (kdist * kdist).clamp_min(1e-30), 0.0)
    k_cnt = m.sum(1)
    wsum = (w[..., None] * spfh_all[kidx]).sum(1) / k_cnt.clamp_min(1)[:, None]
    own = spfh(surface_xyz, surface_normal, kidx, m, query_xyz=kp_xyz, query_normal=kp_normal)
    feat = own + wsum
    out = []
    for blk in range(3):
        f = feat[:, blk * NR_BINS:(blk + 1) * NR_BINS]
        s = f.sum(1, keepdim=True)
        out.append(torch.where(s > 0, 100.0 * f / s.clamp_min(1e-30), f))
    return torch.cat(out, 1), k_cnt


def _nearest_normal(kidx, surface_normal):
    """The nearest surface point's normal at each keypoint: its first
    neighbour, the neighbour lists being sorted by distance."""
    return surface_normal[kidx[:, 0]]


def surface_plan(surface_xyz, surface_valid, surface_normal, radius):
    """The support surface's plan at `radius` with its normals set."""
    return cellgrid.set_normals(cellgrid.plan_grid(surface_xyz, surface_valid, radius),
                                surface_normal)


def spfh_rows(plan: cellgrid.GridPlan, radius, rows=None):
    """SPFH of the plan's cloud by input row (f32[N, 33]; 0 at invalid
    rows): K5's full pass, or with `rows` (i64[m] input rows) K5's
    slot-list form over those rows only, f32[m, 33].  A row's SPFH is the
    same either way."""
    r2 = cellgrid._f32_square(radius)
    centre = cellgrid.aabb_centre(plan)
    if rows is None:
        return cellgrid._unsort(plan, cellgrid.spfh_sorted(plan, r2, centre)[0])
    slot = cellgrid.slot_of(plan)[rows]
    live = slot >= 0
    sorted_rows = cellgrid.spfh_sorted(plan, r2, centre, torch.sort(slot[live]).values)[0]
    out = torch.zeros((rows.shape[0], DIM), dtype=torch.float32, device=rows.device)
    out[live] = sorted_rows[slot[live]]
    return out


def keypoint_neighbors(plan: cellgrid.GridPlan, kp_xyz, radius):
    """Every surface point within `radius` of each keypoint f32[M, 3]
    (ops/grid.radius_neighbors on the plan: idx, dist, mask [M, K], K the
    most any keypoint has)."""
    return grid.radius_neighbors(plan, kp_xyz, torch.ones_like(kp_xyz[:, 0], dtype=torch.bool),
                                 float(radius), max(plan.n_valid, 1))


def combine_at(kp_xyz, kp_normal, surface_xyz, surface_normal, spfh_all, kidx, kdist, kmask):
    """combine_spfh over blocks of keypoints ([M, K] neighbour lists, the
    whole surface's SPFH f32[N, 33]).  Returns (feat f32[M, 33], neighbour
    count i64[M])."""
    M = kp_xyz.shape[0]
    feat = torch.zeros((M, DIM), dtype=torch.float32, device=kp_xyz.device)
    k_cnt = torch.zeros((M,), dtype=torch.int64, device=kp_xyz.device)
    step = max(1, _SLOTS // max(kidx.shape[1], 1))
    for a in range(0, M, step):
        s = slice(a, a + step)
        feat[s], k_cnt[s] = combine_spfh(kp_xyz[s], kp_normal[s], surface_xyz, surface_normal,
                                         spfh_all, kidx[s], kdist[s], kmask[s])
    return feat, k_cnt


def fpfh(kp_xyz, kp_valid, surface_xyz, surface_normal, surface_valid, radius,
         kp_normal=None):
    """FPFH-33 of the keypoints kp_xyz f32[M, 3] (kp_valid bool[M]) over the
    support surface (xyz, normals, validity) within `radius` (fpfh.fpfh):
    K5 over every surface point on one plan at the radius, then the
    combine at each keypoint over all its neighbours within r (exact; the
    JAX package keeps 128 points a cell and 384 neighbours).  kp_normal
    None takes the nearest surface point's normal.  Returns (features
    f32[M, 33], feat_valid bool[M] = kp_valid & some neighbour), 0 where not
    valid."""
    dev = kp_xyz.device
    M = kp_xyz.shape[0]
    plan = surface_plan(surface_xyz, surface_valid, surface_normal, radius)
    spfh_all = spfh_rows(plan, radius)
    feat = torch.zeros((M, DIM), dtype=torch.float32, device=dev)
    k_cnt = torch.zeros((M,), dtype=torch.int64, device=dev)
    rows = torch.nonzero(kp_valid).squeeze(1)
    kidx, kdist, kmask = keypoint_neighbors(plan, kp_xyz[rows], radius)
    kn = _nearest_normal(kidx, surface_normal) if kp_normal is None else kp_normal[rows]
    feat[rows], k_cnt[rows] = combine_at(kp_xyz[rows], kn, surface_xyz, surface_normal, spfh_all,
                                         kidx, kdist, kmask)
    feat_valid = kp_valid & (k_cnt > 0)
    return torch.where(feat_valid[:, None], feat, 0.0), feat_valid

"""The plain reference of the stages after the keypoints, worked out again
from the reference's own working rows and keypoints: the feature-scale
surface, its normals, FPFH-33 at the keypoints, the descriptor 1-NN both
ways, the cluster gate and the gated correspondences.  Plain PyTorch on
any device; it imports nothing of the program.

Definitions (the configuration's route: ISS keypoints, FPFH on the
feature-scale voxel surface, cluster matching):
- surface: voxel centroids of the working rows at voxel_f = sqrt(pi r_f^2 /
  352) (r_f the feature radius), the grid anchored at the rows' minimum less
  half a voxel; a keypoint's surface row is the voxel that holds it.
- normals: the PCA normal (float64 moments, smallest eigenvector) of the
  surface points within normal_f = sqrt(30 / pi) voxel_f of each surface
  point, itself included, turned towards the scan's viewpoint; 0 where
  fewer than 3 points lie within it.
- SPFH of a surface point: the Darboux pair features (PCL's
  computePairFeatures: the normal with the smaller angle to the line leads,
  u = that normal, v = dp x u / |dp x u|, w = u x v; f1 = atan2(w . n_t,
  u . n_t), f2 = v . n_t, f3 = the leading normal's cosine to dp = p_j - p_q,
  unsigned by the swap) with every surface point within r_f (0 < d2 <= r_f^2,
  float32 d2 of coordinates centred on the surface's bounding-box centre)
  whose normal and its own have norm^2 > 0.5, binned 3 x 11 on [-pi, pi],
  [-1, 1], [-1, 1], each pair adding 100 / (the pairs counted).
- FPFH at a keypoint's surface row s: SPFH(s) + (1/k) sum_j SPFH(j) / d2(s, j)
  over the k surface points with 0 < d2 <= r_f^2, each 11-bin block rescaled
  to sum 100; valid where k > 0.
- descriptor 1-NN: d2 = |q|^2 + |t|^2 - 2 q . t (a matrix product), the
  lowest train index among equal minima, over valid rows.
- cluster gate (ClusterMatcher): each keypoint's kc nearest other valid
  keypoints of its side (kc = max(2, min(cluster_k, n_src - 1, n_tgt - 1))),
  by the same Gram-trick distance of the keypoints centred on their valid
  mean; for the match i -> j the share of i's neighbours whose matches fall
  among j's neighbours, d = 1 - share (0 where i's neighbours have no
  match); both directions' d under cluster_threshold, then the
  max_correspondences lowest max(d_i, d_j) scores, every row at the cut's
  score kept.  A correspondence is (source keypoint row, its target 1-NN row).

`precision="tf32"` computes every matrix product (the descriptor and the
keypoint distances) in TF32 (stages.matmul).  That is the control
(feature_scale.control).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference import stages
from benchmark.reference.neighbours import candidate_blocks

NR_BINS = 11
DIM = 3 * NR_BINS
FEATURE_NR_POINTS = 352
NORMAL_NR_POINTS = 30
BIG = 3.0e38
_MM_SLOTS = 1 << 26  # distance entries per query block of a distance matrix


def f32_square(r: float) -> float:
    r32 = np.float32(r)
    return float(r32 * r32)


def scales(feature_radius: float) -> tuple[float, float]:
    """(voxel_f, normal_f) of the feature-scale surface."""
    voxel_f = math.sqrt(math.pi * feature_radius**2 / FEATURE_NR_POINTS)
    return voxel_f, math.sqrt(NORMAL_NR_POINTS / math.pi) * voxel_f


def surface(rows: torch.Tensor, voxel: float):
    """(surface f32[m, 3], row_of i64[n]: each working row's surface row)."""
    lo = rows.amin(0).cpu().numpy()
    cen, keys, grid = stages.voxel_centroids(rows, voxel, lo)
    return cen, torch.searchsorted(keys, grid.keys(rows))


def smallest_eigvec(a00, a01, a02, a11, a12, a22) -> torch.Tensor:
    """Unit eigenvectors f64[n, 3] of the smallest eigenvalues of symmetric
    3x3 matrices (float64 components): the largest cross product of two
    rows of A - l0 I; +z where the matrix is isotropic."""
    l0, _l1, _l2 = stages.eigvals3(a00, a01, a02, a11, a12, a22)
    r0 = torch.stack([a00 - l0, a01, a02], 1)
    r1 = torch.stack([a01, a11 - l0, a12], 1)
    r2 = torch.stack([a02, a12, a22 - l0], 1)
    cands = torch.stack([torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], 1)
    n2 = (cands * cands).sum(2)
    best = n2.argmax(1)
    v = cands[torch.arange(cands.shape[0], device=cands.device), best]
    norm = n2.amax(1).sqrt()
    scale = torch.stack([a00, a11, a22, a01, a02, a12], 1).abs().amax(1)
    flat = norm <= 1e-12 * scale * scale
    v = torch.where(flat[:, None], torch.tensor([0.0, 0.0, 1.0], dtype=v.dtype, device=v.device),
                    v / norm.clamp_min(1e-300)[:, None])
    return v


def normals(pts: torch.Tensor, radius: float, viewpoint: torch.Tensor) -> torch.Tensor:
    """PCA normals f32[m, 3] of the surface (see the module's docstring)."""
    n = pts.shape[0]
    r2 = f32_square(radius)
    acc = torch.zeros((n, 10), dtype=torch.float64, device=pts.device)
    for q, j in candidate_blocks(pts, radius * (1.0 + 1e-5)):
        d = pts[j] - pts[q]
        keep = (d * d).sum(1) <= r2
        q, d = q[keep], d[keep].to(torch.float64)
        x, y, z = d.unbind(1)
        acc.index_add_(0, q, torch.stack([torch.ones_like(x), x, y, z, x * x, x * y, x * z,
                                          y * y, y * z, z * z], 1))
    cnt = acc[:, 0].clamp_min(1.0)
    m = acc[:, 1:4] / cnt[:, None]
    s = acc[:, 4:] / cnt[:, None]
    cov = (s[:, 0] - m[:, 0] * m[:, 0], s[:, 1] - m[:, 0] * m[:, 1], s[:, 2] - m[:, 0] * m[:, 2],
           s[:, 3] - m[:, 1] * m[:, 1], s[:, 4] - m[:, 1] * m[:, 2], s[:, 5] - m[:, 2] * m[:, 2])
    nrm = smallest_eigvec(*cov)
    to_vp = viewpoint.to(torch.float64)[None, :] - pts.to(torch.float64)
    nrm = torch.where(((nrm * to_vp).sum(1) < 0.0)[:, None], -nrm, nrm)
    ok = acc[:, 0] >= 3
    return torch.where(ok[:, None], nrm, 0.0).to(torch.float32)


def _pair_bins(dp64: torch.Tensor, nq: torch.Tensor, nj: torch.Tensor):
    """(bin index i64[p, 3], ok bool[p]) of the pair features of query
    normals nq against neighbour normals nj (f64[p, 3]) along dp = p_j - p_q."""
    d = dp64.norm(dim=1)
    ds = d.clamp_min(1e-300)
    a1 = (nq * dp64).sum(1) / ds
    a2 = (nj * dp64).sum(1) / ds
    swap = a1.abs() < a2.abs()
    u = torch.where(swap[:, None], nj, nq)
    nt = torch.where(swap[:, None], nq, nj)
    dps = torch.where(swap[:, None], -dp64, dp64)
    f3 = torch.where(swap, a2, a1)
    v = torch.linalg.cross(dps, u)
    vn = v.norm(dim=1)
    ok = (d > 0) & (vn > 1e-12)
    v = v / vn.clamp_min(1e-300)[:, None]
    w = torch.linalg.cross(u, v)
    f2 = (v * nt).sum(1)
    f1 = torch.atan2((w * nt).sum(1), (u * nt).sum(1))
    b1 = torch.floor(NR_BINS * (f1 + math.pi) / (2.0 * math.pi))
    b2 = torch.floor(NR_BINS * (f2 + 1.0) / 2.0)
    b3 = torch.floor(NR_BINS * (f3 + 1.0) / 2.0)
    bins = torch.stack([b1, b2, b3], 1).clamp(0, NR_BINS - 1).to(torch.int64)
    return bins, ok


def spfh(pts: torch.Tensor, nrm: torch.Tensor, rows: torch.Tensor, radius: float) -> torch.Tensor:
    """SPFH f32[len(rows), 33] of the surface rows `rows` (i64, distinct)."""
    dev = pts.device
    r2 = f32_square(radius)
    centre = 0.5 * (pts.amin(0) + pts.amax(0))
    slot = torch.full((pts.shape[0],), -1, dtype=torch.int64, device=dev)
    slot[rows] = torch.arange(rows.shape[0], device=dev)
    counts = torch.zeros((rows.shape[0], DIM), dtype=torch.float64, device=dev)
    pairs = torch.zeros((rows.shape[0],), dtype=torch.float64, device=dev)
    n2 = (nrm * nrm).sum(1)
    for q, j in candidate_blocks(pts, radius * (1.0 + 1e-5), rows):
        dp = (pts[j] - centre) - (pts[q] - centre)
        d2 = (dp * dp).sum(1)
        keep = (d2 > 0.0) & (d2 <= r2) & (n2[q] > 0.5) & (n2[j] > 0.5)
        q, j, dp = q[keep], j[keep], dp[keep]
        bins, ok = _pair_bins(dp.to(torch.float64), nrm[q].to(torch.float64),
                              nrm[j].to(torch.float64))
        s = slot[q[ok]]
        pairs.index_add_(0, s, torch.ones_like(s, dtype=torch.float64))
        for blk in range(3):
            counts.view(-1).index_add_(0, s * DIM + blk * NR_BINS + bins[ok, blk],
                                       torch.ones_like(s, dtype=torch.float64))
    scale = torch.where(pairs > 0, 100.0 / pairs.clamp_min(1.0), 0.0)
    return (counts * scale[:, None]).to(torch.float32)


def fpfh(pts: torch.Tensor, nrm: torch.Tensor, rows: torch.Tensor, radius: float):
    """(FPFH f32[len(rows), 33], valid bool[len(rows)]) at the distinct
    surface rows `rows`."""
    dev = pts.device
    r2 = f32_square(radius)
    k_of = torch.full((pts.shape[0],), -1, dtype=torch.int64, device=dev)
    k_of[rows] = torch.arange(rows.shape[0], device=dev)
    qs, js, ws = [], [], []
    for q, j in candidate_blocks(pts, radius * (1.0 + 1e-5), rows):
        d = pts[j] - pts[q]
        d2 = (d * d).sum(1)
        keep = (d2 > 0.0) & (d2 <= r2)
        qs.append(k_of[q[keep]])
        js.append(j[keep])
        ws.append(1.0 / d2[keep].to(torch.float64))
    q = torch.cat(qs) if qs else torch.zeros((0,), dtype=torch.int64, device=dev)
    j = torch.cat(js) if js else q
    w = torch.cat(ws) if ws else torch.zeros((0,), dtype=torch.float64, device=dev)
    need = torch.unique(torch.cat([rows, j]))
    table = torch.zeros((pts.shape[0], DIM), dtype=torch.float32, device=dev)
    table[need] = spfh(pts, nrm, need, radius)
    k = torch.bincount(q, minlength=rows.shape[0]).to(torch.float64)
    wsum = torch.zeros((rows.shape[0], DIM), dtype=torch.float64, device=dev)
    for a in range(0, q.shape[0], 1 << 22):
        b = a + (1 << 22)
        wsum.index_add_(0, q[a:b], table[j[a:b]].to(torch.float64) * w[a:b, None])
    feat = table[rows].to(torch.float64) + wsum / k.clamp_min(1.0)[:, None]
    blocks = []
    for blk in range(3):
        f = feat[:, blk * NR_BINS:(blk + 1) * NR_BINS]
        s = f.sum(1, keepdim=True)
        blocks.append(torch.where(s > 0, 100.0 * f / s.clamp_min(1e-300), f))
    return torch.cat(blocks, 1).to(torch.float32), k > 0


@dataclass
class Keypoints:
    """One side's keypoints in working-row order, with their descriptors."""
    rows: torch.Tensor  # i64[n] working rows
    xyz: torch.Tensor  # f32[n, 3]
    feat: torch.Tensor  # f32[n, 33]
    valid: torch.Tensor  # bool[n]: a descriptor was formed


def describe(rows: torch.Tensor, kp: torch.Tensor, feature_radius: float,
             viewpoint: torch.Tensor) -> Keypoints:
    """FPFH-33 of one side's keypoints (kp bool[n] over its working rows)
    on its feature-scale surface."""
    voxel_f, normal_f = scales(feature_radius)
    surf, row_of = surface(rows, voxel_f)
    nrm = normals(surf, normal_f, viewpoint)
    kp_rows = torch.nonzero(kp).squeeze(1)
    srows, inv = torch.unique(row_of[kp_rows], return_inverse=True)
    feat, fv = fpfh(surf, nrm, srows, feature_radius)
    return Keypoints(rows=kp_rows, xyz=rows[kp_rows], feat=feat[inv], valid=fv[inv])


def _rows_min(d2: torch.Tensor) -> torch.Tensor:
    """Column of each row's minimum, the lowest among equal minima."""
    cols = torch.arange(d2.shape[1], device=d2.device)[None, :]
    return torch.where(d2 == d2.amin(1, keepdim=True), cols, d2.shape[1]).amin(1)


def nn1(fq, ft, qv, tv, precision: str):
    """(index i64[nq], has bool[nq]): each valid query's nearest valid train
    row by the Gram-trick distance."""
    qn = (fq * fq).sum(1)
    tn = torch.where(tv, (ft * ft).sum(1), BIG)
    idx = torch.zeros((fq.shape[0],), dtype=torch.int64, device=fq.device)
    step = max(1, _MM_SLOTS // max(ft.shape[0], 1))
    for a in range(0, fq.shape[0], step):
        d2 = (qn[a:a + step, None] + tn[None, :]
              - 2.0 * stages.matmul(fq[a:a + step], ft.T, precision))
        d2 = torch.where(tv[None, :], d2, BIG)
        idx[a:a + step] = _rows_min(d2)
    return idx, qv & bool(tv.any())


def centred(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return x - x[v].mean(0)


def knn_self(x, v, k: int, precision: str):
    """(index i64[n, k], mask bool[n, k]): each valid row's k nearest other
    valid rows by the Gram-trick distance."""
    n = x.shape[0]
    xn = (x * x).sum(1)
    idx = torch.zeros((n, k), dtype=torch.int64, device=x.device)
    d_best = torch.full((n, k), BIG, dtype=torch.float32, device=x.device)
    kk = min(k, n)
    step = max(1, _MM_SLOTS // max(n, 1))
    ids = torch.arange(n, device=x.device)
    for a in range(0, n, step):
        d2 = (xn[a:a + step, None] + xn[None, :]
              - 2.0 * stages.matmul(x[a:a + step], x.T, precision)).clamp_min(0.0)
        d2 = torch.where(v[None, :], d2, BIG)
        d2 = torch.where(ids[None, :] == ids[a:a + step, None], BIG, d2)
        vals, sel = torch.topk(d2, kk, dim=1, largest=False)
        d_best[a:a + step, :kk] = vals
        idx[a:a + step, :kk] = sel
    mask = (d_best < BIG) & v[:, None]
    return torch.where(mask, idx, 0), mask


def cluster_distances(match, has, nbq, nbq_m, nbt, nbt_m) -> torch.Tensor:
    """1 - (neighbours whose matches fall among the match's neighbours) /
    (neighbours with a match), per query row; 0 where none has a match."""
    jn, jn_m = nbt[match], nbt_m[match]
    nb_match = match[nbq]
    nb_has = has[nbq] & nbq_m
    member = ((nb_match[:, :, None] == jn[:, None, :]) & jn_m[:, None, :]).any(2)
    cc = (nb_has & member).sum(1).to(torch.float64)
    cp = nb_has.sum(1).to(torch.float64)
    return torch.where(cp > 0, 1.0 - cc / cp.clamp_min(1.0), 0.0)


def gate(src: Keypoints, tgt: Keypoints, gate_cfg: dict, precision: str) -> torch.Tensor:
    """The gated correspondences i64[c, 2] (source working row, target
    working row)."""
    ns, nt = src.rows.shape[0], tgt.rows.shape[0]
    if ns == 0 or nt == 0:
        return torch.zeros((0, 2), dtype=torch.int64, device=src.rows.device)
    i_st, m_st = nn1(src.feat, tgt.feat, src.valid, tgt.valid, precision)
    i_ts, m_ts = nn1(tgt.feat, src.feat, tgt.valid, src.valid, precision)
    kc = max(2, min(int(gate_cfg["cluster_k"]), ns - 1, nt - 1))
    kq, kq_m = knn_self(centred(src.xyz, src.valid), src.valid, kc, precision)
    kt, kt_m = knn_self(centred(tgt.xyz, tgt.valid), tgt.valid, kc, precision)
    d_i = cluster_distances(i_st, m_st, kq, kq_m, kt, kt_m)
    d_j = cluster_distances(i_ts, m_ts, kt, kt_m, kq, kq_m)[i_st]
    thr = float(gate_cfg["cluster_threshold"])
    keep = (d_i < thr) & (d_j < thr) & m_st
    K = int(gate_cfg["max_correspondences"])
    score = torch.maximum(d_i, d_j)
    if 0 < K < int(keep.sum()):
        cut = torch.sort(torch.where(keep, score, math.inf)).values[K - 1]
        keep = keep & (score <= cut)
    return torch.stack([src.rows[keep], tgt.rows[i_st[keep]]], 1)

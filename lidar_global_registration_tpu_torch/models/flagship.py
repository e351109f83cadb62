"""Staged registration (lidar_global_registration_tpu/models/flagship.py
`register_pair_staged`): its routes for ISS and keypoint-any keypoints,
with FPFH-33 or SHOT-352 descriptors.

The feature-scale ISS route, the JAX defaults (`use_iss=True`, masked
features, feature scale, cluster matching; flagship.py:1192-1206,
1504-1667, 1857-1916):

  fs_maps    per side a voxel surface at voxel_f = sqrt(pi r_f^2 / 352)
             with its input-row -> surface-row map (ops/downsample.py)
  plan       cell grids: the working clouds at the ISS radius, the
             surfaces at normal_f (and for FPFH at the feature radius)
  side       K2-K4 ISS keypoints on the working cloud, then ONE host read
             of the keypoint counts and surface sizes, and the gates
  fpfh/shot  per side: K1 normals on the surface, then FPFH (K5 SPFH over
             the keypoints' stencil, K6 combine at each keypoint's surface
             row) or SHOT (gravity frames, exact radius query on the
             surface, ops/shot.py) at the keypoints, compacted
  match_corr K7 1-NN both ways, exact top-k keypoint kNN per side, the
             cluster-consensus gate with its max_correspondences cap, the
             keypoint-cloud density as the per-pair threshold, one-sided
  ransac     batched prerejective RANSAC (correspondences or uniformity
             score), Kabsch refit

The classic masked ISS route (flagship.py:1671-1791), where the JAX
package goes with `feature_scale=False`, `cluster_matching=False`, or when
a data gate of the feature-scale route fails: per side ISS + the
need-masked K1 surface on the working cloud (point_need), then FPFH at
the keypoints; SHOT runs at the compacted keypoints over the whole
working cloud.  Matching is compacted (cluster gate or mutual), or, when
the keypoints are no minority of the rows, mutual 1-NN over full rows.

The unmasked ISS route (`masked_features=False`; flagship.py:1090-1110,
1172-1189, 1839-1855): per side ONE plan at max(normal cell, ISS radius)
for K1 over every point and K2-K4 (cellgrid.surface_iss_cells), FPFH over
every point masked to the keypoints (or SHOT at the compacted keypoints),
then the same matching region.  The feature-scale route needs the masked
features, so it is not taken.

The keypoint-any route (`use_iss=False`; flagship.py:1795-1836, 1857-1872,
1940-1957): K1 normals + density, K5 + K6 over every point, mutual K7 1-NN;
with descriptor="shot" (flagship.py:1104-1107, 1846-1852, 1929-1950) no
FPFH, SHOT over every row on the plan at the feature radius.

The staged multi-scale pyramid (`pyramid=True`, the route of the
reference's AUTO feature radius; flagship.py:1209-1503, then :1907-1915),
entered where the feature-scale route would be: ISS keypoints, a log2
bucket of each keypoint's density-derived feature radius, per occupied
bucket a voxel surface of the working cloud with its K1 normals and the
descriptors of the keypoints of that bucket and below, descriptor k-NN per
level both ways, the cross-level consensus vote (models/pyramid.py), then
the cluster gate of match_corr on the vote's winners.  A failed level gate
prints the JAX package's notice and leaves for the feature-scale route.

The grid-hash route (`use_cell_fpfh=False`; flagship.py:1083-1110,
1172-1192, 1839-1855, where the JAX package goes off the TPU): per side
_side_stage (kNN normals within the normal cell, the k = 2 density from
them, ISS keypoints by K2-K4), then FPFH over every point at the keypoints
(ops/fpfh.py: K5's full pass and the float32 combine) or SHOT in the
matching region, then the same matching region.

The solver stage is the prerejective RANSAC above or, with
alignment="gror", GROR over the whole correspondence set (models/gror.py;
flagship.py:802-829, 1951-1957).

With bf16_matching every descriptor 1-NN is the bf16 matcher (K7 on
bfloat16-rounded copies, ops/nn_l2.py).  lrf="gt" is not gravity: SHOT
takes its own LRF on the staged path, as in the JAX package
(flagship.py:465, 1169).

The one-graph entry points of the JAX package run on _side_stage too:
register_pair_step (flagship.py:408-519: FPFH or SHOT over the rows at the
keypoints, 1-NN both ways, the cluster filter over full rows or the mutual
filter, RANSAC) and register_pair_two_stage (:1969-2028: the step with
FPFH and the mutual filter).  There are no learned weights: what
carries over from the JAX package is its config (`config_from_jax`) and
the radii (ops/density.derive_radii).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from lidar_global_registration_tpu_torch.models.gror import gror_solve
from lidar_global_registration_tpu_torch.models.pyramid import (
    _cluster_distances,
    _consensus_vote,
    _first_argmax,
)
from lidar_global_registration_tpu_torch.models.ransac import (
    MIN_INLIER_RATE,
    MIN_NR_FINAL_INLIERS,
    MIN_NR_INLIERS,
    ransac_rounds,
)
from lidar_global_registration_tpu_torch.ops import cellgrid, matchers
from lidar_global_registration_tpu_torch.ops.density import knn_window
from lidar_global_registration_tpu_torch.ops.downsample import (
    voxel_centroids_map,
    voxel_centroids_packed,
)
from lidar_global_registration_tpu_torch.ops.grid import radius_neighbors
from lidar_global_registration_tpu_torch.ops.lrf import gravity_lrf
from lidar_global_registration_tpu_torch.ops.metrics import (
    transform_points_soa,
    uniformity_bins,
    uniformity_entropy,
)
from lidar_global_registration_tpu_torch.ops.normals import normals_from_neighbors
from lidar_global_registration_tpu_torch.ops.shot import shot
from lidar_global_registration_tpu_torch.ops.transform import kabsch, to_matrix4
from lidar_global_registration_tpu_torch.types import FEATURE_NR_POINTS, NORMAL_NR_POINTS
from lidar_global_registration_tpu_torch.utils import profiling

BIG = 3.0e38


@dataclass(frozen=True)
class FlagshipConfig:
    """The fields of the JAX FlagshipConfig the ported routes read, with
    the JAX defaults.  Every setting of use_iss, masked_features,
    feature_scale, cluster_matching, pyramid, descriptor, lrf, alignment
    ("ransac" | "gror"), bf16_matching and use_cell_fpfh runs."""

    rounds: int = 8
    hypothesis_batch: int = 512
    n_samples: int = 3
    edge_thr: float = 0.95
    confidence: float = 0.999
    use_iss: bool = True
    bf16_matching: bool = False
    match_tile: int = 2048
    use_cell_fpfh: bool = True
    masked_features: bool = True
    feature_scale: bool = True
    cluster_matching: bool = True
    cluster_k: int = 40
    cluster_threshold: float = 0.95
    # the JAX package's approximate keypoint kNN and its train tile; the
    # port's kNN is always exact, so it reads neither
    cluster_approx_knn: bool = True
    cluster_knn_tile: int = 32768
    max_correspondences: int = 1024
    metric: str = "correspondences"
    descriptor: str = "fpfh"  # fpfh | shot
    # SHOT frames: gravity (+ SHOT-LRF fallback); any other value (default,
    # gt) the SHOT LRF, as the JAX staged path reads it
    lrf: str = "gravity"
    shot_k: int = 512  # SHOT neighbours per keypoint (the k nearest within r)
    # the JAX package's per-cell candidate cap of its SHOT query; the port's
    # query is exact and uncapped, so it does not read it
    shot_cap: int = 128
    uniformity_top: int = 64
    degree_top: int = 800
    ransac_compact: int = 4096
    alignment: str = "ransac"
    # the multi-scale pyramid (matching.h:163-354) in place of the single
    # feature-scale surface, where that route would be taken
    pyramid: bool = False
    scale_factor: float = 2.0  # pyramid level base (config `scale`)
    pyramid_randomness: int = 1  # k-NN candidates per level entering the vote


def config_from_jax(cfg: dict) -> FlagshipConfig:
    """The port's config from `dataclasses.asdict(jax_flagship_config)`:
    the fields the ported routes read are copied, the rest (which only
    other routes read) are dropped."""
    names = {f.name for f in dataclasses.fields(FlagshipConfig)}
    return FlagshipConfig(**{k: v for k, v in cfg.items() if k in names})


# ---------------------------------------------------------------------------
# compaction helpers and the loader-equivalent pre-downsample
# ---------------------------------------------------------------------------
def _pad_quantum(a: int) -> int:
    """A count padded to a ~12.5 %-granularity bucket (flagship._pad_quantum)."""
    a = max(a, 1)
    m = max(1024, 1 << max(a.bit_length() - 3, 0))
    return int(-(-a // m) * m)


def _compact_rows(v: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """First m row ids of the valid prefix (stable: ascending row order);
    padding entries hold the out-of-bounds sentinel v.shape[0]
    (flagship._compact_rows).  i64[m]."""
    n0 = v.shape[0]
    idx = torch.argsort((~v).to(torch.int8), stable=True)[:m]
    if m > n0:
        idx = torch.cat([idx, torch.full((m - n0,), n0, dtype=idx.dtype, device=v.device)])
    return torch.where(torch.arange(m, device=v.device) < n, idx, n0)


def _compact_xyz(xyz: torch.Tensor, valid: torch.Tensor, n: int, m: int):
    """(xyz, valid) of the first m valid-prefix rows (flagship._compact_xyz)."""
    n0 = xyz.shape[0]
    sj = _compact_rows(valid, n, m)
    g = sj.clamp_max(n0 - 1)
    return xyz[g], valid[g] & (sj < n0)


def _aabb_pair(src_xyz, src_valid, tgt_xyz, tgt_valid) -> torch.Tensor:
    """Masked bounding boxes f32[2 sides, (lo, hi), 3] (flagship._aabb_pair)."""
    big = 3.0e37

    def one(xyz, valid):
        lo = torch.where(valid[:, None], xyz, big).amin(0)
        hi = torch.where(valid[:, None], xyz, -big).amax(0)
        lo = torch.where(torch.isfinite(lo), lo, 0.0)
        hi = torch.where(torch.isfinite(hi), hi, 0.0)
        return torch.stack([lo, hi])

    return torch.stack([one(src_xyz, src_valid), one(tgt_xyz, tgt_valid)])


def pre_downsample_pair(src_xyz, src_valid, tgt_xyz, tgt_valid, voxel_src: float,
                        voxel_tgt: float, aabb=None):
    """Loader-equivalent fine pre-downsample (flagship.pre_downsample_pair;
    the reference voxels each scan at 2 x density before aligning,
    common.cpp:444-464).  The grid anchors at each side's AABB lo -
    voxel / 2, as the JAX package's packed route; `aabb` (host [2, 2, 3])
    skips the bounds read.  Returns compacted (xyz, valid) per side, both
    at one capacity padded to a ~12.5 % count quantum."""
    if src_xyz.shape[0] != tgt_xyz.shape[0]:
        raise ValueError(
            f"pre_downsample_pair requires equal padded capacities "
            f"(got {src_xyz.shape[0]} vs {tgt_xyz.shape[0]}); pad both sides "
            "to one shared capacity first"
        )
    with profiling.span("lgr.pre_downsample"):
        if aabb is None:
            aabb = _aabb_pair(src_xyz, src_valid, tgt_xyz, tgt_valid).cpu().numpy()
        aabb = np.asarray(aabb, np.float32)

        def down(xyz, valid, voxel, lo):
            # float32 arithmetic of the JAX host code: f32 lo - f32(voxel / 2)
            origin = torch.from_numpy(lo - np.float32(0.5 * voxel)).to(xyz.device)
            return voxel_centroids_packed(xyz, valid, voxel, origin)

        dx_s, dv_s, n_s = down(src_xyz, src_valid, voxel_src, aabb[0, 0])
        dx_t, dv_t, n_t = down(tgt_xyz, tgt_valid, voxel_tgt, aabb[1, 0])
        n_s, n_t = (int(v) for v in torch.stack([n_s, n_t]).tolist())  # one host read
        m = min(max(_pad_quantum(n_s), _pad_quantum(n_t)), src_xyz.shape[0])
        sx, sv = _compact_xyz(dx_s, dv_s, n_s, m)
        tx, tv = _compact_xyz(dx_t, dv_t, n_t, m)
        return sx, sv, tx, tv


# ---------------------------------------------------------------------------
# correspondences
# ---------------------------------------------------------------------------
def _subset_sel(cvalid: torch.Tensor, M: int) -> torch.Tensor:
    """Rows compacting a masked correspondence set to M: valid rows first in
    row order; with more than M valid, an evenly strided sample over row
    order (flagship._subset_sel)."""
    sel = torch.argsort((~cvalid).to(torch.int8), stable=True)
    K = int(cvalid.sum())
    ar = torch.arange(M, dtype=torch.int64, device=cvalid.device)
    if K > M:
        ar = ar * (K // M) + (ar * (K % M)) // M
    return sel[ar]


def _correspondence_stage(idx_st, mask_st, idx_ts, mask_ts, dens_s, dens_t,
                          distance_thr: float, require_mutual: bool = True):
    """Matched pairs and per-pair thresholds min(max(density_s, density_t),
    distance_thr) (flagship._correspondence_stage): mutual 1-NN (lr
    strategy, matching.h:418-458), or one-sided for the cluster strategy
    (matching.h:480-551)."""
    N = idx_st.shape[0]
    j = idx_st[:, 0]
    keep = mask_st[:, 0]
    if require_mutual:
        keep = keep & mask_ts[j, 0] & (idx_ts[j, 0] == torch.arange(N, device=j.device))
    thr = torch.minimum(torch.maximum(dens_s, dens_t[j]),
                        torch.tensor(distance_thr, dtype=torch.float32, device=j.device))
    thr = torch.where(thr > 0, thr, distance_thr)
    return j, keep, thr


def _consensus_keep(i_st0, m_st0, i_ts0, m_ts0, kq, kt, cfg: FlagshipConfig):
    """The cluster gate (flagship._consensus_keep, ClusterMatcher,
    matching.h:480-551): both directions' consensus distances below
    cluster_threshold, then the max_correspondences most consistent
    survivors (every row at or below the K-th score, so ties may exceed
    K).  kq / kt = (idx, dist, mask) self-excluded keypoint kNN per side.
    Returns keep_q over source-direction rows."""
    kq_idx, _d1, kq_m = kq
    kt_idx, _d2, kt_m = kt
    d_i = _cluster_distances(i_st0, m_st0, kq_idx, kq_m, kt_idx, kt_m)
    d_j = _cluster_distances(i_ts0, m_ts0, kt_idx, kt_m, kq_idx, kq_m)
    thr_c = cfg.cluster_threshold
    score_q = torch.maximum(d_i, d_j[i_st0])
    keep_q = (d_i < thr_c) & (d_j[i_st0] < thr_c) & m_st0
    K = cfg.max_correspondences
    if 0 < K < score_q.shape[0]:
        sq = torch.where(keep_q, score_q, torch.inf)
        keep_q = keep_q & (sq <= torch.sort(sq).values[K - 1])
    return keep_q


def _kp_density_nearest(kn_idx, kn_d, kn_m):
    """k=2-smoothed keypoint-cloud density from a self-excluded 1-NN
    (flagship._kp_density_nearest, matching.h:396-397)."""
    d_raw = torch.where(kn_m[:, 0], kn_d[:, 0], 0.0)
    d_nn = torch.where(kn_m[:, 0], d_raw[kn_idx[:, 0]], d_raw)
    return torch.minimum(d_raw, torch.where(d_nn > 0, d_nn, d_raw))


def _centred(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x minus the mean of its valid rows, as the JAX stage computes it."""
    mean = torch.where(v[:, None], x, 0.0).mean(0)
    return x - mean / v.to(torch.float32).mean().clamp_min(1e-9)


def _no_stage(label: str):
    """The stage of a block run outside register_pair_staged's stages."""
    return contextlib.nullcontext()


def _nn_both_ways(fq, ft, qv, tv, cfg: FlagshipConfig, _t=_no_stage):
    """Descriptor 1-NN both ways (the bf16 matcher with cfg.bf16_matching),
    each direction a stage of _t and a span lgr.match.descriptor_nn.
    Returns (idx_st, mask_st, idx_ts, mask_ts), each [rows, 1]."""
    with _t("match_st"), profiling.span("lgr.match.descriptor_nn"):
        idx_st, _d1, mask_st = matchers.match_bf(fq, ft, qv, tv, k=1, tile=cfg.match_tile,
                                                 bf16=cfg.bf16_matching)
    with _t("match_ts"), profiling.span("lgr.match.descriptor_nn"):
        idx_ts, _d2, mask_ts = matchers.match_bf(ft, fq, tv, qv, k=1, tile=cfg.match_tile,
                                                 bf16=cfg.bf16_matching)
    return idx_st, mask_st, idx_ts, mask_ts


def _compact_match_corr_stage(fqc, ftc, qv, tv, sqj, stj, sq_g, st_g, src_xyz, tgt_xyz,
                              dens_s, dens_t, distance_thr: float, cfg: FlagshipConfig,
                              kc: int, cand=None):
    """The compacted matching region (flagship._compact_match_corr_stage):
    descriptor 1-NN both ways on the compacted rows, or, given
    cand = (ic_st, mc_st, ic_ts, mc_ts) ([M, 1] each, the pyramid's vote
    winners), those in their place (fqc / ftc are then None); with cluster
    matching the consensus filter over the keypoints' exact kc-NN (self
    excluded by id, keypoints centred per side) and the keypoint-cloud
    density as threshold; then the scatter back to full rows and the
    correspondence stage (one-sided with cluster matching, mutual
    without).  Spans: lgr.match.descriptor_nn (the 1-NN), lgr.match.gate_knn
    (the keypoint kNN) and lgr.match.consensus (the rest)."""
    N_all = src_xyz.shape[0]
    dev = src_xyz.device
    if cand is not None:
        ic_st, mc_st, ic_ts, mc_ts = cand
    else:
        ic_st, mc_st, ic_ts, mc_ts = _nn_both_ways(fqc, ftc, qv, tv, cfg)
    clustered = cfg.use_iss and cfg.cluster_matching
    if clustered:
        with profiling.span("lgr.match.gate_knn"):
            ksq = _centred(src_xyz[sq_g], qv)
            kst = _centred(tgt_xyz[st_g], tv)
            kq = matchers.match_bf(ksq, ksq, qv, qv, k=kc, exclude_diag=True)
            kt = matchers.match_bf(kst, kst, tv, tv, k=kc, exclude_diag=True)
    with profiling.span("lgr.match.consensus"):
        if clustered:
            keep_q = _consensus_keep(ic_st[:, 0], mc_st[:, 0], ic_ts[:, 0], mc_ts[:, 0],
                                     kq, kt, cfg)
            mc_st = mc_st & keep_q[:, None]
            # the thresholds need each keypoint's exact nearest keypoint: column 0
            # of the exact kNN (the JAX package reruns an exact 1-NN after its
            # approximate consensus kNN)
            rq, rt = sqj < N_all, stj < N_all
            dens_s = dens_s.clone()
            dens_t = dens_t.clone()
            dens_s[sqj[rq]] = _kp_density_nearest(*(a[:, :1] for a in kq))[rq]
            dens_t[stj[rt]] = _kp_density_nearest(*(a[:, :1] for a in kt))[rt]
        zi = torch.zeros((N_all, 1), dtype=torch.int64, device=dev)
        zm = torch.zeros((N_all, 1), dtype=torch.bool, device=dev)
        rq = sqj < N_all
        idx_st, mask_st = zi.clone(), zm.clone()
        idx_st[sqj[rq], 0] = st_g[ic_st[rq, 0]]
        mask_st[sqj[rq], 0] = (mc_st[:, 0] & qv)[rq]
        idx_ts, mask_ts = zi, zm
        if not clustered:
            rt = stj < N_all
            idx_ts, mask_ts = zi.clone(), zm.clone()
            idx_ts[stj[rt], 0] = sq_g[ic_ts[rt, 0]]
            mask_ts[stj[rt], 0] = (mc_ts[:, 0] & tv)[rt]
        return _correspondence_stage(idx_st, mask_st, idx_ts, mask_ts, dens_s, dens_t,
                                     distance_thr, require_mutual=not clustered)


def _corr_export(j, keep, thr, M: int):
    """Compacted (query row, matched row, threshold, valid) of the
    correspondence set, valid rows first in row order (flagship._corr_export)."""
    sel = _subset_sel(keep, M)
    return sel, j[sel], thr[sel], keep[sel]


def _corr_subset(p, q, cvalid, M: int):
    """ransac_solve's compaction, alone, for the GROR solver stage
    (flagship._corr_subset)."""
    sel = _subset_sel(cvalid, M)
    return p[sel], q[sel], cvalid[sel]


def _gror_stage(p, q, cvalid, distance_thr: float, cfg: FlagshipConfig):
    """The GROR solver stage (flagship._gror_stage; alignment: gror,
    alignment.cpp:21-35): the graph-reliability search with resolution =
    distance_thr over the correspondence set compacted to its FULL realised
    count (padded to a count quantum), never a subsample: the reference
    ranks its top 800 nodes over all correspondences (ia_gror.hpp:126-194),
    and gror_solve's degree pass is chunked by rows.  Returns
    ransac_solve's keys."""
    n = int(cvalid.sum())
    M = min(_pad_quantum(max(n, 1)), p.shape[0])
    if M < p.shape[0]:
        p, q, cvalid = _corr_subset(p, q, cvalid, M)
    return gror_solve(p, q, cvalid, float(distance_thr))


# ---------------------------------------------------------------------------
# RANSAC
# ---------------------------------------------------------------------------
def _pdist(a: torch.Tensor) -> torch.Tensor:
    """Pairwise distances by the Gram trick (full float32: TF32 is off)."""
    g = a @ a.T
    n2 = torch.diagonal(g)
    return (n2[:, None] + n2[None, :] - 2.0 * g).clamp_min(0.0).sqrt()


def ransac_solve(p, q, thr, cvalid, generator: torch.Generator, cfg: FlagshipConfig):
    """Batched prerejective RANSAC over masked correspondences
    (flagship.ransac_solve).  cfg.metric scores the hypotheses by inlier
    count / n, or by the uniformity of the inliers' source points (the
    3-axis projected entropy, metric.cpp:167-179, of the uniformity_top
    count-ranked hypotheses of each round) with its min-tolerable 0.3 gate
    (metric.h:98).  The JAX package's on-device while_loop becomes
    models/ransac.ransac_rounds over at most cfg.rounds rounds, with one
    host read per round (best metric of the round and the new iteration
    estimate)."""
    if cfg.ransac_compact and cfg.ransac_compact < p.shape[0]:
        sel = _subset_sel(cvalid, cfg.ransac_compact)
        p, q, thr, cvalid = p[sel], q[sel], thr[sel], cvalid[sel]
    if cfg.degree_top and cfg.degree_top < p.shape[0] <= 8192:
        # GROR-style node-reliability prefilter (ia_gror.hpp:126-194):
        # keep the correspondences with the most length-consistent partners;
        # centred first so the Gram trick keeps the geometry in float32
        pv = cvalid.to(torch.float32)
        nv = pv.sum().clamp_min(1.0)
        pc = (p - (p * pv[:, None]).sum(0) / nv) * pv[:, None]
        qc = (q - (q * pv[:, None]).sum(0) / nv) * pv[:, None]
        eps_ij = 2.0 * torch.maximum(thr[:, None], thr[None, :])
        consistent = ((_pdist(pc) - _pdist(qc)).abs() < eps_ij) & cvalid[None, :] & cvalid[:, None]
        deg = consistent.sum(1)
        kth = torch.sort(deg).values[-cfg.degree_top]
        cvalid = cvalid & (deg >= torch.clamp_min(kth, 3))
    dev = p.device
    uniformity = cfg.metric == "uniformity"
    if uniformity:
        big = 3.0e37
        lo = torch.where(cvalid[:, None], p, big).amin(0)
        hi = torch.where(cvalid[:, None], p, -big).amax(0)
        ok_bb = lo <= hi
        bins3 = uniformity_bins(p, torch.where(ok_bb, lo, 0.0), torch.where(ok_bb, hi, 1.0))
    min_tolerable = 0.3 if uniformity else 0.0
    n_corr = cvalid.to(torch.float32).sum()
    order = torch.argsort((~cvalid).to(torch.int8), stable=True)  # valid rows first
    nvalid = max(int(n_corr), 1)
    B, S = cfg.hypothesis_batch, cfg.n_samples

    def score(R, t, ok):
        tx, ty, tz = transform_points_soa(R, t, p)
        d2 = (tx - q[:, 0][None]) ** 2 + (ty - q[:, 1][None]) ** 2 + (tz - q[:, 2][None]) ** 2
        inl = (d2.clamp_min(0.0).sqrt() < thr[None]) & cvalid[None]
        cnt = inl.sum(1)
        alive = ok & (cnt >= MIN_NR_INLIERS)
        support = torch.where(alive, cnt, 0).max()
        if not uniformity:
            return torch.where(alive, cnt.to(torch.float32) / n_corr.clamp_min(1.0), -1.0), support
        # the top uniformity_top by count, ties to the lowest index (lax.top_k)
        top = torch.sort(torch.where(alive, cnt, -1), descending=True,
                         stable=True).indices[:min(cfg.uniformity_top, B)]
        ent = uniformity_entropy(inl[top], bins3)
        metric = torch.full((B,), -1.0, dtype=torch.float32, device=dev)
        metric[top] = torch.where(alive[top], ent, -1.0)
        return metric, support

    best_metric, best_R, best_t, iters, _est = ransac_rounds(
        p, q, generator, nvalid, B, S, cfg.edge_thr, cfg.confidence, n_corr, cfg.rounds,
        float(cfg.rounds * B), score, order=order,
        best=(-1.0, torch.eye(3, device=dev), torch.zeros(3, device=dev)))

    # final: rebuild inliers, Kabsch refit, convergence gates (sac:265-296)
    def _inliers(Rm, tv):
        tx, ty, tz = transform_points_soa(Rm[None], tv[None], p)
        tp = torch.stack([tx[0], ty[0], tz[0]], -1)
        return (((tp - q) ** 2).sum(-1).clamp_min(0.0).sqrt() < thr) & cvalid

    inl = _inliers(best_R, best_t)
    n_inl = inl.sum()
    Rf, tf = kabsch(p[None], q[None], inl.to(torch.float32)[None])
    T = to_matrix4(Rf[0], tf[0])
    inl2_mask = _inliers(Rf[0], tf[0])
    inl2 = inl2_mask.sum()
    if uniformity:
        metric = uniformity_entropy(inl2_mask[None], bins3)[0]
    else:
        metric = inl2.to(torch.float32) / n_corr.clamp_min(1.0)
    # the convergence gate reads the PRE-refit inliers while the returned
    # pose and metric come from the refit, as the reference does (sac:276-282)
    converged = ((n_inl > MIN_NR_FINAL_INLIERS)
                 | (n_inl.to(torch.float32) > MIN_INLIER_RATE * n_corr)) & (
                     best_metric > min_tolerable)
    if not best_metric > min_tolerable:
        T = torch.eye(4, device=dev)
    return {
        "transformation": T,
        "metric": metric,
        "inliers": inl2,
        "converged": converged,
        "n_correspondences": n_corr,
        "iterations": iters,
    }


# ---------------------------------------------------------------------------
# register_pair_staged
# ---------------------------------------------------------------------------
class _GateFailed(Exception):
    """A data gate of the feature-scale route or of the staged pyramid
    failed: the JAX package prints its notice and takes the classic masked
    route (flagship.py:1594-1607, 1668-1670), or from the pyramid the
    feature-scale route (:1501-1503)."""


def _shot_stage(kp_xyz, kp_normal, kpv, surf_xyz, surf_normal, surf_valid, radius: float,
                cfg: FlagshipConfig, plan=None):
    """SHOT-352 at the (compacted) keypoints over the support surface
    (flagship._shot_stage + _shot_side_fused, shot_debug.cpp:24-219): with
    lrf='gravity' the frames are z = keypoint normal, y = gravity x z
    (common.cpp:712-734), and the SHOT LRF over the same neighbours where
    the normal lies within 0.04 rad of gravity.  The JAX package sizes its
    per-cell candidate cap from the support's spacing; the port's query is
    exact, so it needs none.  `plan`: a plan of the support at `radius`."""
    frames = needs_fb = None
    if cfg.lrf == "gravity":
        frames, needs_fb = gravity_lrf(kp_normal)
    return shot(kp_xyz, kpv, surf_xyz, surf_normal, surf_valid, radius, frames=frames,
                k_neighbors=cfg.shot_k, fallback_mask=needs_fb, plan=plan)


_NORMAL_ROWS = 1 << 18  # query rows per block of _side_stage's covariances
# _side_stage's normals: the nearest points within the normal cell (the JAX
# FlagshipConfig.normal_k default).  The JAX package's cell caps and
# neighbour counts of its capped ISS and FPFH queries (neighbor_cap,
# iss_neighbors, feature_neighbors, feature_cap) are not carried: the port's
# ISS and FPFH take every neighbour within the radius
_NORMAL_K = 16


def _density_from_knn(idx, dist, mask, valid, gather_rows=None):
    """The k = 2 smoothed density (common.cpp:531-547) from the normals'
    neighbour lists (flagship._density_from_knn): d = the distance to the
    nearest neighbour that is not the point itself (d > 1e-12), smoothed
    by the min with that neighbour's own d; 0 where no neighbour lies in the
    lists.  gather_rows: for a caller holding a shard of the rows (idx are
    rows of the whole cloud; parallel/batch.py), maps the shard's d to the
    whole cloud's, where the smoothing neighbour may lie on another peer's
    shard.  f32[rows]."""
    seen = mask & (dist > 1e-12)
    dmat = torch.where(seen, dist, BIG)
    a = _first_argmax(-dmat)[:, None]  # the first of equal minima, as jnp.argmin
    d_raw = dmat.gather(1, a)[:, 0]
    nn = idx.gather(1, a)[:, 0]
    has = seen.any(1)
    d_nn = (d_raw if gather_rows is None else gather_rows(d_raw))[nn]
    out = torch.minimum(d_raw, torch.where(d_nn < BIG, d_nn, d_raw))
    return torch.where(valid & has & (out < BIG), out, 0.0)


def _widen(idx, dist, mask, gather):
    """Neighbour lists [rows, K] of a shard padded (0, BIG, False) to the
    widest of the peers' K (gather: parallel/batch.py's), the width the
    whole cloud's query gives them, so each row's float32 sums run over the
    one-process step's blocks."""
    k = idx.shape[1]
    width = int(gather(torch.tensor([k], device=idx.device)).max())
    if width == k:
        return idx, dist, mask
    pad = (idx.shape[0], width - k)
    return (torch.cat([idx, idx.new_zeros(pad)], 1), torch.cat([dist, dist.new_full(pad, BIG)], 1),
            torch.cat([mask, mask.new_zeros(pad)], 1))


def _side_stage(xyz, valid, normal_cell: float, iss_radius: float, cfg: FlagshipConfig,
                viewpoint=None, rows: slice | None = None, gather=None):
    """One side's normals, keypoints and density off the cell kernels'
    fused pass (flagship._side_stage): the _NORMAL_K nearest points within
    the normal cell (ops/grid.radius_neighbors, exact; the JAX package keeps
    neighbor_cap points a cell), their PCA normals oriented to the
    viewpoint, the k = 2 density from the same lists, and the ISS keypoints
    (use_iss: K2-K4 on a plan at the ISS radius, every neighbour within it;
    the JAX package takes iss_neighbors within neighbor_cap a cell) or every
    valid row.  Returns (normal f32[N, 3], kp bool[N], density f32[N]).

    rows, gather: a tp peer's share (parallel/batch.py): the products of
    input rows `rows` only, ISS through cellgrid.iss_pass's slot-list
    forms, and gather (a shard's per-row values -> the whole cloud's, in
    row order) returns the whole cloud's, the one-process step's bit for
    bit."""
    plan = cellgrid.plan_grid(xyz, valid, normal_cell)
    xyz_l, valid_l = (xyz, valid) if rows is None else (xyz[rows], valid[rows])
    idx, dist, mask = radius_neighbors(plan, xyz_l, valid_l, float(normal_cell), _NORMAL_K)
    if gather is not None:
        idx, dist, mask = _widen(idx, dist, mask, gather)
    normal = torch.zeros_like(xyz_l)
    for a in range(0, xyz_l.shape[0], _NORMAL_ROWS):
        b = a + _NORMAL_ROWS
        normal[a:b] = normals_from_neighbors(xyz_l[a:b], xyz, idx[a:b], mask[a:b], viewpoint)[0]
    density = _density_from_knn(idx, dist, mask, valid_l, gather_rows=gather)
    if cfg.use_iss:
        kp = cellgrid.iss_pass(cellgrid.plan_grid(xyz, valid, iss_radius), iss_radius,
                               rows=rows, gather=gather)[0]
    else:
        kp = valid
    if gather is None:
        return normal, kp, density
    return gather(normal), kp, gather(density)


def _fpfh_fixed(xyz, normal, valid, kp, radius: float):
    """FPFH-33 over the cloud at the rows where kp holds
    (flagship._fpfh_fixed): ops/fpfh.fpfh with the cloud as its own
    surface, K5's full pass and the float32 combine over every neighbour
    within r (the JAX package keeps feature_neighbors within feature_cap a
    cell).  Returns (feat f32[N, 33], valid bool[N])."""
    from lidar_global_registration_tpu_torch.ops.fpfh import fpfh

    return fpfh(xyz, valid & kp, xyz, normal, valid, radius, kp_normal=normal)


def _restore_rows(ec, n_rows: int):
    """Full-row (feat, valid) from a side's compacted tuple (n, sj, g, v,
    feat) (flagship.py:1773-1779)."""
    _n, sj, _g, v, featc = ec
    keep = sj < n_rows
    f = torch.zeros((n_rows, featc.shape[1]), dtype=featc.dtype, device=featc.device)
    f[sj[keep]] = featc[keep]
    fv = torch.zeros((n_rows,), dtype=torch.bool, device=featc.device)
    fv[sj[keep]] = v[keep]
    return f, fv


def _match_region(src, tgt, fq, fq_valid, ft, ft_valid, ec_q, ec_t, dens_s, dens_t,
                  radii, cfg, _t):
    """Keypoint compaction and matching (flagship.py:1857-1950).  src / tgt
    = (xyz, valid, normal, support plan at the feature radius).  Per side
    either full rows (fq [N, D] or None for SHOT, fq_valid) or a compacted
    tuple ec = (n, sj, g, v, feat).  When both sides hold between 1 and
    N/2 descriptor rows they are matched compacted (SHOT computed there,
    at the compacted keypoints over the whole cloud), with the cluster
    gate under cluster matching; otherwise SHOT (if any) runs over every
    masked row and the full rows are matched by mutual 1-NN."""
    feature_radius, distance_thr = radii[5], radii[6]
    src_xyz, src_valid, src_normal, pf_s = src
    tgt_xyz, tgt_valid, tgt_normal, pf_t = tgt
    shot_mode = cfg.descriptor == "shot"
    N_all = src_valid.shape[0]
    if ec_q is not None and ec_t is not None:
        n_q, n_t = ec_q[0], ec_t[0]
    else:
        n_q, n_t = (int(v) for v in torch.stack([fq_valid.sum(), ft_valid.sum()]).tolist())
    if min(n_q, n_t) > 0 and max(n_q, n_t) <= N_all // 2:
        if ec_q is not None and ec_t is not None:
            (_, sqj, sq_g, qv, fqc), (_, stj, st_g, tv, ftc) = ec_q, ec_t
        else:
            mq, mt = _pad_quantum(n_q), _pad_quantum(n_t)
            # padding rows point at N_all: gathers clamp, scatters drop them
            sqj = _compact_rows(fq_valid, n_q, mq)
            stj = _compact_rows(ft_valid, n_t, mt)
            sq_g, st_g = sqj.clamp_max(N_all - 1), stj.clamp_max(N_all - 1)
            qv = torch.arange(mq, device=sqj.device) < n_q
            tv = torch.arange(mt, device=stj.device) < n_t
            if shot_mode:
                with _t("shot_src"):
                    fqc, ok_q = _shot_stage(src_xyz[sq_g], src_normal[sq_g], qv, src_xyz,
                                            src_normal, src_valid, feature_radius, cfg, plan=pf_s)
                with _t("shot_tgt"):
                    ftc, ok_t = _shot_stage(tgt_xyz[st_g], tgt_normal[st_g], tv, tgt_xyz,
                                            tgt_normal, tgt_valid, feature_radius, cfg, plan=pf_t)
                qv, tv = qv & ok_q, tv & ok_t
            else:
                fqc, ftc = fq[sq_g], ft[st_g]
        kc = max(2, min(cfg.cluster_k, n_q - 1, n_t - 1))
        with _t("match_corr"):
            return _compact_match_corr_stage(fqc, ftc, qv, tv, sqj, stj, sq_g, st_g, src_xyz,
                                             tgt_xyz, dens_s, dens_t, distance_thr, cfg, kc)
    if cfg.use_iss and cfg.cluster_matching:
        print(f"# cluster matching -> mutual 1-NN fallback: {n_q}/{n_t} keypoints of {N_all} "
              "rows exceed the compaction precondition", flush=True)
    if shot_mode:
        with _t("shot_src"):
            fq, fq_valid = _shot_stage(src_xyz, src_normal, fq_valid, src_xyz, src_normal,
                                       src_valid, feature_radius, cfg, plan=pf_s)
        with _t("shot_tgt"):
            ft, ft_valid = _shot_stage(tgt_xyz, tgt_normal, ft_valid, tgt_xyz, tgt_normal,
                                       tgt_valid, feature_radius, cfg, plan=pf_t)
    idx_st, mask_st, idx_ts, mask_ts = _nn_both_ways(fq, ft, fq_valid, ft_valid, cfg, _t)
    with _t("corr"), profiling.span("lgr.match.consensus"):
        return _correspondence_stage(idx_st, mask_st, idx_ts, mask_ts, dens_s, dens_t,
                                     distance_thr)


def _any_route(src_xyz, src_valid, tgt_xyz, tgt_valid, radii, vp_src, vp_tgt, cfg, _t):
    """Keypoint-any: surface + FPFH over every point, mutual 1-NN
    (flagship.py:1795-1836); in shot mode (flagship.py:1104-1107,
    1846-1852) the surface alone, every valid row a keypoint, and the
    matching region computes SHOT over them on the plan at the feature
    radius."""
    normal_cell, feature_radius = radii[0], radii[5]
    shot_mode = cfg.descriptor == "shot"
    with _t("plan"):
        plans = [cellgrid.plan_grid(x, v, c)
                 for x, v in ((src_xyz, src_valid), (tgt_xyz, tgt_valid))
                 for c in (normal_cell, feature_radius)]

    def side(plan_n, plan_f, valid, vp, which):
        with _t(f"side_{which}"):
            normal, _curv, density, _eig, _ok = cellgrid.surface_pass(plan_n, normal_cell, vp)
        if shot_mode:
            return normal, density, None, valid
        with _t(f"fpfh_{which}"):
            feat, fv = cellgrid.fpfh_pass(cellgrid.set_normals(plan_f, normal), feature_radius)
        return normal, density, feat, fv & valid

    src_normal, dens_s, fq, fq_valid = side(plans[0], plans[1], src_valid, vp_src, "src")
    tgt_normal, dens_t, ft, ft_valid = side(plans[2], plans[3], tgt_valid, vp_tgt, "tgt")
    return _match_region((src_xyz, src_valid, src_normal, plans[1]),
                         (tgt_xyz, tgt_valid, tgt_normal, plans[3]),
                         fq, fq_valid, ft, ft_valid, None, None, dens_s, dens_t, radii, cfg, _t)


def _feature_scale_route(src_xyz, src_valid, tgt_xyz, tgt_valid, radii, vp_src, vp_tgt, cfg,
                         _t):
    """ISS keypoints + descriptors on the feature-scale voxel surface +
    cluster matching (flagship.py:1504-1667, then :1857-1916).  Raises
    _GateFailed where the JAX package leaves for the classic masked route:
    keypoint counts outside (0, N/2], or a surface that keeps more than
    0.8 of its cloud's rows."""
    (_normal_cell, _dens_s, _dens_t, iss_radius_src, iss_radius_tgt, feature_radius,
     distance_thr) = radii
    shot_mode = cfg.descriptor == "shot"
    voxel_f = float(math.sqrt(math.pi * feature_radius**2 / FEATURE_NR_POINTS))
    # NORMAL_NR-point disks on a grid of spacing voxel_f
    normal_f = float(math.sqrt(NORMAL_NR_POINTS / math.pi)) * voxel_f
    N_all = src_valid.shape[0]
    with _t("fs_maps"):
        sm_xyz_s, sm_v_s, row_of_s, n_sm_s = voxel_centroids_map(src_xyz, src_valid, voxel_f)
        sm_xyz_t, sm_v_t, row_of_t, n_sm_t = voxel_centroids_map(tgt_xyz, tgt_valid, voxel_f)
    with _t("plan"):
        pi_s = cellgrid.plan_grid(src_xyz, src_valid, iss_radius_src)
        pi_t = cellgrid.plan_grid(tgt_xyz, tgt_valid, iss_radius_tgt)
        pns_s = cellgrid.plan_grid(sm_xyz_s, sm_v_s, normal_f)
        pns_t = cellgrid.plan_grid(sm_xyz_t, sm_v_t, normal_f)
        # SHOT plans its own query grid on the sliced surface (in shot_*)
        pfs_s = pfs_t = None
        if not shot_mode:
            pfs_s = cellgrid.plan_grid(sm_xyz_s, sm_v_s, feature_radius)
            pfs_t = cellgrid.plan_grid(sm_xyz_t, sm_v_t, feature_radius)
    with _t("side_src"):
        src_kp, _sal_s = cellgrid.iss_pass(pi_s, iss_radius_src)
    with _t("side_tgt"):
        tgt_kp, _sal_t = cellgrid.iss_pass(pi_t, iss_radius_tgt)
    # ONE stacked host read: both keypoint counts + both surface sizes
    with profiling.span("lgr.keypoints.counts"):
        n_kp_s, n_kp_t, n_sm_s, n_sm_t = (int(v) for v in torch.stack([
            src_kp.sum(), tgt_kp.sum(), torch.as_tensor(n_sm_s, device=src_kp.device),
            torch.as_tensor(n_sm_t, device=src_kp.device)]).tolist())
    if not (0 < n_kp_s <= N_all // 2 and 0 < n_kp_t <= N_all // 2):
        raise _GateFailed(f"kp counts {n_kp_s}/{n_kp_t} of {N_all} rows outside the "
                          "compaction precondition")
    if n_sm_s > 0.8 * pi_s.n_valid or n_sm_t > 0.8 * pi_t.n_valid:
        raise _GateFailed(f"voxel surfaces {n_sm_s}/{n_sm_t} rows would not shrink the "
                          f"{pi_s.n_valid}/{pi_t.n_valid}-row clouds")

    def fs_side(kp, n_kp, row_of, n_sm, pns, pfs, xyz, sm_xyz, sm_v, vp, which):
        with _t(f"{'shot' if shot_mode else 'fpfh'}_{which}"):
            m = _pad_quantum(n_kp)
            sj = _compact_rows(kp, n_kp, m)
            g = sj.clamp_max(N_all - 1)
            kpv = torch.arange(m, device=kp.device) < n_kp
            rows_small = torch.where(sj < N_all, row_of[g], N_all)
            normal_sm = cellgrid.surface_pass(pns, normal_f, vp)[0]
            if shot_mode:
                # SHOT at the exact keypoint positions over the surface, whose
                # rows are front-compacted: slicing to the padded surface size
                # shrinks the query's grid
                ms = min(_pad_quantum(n_sm), N_all)
                normal_c = normal_sm[:ms]
                featc, fvc = _shot_stage(xyz[g], normal_c[rows_small.clamp_max(ms - 1)], kpv,
                                         sm_xyz[:ms], normal_c, sm_v[:ms], feature_radius, cfg)
                return sj, g, kpv & fvc, featc
            kp_small = torch.zeros((N_all,), dtype=torch.bool, device=kp.device)
            kp_small[rows_small[rows_small < N_all]] = True
            featc, fvc = cellgrid.fpfh_pass(cellgrid.set_normals(pfs, normal_sm), feature_radius,
                                            kp=kp_small, kp_rows=rows_small)
            return sj, g, kpv & fvc, featc

    sqj, sq_g, qv, fqc = fs_side(src_kp, n_kp_s, row_of_s, n_sm_s, pns_s, pfs_s, src_xyz,
                                 sm_xyz_s, sm_v_s, vp_src, "src")
    stj, st_g, tv, ftc = fs_side(tgt_kp, n_kp_t, row_of_t, n_sm_t, pns_t, pfs_t, tgt_xyz,
                                 sm_xyz_t, sm_v_t, vp_tgt, "tgt")
    # cluster matching overwrites the density at every keypoint row with the
    # keypoint-cloud density; other rows are never read, and a zero density
    # falls back to distance_thr in the correspondence stage
    dens = torch.zeros((N_all,), dtype=torch.float32, device=src_xyz.device)
    kc = max(2, min(cfg.cluster_k, n_kp_s - 1, n_kp_t - 1))
    with _t("match_corr"):
        return _compact_match_corr_stage(fqc, ftc, qv, tv, sqj, stj, sq_g, st_g, src_xyz,
                                         tgt_xyz, dens, dens, distance_thr, cfg, kc)


_BUCKET_LO, _BUCKET_HI = -24, 24  # the log2-bucket window: radii of 6e-8 to 1.7e7 m
_MAX_LEVELS = 6


def _bucket_rows(xyz, valid, kp, dcell: float, scale_factor: float):
    """Per row the log2 bucket of its density-derived feature radius
    (flagship._bucket_rows, matching.h:177-208): d = the distance to the
    5th nearest point, the row included, r = sqrt(FEATURE_NR d^2 / pi),
    bucket = floor(log_scale r).  The neighbours are sought within 4 dcell;
    a row with c < 5 points in that window takes d = 4 dcell sqrt(5 / c),
    the spacing of c points spread over the window's disk.  Returns (bucket
    i64[N], the keypoint rows' histogram i64[49] over [_BUCKET_LO,
    _BUCKET_HI], found bool[N]: the 5th neighbour lay in the window)."""
    window = 4.0 * dcell
    d5 = knn_window(xyz, valid, window, 5)
    seen = torch.isfinite(d5)
    found = seen[:, 4]
    est = window * torch.sqrt(5.0 / seen.sum(1).to(torch.float32).clamp_min(1.0))
    d = torch.where(found, d5[:, 4], est)
    r_row = torch.sqrt(FEATURE_NR_POINTS * d * d / math.pi)
    li = torch.floor(torch.log2(r_row.clamp_min(1e-7)) / math.log2(scale_factor))
    li = li.to(torch.int64).clamp(_BUCKET_LO, _BUCKET_HI)
    hist = torch.zeros((_BUCKET_HI - _BUCKET_LO + 1,), dtype=torch.int64, device=xyz.device)
    hist.index_add_(0, li - _BUCKET_LO, (kp & valid).to(torch.int64))
    return li, hist, found


def _prune_levels(counts: np.ndarray):
    """(lowest, highest) bucket kept of a keypoint histogram over
    [_BUCKET_LO, _BUCKET_HI] (flagship._prune, matching.h:196-204): the
    occupied range without the bottom levels that hold under 10 % of the
    fullest level's keypoints and the top levels that hold under 0.1 %."""
    nz = np.nonzero(counts)[0]
    if len(nz) == 0:
        raise _GateFailed("no occupied pyramid buckets")
    lo, hi = int(nz[0]), int(nz[-1])
    peak = int(counts.max())
    while 10 * int(counts[lo]) < peak:
        lo += 1
    while 1000 * int(counts[hi]) < peak:
        hi -= 1
    return lo + _BUCKET_LO, hi + _BUCKET_LO


def _pyramid_route(src_xyz, src_valid, tgt_xyz, tgt_valid, radii, vp_src, vp_tgt, cfg, _t,
                   debug=None):
    """The staged multi-scale pyramid (flagship.py:1209-1503, then the
    candidate branch of the matching stage, :1907-1915): ISS keypoints,
    their radius buckets, per side and level of its pruned bucket range a
    voxel surface of the working cloud (voxel_l = sqrt(pi r_l^2 / 352),
    r_l = scale_factor^l) with K1 normals at sqrt(30 / pi) voxel_l and
    FPFH (K5 / K6 at the keypoints' surface rows) or SHOT (at the exact
    keypoints) of the keypoints whose bucket is at most l; over the levels
    both sides have, descriptor k-NN both ways, all levels' candidates into
    the consensus vote, and the winners through the cluster gate.  The
    level windows come from this pair's data, so the number of launches
    differs from pair to pair.  Raises _GateFailed where the JAX package
    leaves for the feature-scale route: keypoint counts outside (0, N/2],
    no occupied bucket, ranges that share no level, more than 6 levels a
    side.  `debug`: a dict that receives the level ranges, the keypoints
    per bucket, each level's surface size and, as device tensors, the
    keypoints' rows and buckets, each level's (descriptors, validity), and
    the source side's candidates and winners."""
    (_normal_cell, dens_s, dens_t, iss_radius_src, iss_radius_tgt, _feature_radius,
     distance_thr) = radii
    shot_mode = cfg.descriptor == "shot"
    N_all = src_valid.shape[0]
    dev = src_xyz.device
    with _t("plan"):
        pi_s = cellgrid.plan_grid(src_xyz, src_valid, iss_radius_src)
        pi_t = cellgrid.plan_grid(tgt_xyz, tgt_valid, iss_radius_tgt)
    with _t("side_src"):
        src_kp, _sal_s = cellgrid.iss_pass(pi_s, iss_radius_src)
    with _t("side_tgt"):
        tgt_kp, _sal_t = cellgrid.iss_pass(pi_t, iss_radius_tgt)
    with _t("bucket"):
        li_s, hist_s, fnd_s = _bucket_rows(src_xyz, src_valid, src_kp, dens_s, cfg.scale_factor)
        li_t, hist_t, fnd_t = _bucket_rows(tgt_xyz, tgt_valid, tgt_kp, dens_t, cfg.scale_factor)
        # ONE host read: both keypoint counts and both bucket histograms
        cnt = torch.cat([torch.stack([src_kp.sum(), tgt_kp.sum()]), hist_s, hist_t]).cpu().numpy()
    n_kp_s, n_kp_t = int(cnt[0]), int(cnt[1])
    if not (0 < n_kp_s <= N_all // 2 and 0 < n_kp_t <= N_all // 2):
        raise _GateFailed(f"kp counts {n_kp_s}/{n_kp_t} of {N_all} rows outside the "
                          "compaction precondition")
    n_bins = hist_s.shape[0]
    min_s, max_s = _prune_levels(cnt[2:2 + n_bins])
    min_t, max_t = _prune_levels(cnt[2 + n_bins:])
    lo_m, hi_m = max(min_s, min_t), min(max_s, max_t)
    if hi_m < lo_m:
        raise _GateFailed(f"pyramid ranges disjoint: src [{min_s},{max_s}] vs "
                          f"tgt [{min_t},{max_t}]")
    if max(max_s - min_s, max_t - min_t) + 1 > _MAX_LEVELS:
        raise _GateFailed(f"pyramid would need >{_MAX_LEVELS} levels (src [{min_s},{max_s}], "
                          f"tgt [{min_t},{max_t}])")

    def pyr_side(xyz, valid, kp, n_kp, li_row, lmin, lmax, vp, which):
        with _t("fs_maps"):
            m = _pad_quantum(n_kp)
            sj = _compact_rows(kp, n_kp, m)
            g = sj.clamp_max(N_all - 1)
            kpv = torch.arange(m, device=dev) < n_kp
            li_kp = li_row[g].clamp(lmin, lmax)
            # every level's surface is voxelised from the working cloud itself
            maps = []
            for l in range(lmin, lmax + 1):
                r_l = float(cfg.scale_factor) ** l
                voxel_l = float(math.sqrt(math.pi * r_l * r_l / FEATURE_NR_POINTS))
                maps.append((r_l, float(math.sqrt(NORMAL_NR_POINTS / math.pi)) * voxel_l,
                             voxel_centroids_map(xyz, valid, voxel_l)))
            n_sms = [int(v) for v in torch.stack([mp[2][3] for mp in maps]).tolist()]  # one read
        with _t("plan"):
            plans = [(cellgrid.plan_grid(sm_xyz, sm_v, normal_l),
                      None if shot_mode else cellgrid.plan_grid(sm_xyz, sm_v, r_l))
                     for r_l, normal_l, (sm_xyz, sm_v, _row_of, _n) in maps]
        levels = []
        for i, (r_l, normal_l, (sm_xyz, sm_v, row_of, _n)) in enumerate(maps):
            l = lmin + i
            pns, pfs = plans[i]
            with _t(f"{'shot' if shot_mode else 'fpfh'}_{which}_l{l}"):
                normal_sm = cellgrid.surface_pass(pns, normal_l, vp)[0]
                mask_l = kpv & (li_kp <= l)
                rows_small = torch.where(sj < N_all, row_of[g], N_all)
                if shot_mode:
                    # the surface's rows are front-compacted: slicing to its
                    # padded size shrinks the query's grid
                    ms = min(_pad_quantum(n_sms[i]), N_all)
                    normal_c = normal_sm[:ms]
                    featc, fvc = _shot_stage(xyz[g], normal_c[rows_small.clamp_max(ms - 1)],
                                             mask_l, sm_xyz[:ms], normal_c, sm_v[:ms], r_l, cfg)
                else:
                    # SPFH around this level's keypoints only; the combine runs
                    # at every keypoint's row and mask_l drops the others
                    kp_small = torch.zeros((N_all,), dtype=torch.bool, device=dev)
                    kp_small[rows_small[mask_l]] = True
                    featc, fvc = cellgrid.fpfh_pass(cellgrid.set_normals(pfs, normal_sm), r_l,
                                                    kp=kp_small, kp_rows=rows_small)
            levels.append((featc, mask_l & fvc))
        return sj, g, kpv, li_kp, levels, n_sms

    sj_s, g_s, kpv_s, li_kp_s, levels_s, n_sms_s = pyr_side(
        src_xyz, src_valid, src_kp, n_kp_s, li_s, min_s, max_s, vp_src, "src")
    sj_t, g_t, kpv_t, li_kp_t, levels_t, n_sms_t = pyr_side(
        tgt_xyz, tgt_valid, tgt_kp, n_kp_t, li_t, min_t, max_t, vp_tgt, "tgt")

    def vote(levels_a, min_a, levels_b, min_b, train_xyz, iss_r):
        """Cross-level candidates and their vote, one direction
        (match_multiscale, matching.h:264-354); candidate ids are rows of
        the counterpart's compacted keypoints."""
        k = max(1, cfg.pyramid_randomness)
        parts = []
        for l in range(lo_m, hi_m + 1):
            fa, va = levels_a[l - min_a]
            fb, vb = levels_b[l - min_b]
            parts.append(matchers.match_bf(fa, fb, va, vb, k=k, tile=cfg.match_tile,
                                           bf16=cfg.bf16_matching))
        ci, cd, cm = (torch.cat(x, 1) for x in zip(*parts))
        b_idx, _b_dist, b_mask, _s_dist, _s_mask = _consensus_vote(ci, cd, cm, train_xyz, iss_r)
        return b_idx[:, None], b_mask[:, None], (ci, cd, cm)

    with _t("match_pyramid"), profiling.span("lgr.match.descriptor_nn"):
        ic_st, mc_st, cand_st = vote(levels_s, min_s, levels_t, min_t, tgt_xyz[g_t],
                                     iss_radius_tgt)
        ic_ts, mc_ts, _cand = vote(levels_t, min_t, levels_s, min_s, src_xyz[g_s],
                                   iss_radius_src)
    if debug is not None:
        def side_record(lmin, lmax, hist, n_sms, n_kp, sj, li_kp, found, levels):
            return dict(min_log2=lmin, max_log2=lmax, surface_rows=n_sms,
                        kp_per_bucket={b + _BUCKET_LO: int(c) for b, c in enumerate(hist) if c},
                        kp_indices=sj[:n_kp], log2_radii=li_kp[:n_kp],
                        exact_5nn=found[sj[:n_kp]], levels=levels)

        debug.update(
            match=(lo_m, hi_m),
            side_src=side_record(min_s, max_s, cnt[2:2 + n_bins], n_sms_s, n_kp_s, sj_s, li_kp_s,
                                 fnd_s, levels_s),
            side_tgt=side_record(min_t, max_t, cnt[2 + n_bins:], n_sms_t, n_kp_t, sj_t, li_kp_t,
                                 fnd_t, levels_t),
            candidates_st=cand_st,
            winners_st=dict(query=sj_s, match=sj_t[ic_st[:, 0]], valid=mc_st[:, 0] & kpv_s))
    v_any_s = kpv_s & torch.stack([v for _f, v in levels_s]).any(0)
    v_any_t = kpv_t & torch.stack([v for _f, v in levels_t]).any(0)
    # cluster matching overwrites the density at every keypoint row (see
    # _feature_scale_route)
    dens = torch.zeros((N_all,), dtype=torch.float32, device=dev)
    kc = max(2, min(cfg.cluster_k, n_kp_s - 1, n_kp_t - 1))
    with _t("match_corr"):
        return _compact_match_corr_stage(None, None, v_any_s, v_any_t, sj_s, sj_t, g_s, g_t,
                                         src_xyz, tgt_xyz, dens, dens, distance_thr, cfg, kc,
                                         cand=(ic_st, mc_st, ic_ts, mc_ts))


def _masked_route(src_xyz, src_valid, tgt_xyz, tgt_valid, radii, vp_src, vp_tgt, cfg, _t):
    """The classic masked route (flagship.py:1671-1791, then the matching
    region :1857-1950): per side, ISS + the need-masked surface on the
    working cloud at max(normal cell, ISS radius), then FPFH at the
    keypoints, compacted in the pass when the keypoint count allows it
    (the JAX package's big-N layout; its smaller-N layouts give the same
    values), or nothing yet for SHOT."""
    (normal_cell, _dens_s, _dens_t, iss_radius_src, iss_radius_tgt, feature_radius,
     _thr) = radii
    shot_mode = cfg.descriptor == "shot"
    N_all = src_valid.shape[0]
    pn_s = cellgrid.plan_grid(src_xyz, src_valid, max(normal_cell, iss_radius_src))
    pf_s = cellgrid.plan_grid(src_xyz, src_valid, feature_radius)
    pn_t = cellgrid.plan_grid(tgt_xyz, tgt_valid, max(normal_cell, iss_radius_tgt))
    pf_t = cellgrid.plan_grid(tgt_xyz, tgt_valid, feature_radius)

    def side(pn, pf, iss_radius, vp, which):
        with _t(f"side_{which}"):
            normal, kp, dens, _sal = cellgrid.surface_iss_masked(pn, pf, normal_cell, iss_radius,
                                                                 vp, shot=shot_mode)
        if shot_mode:
            return normal, kp, dens, None, kp, None
        with _t(f"fpfh_{which}"):
            n = int(kp.sum())
            pf_n = cellgrid.set_normals(pf, normal)
            if 0 < n <= N_all // 2:
                m = _pad_quantum(n)
                sj = _compact_rows(kp, n, m)
                featc, fvc = cellgrid.fpfh_pass(pf_n, feature_radius, kp=kp, kp_rows=sj)
                v = (torch.arange(m, device=kp.device) < n) & fvc
                return normal, kp, dens, None, None, (n, sj, sj.clamp_max(N_all - 1), v, featc)
            feat, fv = cellgrid.fpfh_pass(pf_n, feature_radius, kp=kp)
            return normal, kp, dens, feat, fv & kp, None

    src_normal, _src_kp, dens_s, fq, fq_valid, ec_q = side(pn_s, pf_s, iss_radius_src, vp_src,
                                                           "src")
    tgt_normal, _tgt_kp, dens_t, ft, ft_valid, ec_t = side(pn_t, pf_t, iss_radius_tgt, vp_tgt,
                                                           "tgt")
    # one side compacted, the other not: back to full rows for both
    if ec_q is not None and ec_t is None:
        (fq, fq_valid), ec_q = _restore_rows(ec_q, N_all), None
    elif ec_t is not None and ec_q is None:
        (ft, ft_valid), ec_t = _restore_rows(ec_t, N_all), None
    return _match_region((src_xyz, src_valid, src_normal, pf_s),
                         (tgt_xyz, tgt_valid, tgt_normal, pf_t), fq, fq_valid, ft, ft_valid,
                         ec_q, ec_t, dens_s, dens_t, radii, cfg, _t)


def _unmasked_route(src_xyz, src_valid, tgt_xyz, tgt_valid, radii, vp_src, vp_tgt, cfg, _t):
    """The unmasked ISS route (`masked_features=False`; flagship.py:
    1090-1110, 1172-1189, 1839-1855, then the matching region): per side
    K1 over every point and K2-K4 on ONE plan at max(normal cell, ISS
    radius) (cellgrid.surface_iss_cells), then FPFH over every point,
    valid at the keypoints only, or nothing yet for SHOT.  The same values
    at every row a later stage reads as the classic masked route."""
    (normal_cell, _dens_s, _dens_t, iss_radius_src, iss_radius_tgt, feature_radius,
     _thr) = radii
    shot_mode = cfg.descriptor == "shot"

    def side(xyz, valid, iss_radius, vp, which):
        with _t(f"side_{which}"):
            pn = cellgrid.plan_grid(xyz, valid, max(normal_cell, iss_radius))
            pf = cellgrid.plan_grid(xyz, valid, feature_radius)
            out = cellgrid.surface_iss_cells(pn, normal_cell, iss_radius, vp)
        if shot_mode:
            # SHOT runs at the compacted keypoint rows, in the matching region
            return out, pf, None, valid & out["kp"]
        with _t(f"fpfh_{which}"):
            feat, fv = cellgrid.fpfh_pass(cellgrid.set_normals(pf, out["normal"]),
                                          feature_radius)
        return out, pf, feat, fv & out["kp"]

    s, pf_s, fq, fq_valid = side(src_xyz, src_valid, iss_radius_src, vp_src, "src")
    t, pf_t, ft, ft_valid = side(tgt_xyz, tgt_valid, iss_radius_tgt, vp_tgt, "tgt")
    return _match_region((src_xyz, src_valid, s["normal"], pf_s),
                         (tgt_xyz, tgt_valid, t["normal"], pf_t), fq, fq_valid, ft, ft_valid,
                         None, None, s["density"], t["density"], radii, cfg, _t)


def _grid_hash_route(src_xyz, src_valid, tgt_xyz, tgt_valid, radii, vp_src, vp_tgt, cfg, _t):
    """The route of use_cell_fpfh=False (flagship.py:1083-1110, 1172-1192,
    1839-1855, then the matching region): per side _side_stage (ISS
    keypoints or every row), then FPFH over the cloud at the keypoints, or
    nothing yet for SHOT, which the matching region computes at the
    compacted keypoints (or over every masked row)."""
    (normal_cell, _dens_s, _dens_t, iss_radius_src, iss_radius_tgt, feature_radius,
     _thr) = radii
    shot_mode = cfg.descriptor == "shot"
    with _t("side_src"):
        src_normal, src_kp, dens_s = _side_stage(src_xyz, src_valid, normal_cell, iss_radius_src,
                                                 cfg, vp_src)
    with _t("side_tgt"):
        tgt_normal, tgt_kp, dens_t = _side_stage(tgt_xyz, tgt_valid, normal_cell, iss_radius_tgt,
                                                 cfg, vp_tgt)
    if shot_mode:
        fq = ft = None
        fq_valid, ft_valid = src_valid & src_kp, tgt_valid & tgt_kp
    else:
        with _t("fpfh_src"):
            fq, fq_valid = _fpfh_fixed(src_xyz, src_normal, src_valid, src_kp, feature_radius)
        with _t("fpfh_tgt"):
            ft, ft_valid = _fpfh_fixed(tgt_xyz, tgt_normal, tgt_valid, tgt_kp, feature_radius)
    return _match_region((src_xyz, src_valid, src_normal, None),
                         (tgt_xyz, tgt_valid, tgt_normal, None), fq, fq_valid, ft, ft_valid,
                         None, None, dens_s, dens_t, radii, cfg, _t)


def _iss_route(src_xyz, src_valid, tgt_xyz, tgt_valid, radii, vp_src, vp_tgt, cfg, _t,
               pyramid_debug=None):
    """The ISS routes (flagship.py:1191-1209).  With masked features: the
    feature-scale route when cluster matching and feature_scale are on and
    the feature-scale voxel is at least 0.9 x the larger density (a silent
    pre-gate in the JAX package too), and before it, with cfg.pyramid, the
    staged pyramid, which leaves for the feature-scale route when one of
    its gates fails; else, or when a data gate of the feature-scale route
    fails (each with the JAX package's notice), the classic masked route.
    Without: the unmasked route (the feature-scale route and the pyramid
    need the masked features and are skipped silently, as in the JAX
    package)."""
    if not cfg.masked_features:
        return _unmasked_route(src_xyz, src_valid, tgt_xyz, tgt_valid, radii, vp_src, vp_tgt,
                               cfg, _t)
    density = max(radii[1], radii[2])
    voxel_f = float(math.sqrt(math.pi * radii[5]**2 / FEATURE_NR_POINTS))
    fs_mode = cfg.cluster_matching and cfg.feature_scale and voxel_f >= 0.9 * density
    if fs_mode and cfg.pyramid:
        try:
            return _pyramid_route(src_xyz, src_valid, tgt_xyz, tgt_valid, radii, vp_src, vp_tgt,
                                  cfg, _t, pyramid_debug)
        except _GateFailed as e:
            print(f"# staged pyramid -> single feature-scale path: {e}", flush=True)
    if fs_mode:
        try:
            return _feature_scale_route(src_xyz, src_valid, tgt_xyz, tgt_valid, radii, vp_src,
                                        vp_tgt, cfg, _t)
        except _GateFailed as e:
            print(f"# feature-scale surface -> classic masked path: {e}", flush=True)
    return _masked_route(src_xyz, src_valid, tgt_xyz, tgt_valid, radii, vp_src, vp_tgt, cfg, _t)


_KEYPOINT_STAGES = ("fs_maps", "plan", "side_src", "side_tgt", "bucket")


def _stage_span(label: str) -> str:
    """The span of a register_pair_staged stage: lgr.keypoints.<label>,
    lgr.descriptors.<label> (fpfh_* / shot_*), lgr.solver (ransac, gror) or
    lgr.match (match_*, corr)."""
    if label in _KEYPOINT_STAGES:
        return f"lgr.keypoints.{label}"
    if label.startswith(("fpfh_", "shot_")):
        return f"lgr.descriptors.{label}"
    if label in ("ransac", "gror"):
        return "lgr.solver"
    return "lgr.match"


def _stage_clock(stage_times: dict | None, dev: torch.device):
    """register_pair_staged's stages: `with stage(label):` runs the block
    in its span (_stage_span) and, when stage_times is a dict, synchronises
    at its end and adds the wall seconds since the previous stage ended (or
    the call began) under `label`; a stage that raises adds nothing."""
    if stage_times is None:
        return lambda label: profiling.span(_stage_span(label))
    last = [time.perf_counter()]

    @contextlib.contextmanager
    def stage(label):
        with profiling.span(_stage_span(label)):
            yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        # summed per label: after a failed feature-scale gate the classic
        # route's side stages follow the feature-scale route's
        stage_times[label] = stage_times.get(label, 0.0) + now - last[0]
        last[0] = now

    return stage


def register_pair_staged(
    src_xyz, src_valid, tgt_xyz, tgt_valid, generator: torch.Generator,
    normal_cell, density_cell_src, density_cell_tgt,
    iss_radius_src, iss_radius_tgt, feature_radius, distance_thr,
    vp_src=None, vp_tgt=None,
    cfg: FlagshipConfig = FlagshipConfig(),
    return_correspondences: bool = False,
    stage_times: dict | None = None,
    pyramid_debug: dict | None = None,
):
    """Register one padded pair on the tensors' device (the JAX
    register_pair_staged; cfg.use_iss picks the ISS or the keypoint-any
    route, cfg.use_cell_fpfh=False the grid-hash route).  `generator` (on the same device) drives the RANSAC draws; the
    GROR solver (cfg.alignment = "gror") draws nothing and returns host
    values beside its transformation tensor.
    When `stage_times` is a dict, each stage is synchronised and its wall
    seconds added there under the JAX package's LGR_STAGE_TIMING labels.
    The call is the span lgr.pair, each stage a span inside it
    (_stage_clock) beside the keypoint-count read (lgr.keypoints.counts)
    and the export (lgr.match.export), and it counts one `pairs`.
    When `pyramid_debug` is a dict and the staged pyramid runs, it receives
    that route's record (_pyramid_route; flagship.PYRAMID_DEBUG in JAX).
    Returns the JAX result dict (transformation, metric, inliers,
    converged, n_correspondences, iterations), plus with
    return_correspondences "correspondences" = (query rows, matched rows,
    thresholds, valid) of the surviving set, valid rows first, padded to a
    count quantum (flagship._corr_export)."""
    # Full float32 matmuls: the degree prefilter's and the keypoint kNN's
    # Gram-trick distances cancel |a|^2 + |b|^2 - 2ab, which TF32's 10-bit
    # mantissa turns into noise at scene scale (flagship.py:262-270), and
    # the plain 1-NN's q @ t.T would change its argmin ties.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if src_xyz.shape[0] != tgt_xyz.shape[0]:
        raise ValueError(
            f"register_pair_staged requires equal padded capacities "
            f"(got src {src_xyz.shape[0]} vs tgt {tgt_xyz.shape[0]})"
        )
    profiling.count("pairs")
    with profiling.span("lgr.pair"):
        _t = _stage_clock(stage_times, src_xyz.device)
        radii = tuple(float(v) for v in (normal_cell, density_cell_src, density_cell_tgt,
                                         iss_radius_src, iss_radius_tgt, feature_radius,
                                         distance_thr))
        args = (src_xyz, src_valid, tgt_xyz, tgt_valid, radii, vp_src, vp_tgt, cfg, _t)
        if not cfg.use_cell_fpfh:
            j, keep, thr = _grid_hash_route(*args)
        elif cfg.use_iss:
            j, keep, thr = _iss_route(*args, pyramid_debug)
        else:
            j, keep, thr = _any_route(*args)
        if cfg.alignment == "gror":
            with _t("gror"):
                res = _gror_stage(src_xyz, tgt_xyz[j], keep, radii[6], cfg)
        else:
            with _t("ransac"):
                res = ransac_solve(src_xyz, tgt_xyz[j], thr, keep, generator, cfg)
        if return_correspondences:
            with profiling.span("lgr.match.export"):
                n_c = int(keep.sum())
                res["correspondences"] = _corr_export(
                    j, keep, thr, min(_pad_quantum(max(n_c, 1)), keep.shape[0]))
        return res


# ---------------------------------------------------------------------------
# the one-graph entry points: register_pair_step, register_pair_two_stage
# ---------------------------------------------------------------------------
def _knn_self(pts, valid, k: int):
    """Same-set exact k-NN, self excluded by id (match_bf exclude_diag)."""
    return matchers.match_bf(pts, pts, valid, valid, k=k, exclude_diag=True)


def _cluster_filter_rows(xyz_s, kpv_s, xyz_t, kpv_t, idx_st, mask_st, idx_ts, mask_ts, dens_s,
                         dens_t, cfg: FlagshipConfig, knn_self=_knn_self):
    """The cluster gate over full rows (flagship._cluster_filter_rows,
    ClusterMatcher, matching.h:480-551): the keypoints' exact kc-NN per side
    (self excluded by id, centred), _consensus_keep, and the keypoint-cloud
    density from its column 0 as the thresholds at keypoint rows.
    knn_self(points, valid, k) -> (idx, dist, mask) is that kNN: _knn_self,
    or the tp peers' shard merge (parallel/batch.py).  Returns (mask_st',
    dens_s', dens_t')."""
    kc = max(2, min(cfg.cluster_k, min(xyz_s.shape[0], xyz_t.shape[0]) - 1))
    with profiling.span("lgr.match.gate_knn"):
        ksq, kst = _centred(xyz_s, kpv_s), _centred(xyz_t, kpv_t)
        kq = knn_self(ksq, kpv_s, kc)
        kt = knn_self(kst, kpv_t, kc)
    with profiling.span("lgr.match.consensus"):
        keep_q = _consensus_keep(idx_st[:, 0], mask_st[:, 0], idx_ts[:, 0], mask_ts[:, 0], kq,
                                 kt, cfg)
        dens_s2 = torch.where(kpv_s, _kp_density_nearest(*(a[:, :1] for a in kq)), dens_s)
        dens_t2 = torch.where(kpv_t, _kp_density_nearest(*(a[:, :1] for a in kt)), dens_t)
        return mask_st & keep_q[:, None], dens_s2, dens_t2


def _step_sides(src_xyz, src_valid, tgt_xyz, tgt_valid, radii, vp_src, vp_tgt, cfg):
    """Both sides' _side_stage, then FPFH at the keypoint rows, or SHOT
    there (gravity frames with lrf="gravity", flagship.py:465)."""
    normal_cell, _ds, _dt, iss_src, iss_tgt, feature_radius, _thr = radii
    out = []
    for xyz, valid, iss_r, vp in ((src_xyz, src_valid, iss_src, vp_src),
                                  (tgt_xyz, tgt_valid, iss_tgt, vp_tgt)):
        normal, kp, dens = _side_stage(xyz, valid, normal_cell, iss_r, cfg, vp)
        if cfg.descriptor == "shot":
            feat, fv = _shot_stage(xyz, normal, valid & kp, xyz, normal, valid, feature_radius,
                                   cfg)
        else:
            feat, fv = _fpfh_fixed(xyz, normal, valid, kp, feature_radius)
        out.append((feat, fv, dens))
    return out


def _radii(*v) -> tuple:
    return tuple(float(x) for x in v)


def register_pair_step(src_xyz, src_valid, tgt_xyz, tgt_valid, generator: torch.Generator,
                       normal_cell, density_cell_src, density_cell_tgt, iss_radius_src,
                       iss_radius_tgt, feature_radius, distance_thr, vp_src=None, vp_tgt=None,
                       cfg: FlagshipConfig = FlagshipConfig()):
    """The JAX package's single-graph step (flagship.register_pair_step,
    flagship.py:408-519) on the tensors' device: _side_stage per side, FPFH
    or SHOT at the keypoint rows over the cloud, descriptor 1-NN both ways
    (the bf16 matcher with cfg.bf16_matching), the cluster filter over full
    rows (ISS with cluster matching) or the mutual filter, the
    correspondence stage and ransac_solve.  The density cells are accepted
    and unread, as in the JAX package (the density comes from the normals'
    neighbours).  Not the grid-hash route: that route's matching region
    falls back to the mutual filter when more than half the rows are
    keypoints, where the step keeps the cluster gate over full rows.
    Returns ransac_solve's dict."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    radii = _radii(normal_cell, density_cell_src, density_cell_tgt, iss_radius_src,
                   iss_radius_tgt, feature_radius, distance_thr)
    (fq, fq_valid, dens_s), (ft, ft_valid, dens_t) = _step_sides(
        src_xyz, src_valid, tgt_xyz, tgt_valid, radii, vp_src, vp_tgt, cfg)
    return _filter_and_solve(src_xyz, tgt_xyz, fq_valid, ft_valid,
                             _nn_both_ways(fq, ft, fq_valid, ft_valid, cfg), dens_s, dens_t,
                             radii[6], generator, cfg)


def _filter_and_solve(src_xyz, tgt_xyz, fq_valid, ft_valid, nn, dens_s, dens_t,
                      distance_thr: float, generator, cfg: FlagshipConfig, knn_self=_knn_self):
    """register_pair_step after the 1-NN both ways (nn = idx_st, mask_st,
    idx_ts, mask_ts over full rows): the cluster filter (ISS with cluster
    matching; knn_self its keypoint kNN) or the mutual filter, the
    correspondence stage and ransac_solve."""
    idx_st, mask_st, idx_ts, mask_ts = nn
    clustered = cfg.use_iss and cfg.cluster_matching
    if clustered:
        mask_st, dens_s, dens_t = _cluster_filter_rows(
            src_xyz, fq_valid, tgt_xyz, ft_valid, idx_st, mask_st, idx_ts, mask_ts, dens_s,
            dens_t, cfg, knn_self)
    j, mutual, thr = _correspondence_stage(idx_st, mask_st, idx_ts, mask_ts, dens_s, dens_t,
                                           distance_thr, require_mutual=not clustered)
    return ransac_solve(src_xyz, tgt_xyz[j], thr, mutual, generator, cfg)


def register_pair_two_stage(src_xyz, src_valid, tgt_xyz, tgt_valid, generator: torch.Generator,
                            normal_cell, density_cell_src, density_cell_tgt, iss_radius_src,
                            iss_radius_tgt, feature_radius, distance_thr, vp_src=None,
                            vp_tgt=None, cfg: FlagshipConfig = FlagshipConfig()):
    """The two-program variant (flagship.register_pair_two_stage,
    flagship.py:1969-2028): register_pair_step with FPFH (whatever
    cfg.descriptor says, as in the JAX package's _front_stage) and the
    mutual filter.  Eager PyTorch has no second program to split off, so
    the split is not carried.  Returns ransac_solve's dict."""
    return register_pair_step(src_xyz, src_valid, tgt_xyz, tgt_valid, generator, normal_cell,
                              density_cell_src, density_cell_tgt, iss_radius_src, iss_radius_tgt,
                              feature_radius, distance_thr, vp_src, vp_tgt,
                              dataclasses.replace(cfg, descriptor="fpfh", cluster_matching=False))

"""Multi-scale feature pyramid and the matching strategies
(lidar_global_registration_tpu/models/pyramid.py), the host path of
align_point_clouds.

Reference: FeatureBasedMatcherImpl (include/matching.h:96-362) and the
strategy subclasses OneSided / LeftToRight / Cluster (matching.h:386-551).

Per side (initialize_side):
  - keypoints (ops/iss.detect_keypoints: K2-K4 on a CUDA tensor), then per
    keypoint the log2 bucket of the feature radius whose disk holds
    feature_nr points of the local density (the 5th nearest neighbour,
    matching.h:177-208), sparse buckets pruned (< 1/10 of the fullest
    below, < 1/1000 above); a fixed feature_radius is one bucket;
  - per level: the surface downsampled to voxel = sqrt(pi r^2 / feature_nr)
    (cascaded from the previous level), its kNN normals, the keypoints of
    that bucket and below with their normals re-estimated on it, and their
    descriptors.

Descriptors: FPFH-33 (K5 over the surface, ops/fpfh.py), SHOT-352
(ops/shot.py), RoPS-135 (ops/rops.py) or USC-1960 (ops/usc.py), the last
three with the frames of lrf 'gravity' or 'gt' (ops/lrf.py), or their own
SHOT LRF for 'default'; with 'gt' the target side takes the identity.

Matching (match_sides): per level both sides hold, the descriptor k-NN
(ops/matchers.match_bf: K7 for k = 1, its bfloat16-rounded form with
bf16_matching), or with an initial guess the local matcher
(ops/matchers.match_local: candidates within match_search_radius of the
query moved by the guess, its inverse in the target -> source direction);
the candidates of all levels voted by spatial consensus (_consensus_vote),
then the strategy: ratio, one_sided, cluster, or the mutual lr filter
(also the fallback for an unknown id, with a warning).

Levels are orchestrated on the host (their count depends on the data), the
level work runs on the clouds' device, and the strategies read the vote's
winners once to the host, as in the JAX package.  The staged pyramid,
where register_pair_staged takes the AUTO radius, is
models/flagship._pyramid_route; it shares _cluster_distances and
_consensus_vote.  With save_features each level's descriptors are written
as histograms[<log2 radius>]_src/_tgt.csv (utils/debug_viz.save_features_csv).
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from lidar_global_registration_tpu_torch.ops import matchers
from lidar_global_registration_tpu_torch.ops.density import smoothed_densities
from lidar_global_registration_tpu_torch.ops.downsample import voxel_downsample
from lidar_global_registration_tpu_torch.ops.grid import knn, radius_neighbors
from lidar_global_registration_tpu_torch.ops.normals import estimate_normals_knn
from lidar_global_registration_tpu_torch.types import (
    DESCRIPTOR_FPFH,
    DESCRIPTOR_ROPS,
    DESCRIPTOR_SHOT,
    DESCRIPTOR_USC,
    LRF_GRAVITY,
    LRF_GT,
    MATCHING_CLUSTER,
    MATCHING_CLUSTER_THRESHOLD,
    MATCHING_LEFT_TO_RIGHT,
    MATCHING_ONE_SIDED,
    MATCHING_RATIO,
    MATCHING_RATIO_THRESHOLD,
    AlignmentParameters,
    Cloud,
    Correspondences,
    round_up,
)
from lidar_global_registration_tpu_torch.utils.debug_viz import save_features_csv
from lidar_global_registration_tpu_torch.utils.naming import construct_path

BIG = 3.0e38


# ---------------------------------------------------------------------------
# Descriptor dispatch
# ---------------------------------------------------------------------------
def _estimate_frames(params: AlignmentParameters, kps: Cloud, radius: float):
    """estimateReferenceFrames (common.cpp:693-755): f32[M, 3, 3] frames for
    lrf 'gravity' and 'gt', None for the descriptor's own.  'gt': one
    constant frame turned by inv(R_gt) of params.ground_truth (the identity
    without one).  'gravity': where the normal lies within 0.04 rad of
    gravity the frame is the SHOT LRF over the other KEYPOINTS within r, as
    in the JAX host path (its deliberate deviation: the reference takes the
    surface as support, common.cpp:737-747; the staged path does,
    flagship._shot_stage)."""
    from lidar_global_registration_tpu_torch.ops import cellgrid
    from lidar_global_registration_tpu_torch.ops.lrf import gravity_lrf, gt_lrf, shot_lrf

    lrf_id = params.lrf_id.lower()
    if lrf_id == LRF_GT:
        gt = params.ground_truth if params.ground_truth is not None else np.eye(4)
        return gt_lrf(kps.capacity, gt, kps.xyz.device)
    if lrf_id != LRF_GRAVITY:
        return None
    frames, needs_fb = gravity_lrf(kps.normal)
    needs_fb = needs_fb & kps.valid
    if bool(needs_fb.any()):
        plan = cellgrid.plan_grid(kps.xyz, kps.valid, radius)
        idx, _d, mask = radius_neighbors(plan, kps.xyz, kps.valid, radius, 64)
        fb, _ok = shot_lrf(kps.xyz, radius, kps.xyz, idx, mask)
        frames = torch.where(needs_fb[:, None, None], fb, frames)
    return frames


def compute_descriptors(params: AlignmentParameters, kps: Cloud, surface: Cloud, radius: float):
    """estimateFeatures<FeatureT> (common.h:312-415): (features f32[M, D],
    valid bool[M]) of the keypoints over the surface within `radius`.  FPFH
    reads no frames (the JAX package builds them and leaves them unread)."""
    did = params.descriptor_id
    if did == DESCRIPTOR_FPFH:
        from lidar_global_registration_tpu_torch.ops.fpfh import fpfh

        return fpfh(kps.xyz, kps.valid, surface.xyz, surface.normal, surface.valid, radius,
                    kp_normal=kps.normal)
    if did not in (DESCRIPTOR_SHOT, DESCRIPTOR_ROPS, DESCRIPTOR_USC):
        raise ValueError(f"descriptor {did!r} isn't supported")
    frames = _estimate_frames(params, kps, radius)
    if did == DESCRIPTOR_SHOT:
        from lidar_global_registration_tpu_torch.ops.shot import shot

        return shot(kps.xyz, kps.valid, surface.xyz, surface.normal, surface.valid, radius,
                    frames=frames)
    if did == DESCRIPTOR_ROPS:
        from lidar_global_registration_tpu_torch.ops.rops import rops

        return rops(kps.xyz, kps.valid, surface.xyz, surface.valid, radius, frames=frames)
    from lidar_global_registration_tpu_torch.ops.usc import usc

    return usc(kps.xyz, kps.valid, surface.xyz, surface.valid, radius, frames=frames)


# ---------------------------------------------------------------------------
# Per-side pyramid state ("Storage", matching.h:114-126)
# ---------------------------------------------------------------------------
@dataclass
class PyramidSide:
    cloud: Cloud
    kp_indices: torch.Tensor  # i64 rows of cloud
    kps: Cloud  # the gathered keypoints (their own normals)
    iss_radius: float
    min_log2: int = 0
    max_log2: int = 0
    level_kp_rows: list = field(default_factory=list)  # i64 rows of kps per level
    level_features: list = field(default_factory=list)  # f32[Mi, D]
    level_feat_valid: list = field(default_factory=list)
    level_kps: list = field(default_factory=list)  # Cloud per level
    level_surfaces: list = field(default_factory=list)
    time_ds_ne: float = 0.0
    time_fe: float = 0.0


def _gather_cloud(cloud: Cloud, rows: torch.Tensor, capacity: Optional[int] = None) -> Cloud:
    """The rows of `cloud` as a padded cloud of their own (round_up(len)
    rows unless `capacity` is given)."""
    n = rows.shape[0]
    dev = cloud.xyz.device
    cap = capacity or round_up(max(n, 1))
    r = torch.zeros((cap,), dtype=torch.int64, device=dev)
    r[:n] = rows
    vm = torch.arange(cap, device=dev) < n
    return Cloud(xyz=torch.where(vm[:, None], cloud.xyz[r], Cloud.PAD_COORD),
                 normal=torch.where(vm[:, None], cloud.normal[r], 0.0),
                 weight=torch.where(vm, cloud.weight[r], 0.0),
                 curvature=torch.where(vm, cloud.curvature[r], 0.0), valid=vm)


def _log2_buckets(cloud: Cloud, kp_indices: torch.Tensor, params: AlignmentParameters):
    """(min_log2, max_log2, log2 bucket i32[n_kp]) of the AUTO radius
    (matching.h:177-208): the distance d to each keypoint's 5th nearest
    point, itself included (exact, grid.knn), r = sqrt(feature_nr d^2 / pi),
    bucket = floor(log2(r) / log2(scale)); then the sparse end levels are
    pruned and the buckets clipped to the rest."""
    log_scale = math.log2(params.scale_factor)
    _i, dist, mask = knn(cloud.xyz, cloud.valid, 5, queries=cloud.xyz[kp_indices])
    d = dist[:, 4].cpu().numpy()
    ok = mask[:, 4].cpu().numpy()
    if len(d) == 0:
        raise ValueError("no keypoints: the AUTO feature radius needs at least one")
    d = np.where(ok, d, np.median(d[ok]) if ok.any() else 1.0)
    feature_radius = np.sqrt(params.feature_nr_points * d * d / np.pi)
    log2_radii = np.floor(np.log2(np.maximum(feature_radius, 1e-12)) / log_scale).astype(np.int32)
    lo, hi = int(log2_radii.min()), int(log2_radii.max())
    counts = np.bincount(log2_radii - lo)
    max_count = counts.max()
    while 10 * counts[0] < max_count:  # matching.h:196-204
        counts = counts[1:]
        lo += 1
    while 1000 * counts[-1] < max_count:
        counts = counts[:-1]
        hi -= 1
    return lo, hi, np.clip(log2_radii, lo, hi)


def initialize_side(cloud: Cloud, kp_indices: torch.Tensor, params: AlignmentParameters,
                    viewpoint, iss_radius: float, is_source: bool = True,
                    debug: Optional[dict] = None) -> PyramidSide:
    """FeatureBasedMatcherImpl::initialize (matching.h:163-262) on the
    cloud's device.  `debug` (a dict) receives the side's level range,
    keypoints and buckets under side_src / side_tgt."""
    from lidar_global_registration_tpu_torch.models.pipeline import _Clock

    dev = cloud.xyz.device
    kps = _gather_cloud(cloud, kp_indices)
    side = PyramidSide(cloud=cloud, kp_indices=kp_indices, kps=kps, iss_radius=iss_radius)
    if params.feature_radius is not None:
        lr = int(math.floor(math.log2(params.feature_radius) / math.log2(params.scale_factor)))
        side.min_log2 = side.max_log2 = lr
        log2_radii = np.full(kp_indices.shape[0], lr, np.int32)
    else:
        side.min_log2, side.max_log2, log2_radii = _log2_buckets(cloud, kp_indices, params)
    if debug is not None:
        debug[f"side_{'src' if is_source else 'tgt'}"] = dict(
            min_log2=side.min_log2, max_log2=side.max_log2,
            kp_indices=kp_indices.cpu().numpy(), log2_radii=log2_radii.copy())

    buckets = torch.from_numpy(log2_radii.astype(np.int64)).to(dev)
    prev_surface = cloud
    for i in range(side.max_log2 - side.min_log2 + 1):
        # level i serves the keypoints of bucket <= its own (matching.h:222-227)
        rows = torch.nonzero(buckets <= side.min_log2 + i).squeeze(1)
        side.level_kp_rows.append(rows)
        search_radius = float(params.scale_factor ** (side.min_log2 + i))
        voxel = math.sqrt(math.pi * search_radius * search_radius / params.feature_nr_points)
        clock = _Clock(dev)
        surface = voxel_downsample(prev_surface, voxel)
        surface = estimate_normals_knn(surface, k=params.normal_nr_points, viewpoint=viewpoint,
                                       normals_available=params.normals_available).compact()
        side.time_ds_ne += clock()
        prev_surface = surface
        level_kps = _gather_cloud(side.kps, rows)
        if params.reestimate_frames:
            # the keypoint normals re-estimated on the level surface, turned
            # to agree with the keypoints' own (matching.h:243-246)
            level_kps = estimate_normals_knn(level_kps, surface=surface,
                                             k=params.normal_nr_points, viewpoint=viewpoint,
                                             normals_available=True)
        feats, fvalid = compute_descriptors(params, level_kps, surface, search_radius)
        side.time_fe += clock()
        if params.save_features:
            # the level's descriptors (saveFeatures, feature_analysis.h:11-27;
            # called from matching.h:273-279)
            scale = "" if params.feature_radius is not None else str(side.min_log2 + i)
            save_features_csv(feats, fvalid, rows, construct_path(
                params, f"histograms{scale}_{'src' if is_source else 'tgt'}", "csv"))
        side.level_kps.append(level_kps)
        side.level_surfaces.append(surface)
        side.level_features.append(feats)
        side.level_feat_valid.append(fvalid)
    return side


# ---------------------------------------------------------------------------
# Cross-scale matching + consensus vote (matching.h:264-354)
# ---------------------------------------------------------------------------
def match_multiscale(side_q: PyramidSide, side_t: PyramidSide, params: AlignmentParameters,
                     inverse_tn: bool = False):
    """Per query keypoint row the voted best train keypoint row over the
    levels both sides hold (matching.h:264-354): per level the descriptor
    k-NN, k = params.randomness (match_bf: K7 for k = 1; `tile` from
    bf_block_size as the reference's block size), or with params.guess the
    local matcher (match_local; inverse_tn: the target -> source direction,
    which moves its queries by the inverse guess), mapped to global
    keypoint rows, then _consensus_vote over all levels' candidates.
    Returns host arrays over the query keypoint capacity: (match row i64,
    distance f32, has bool, runner-up distance f32, has runner-up bool)."""
    dev = side_q.kps.xyz.device
    Mq = side_q.kps.capacity
    lo = max(side_q.min_log2, side_t.min_log2)
    hi = min(side_q.max_log2, side_t.max_log2)
    k = params.randomness
    tile = max(512, min(8192, 1 << (params.bf_block_size - 1).bit_length()))
    guess = params.guess
    if guess is not None and inverse_tn:
        guess = np.linalg.inv(guess)
    cand_i, cand_d, cand_m = [], [], []
    for log2_r in range(lo, hi + 1):
        iq = log2_r - side_q.min_log2
        it = log2_r - side_t.min_log2
        fq, ft = side_q.level_features[iq], side_t.level_features[it]
        vq, vt = side_q.level_feat_valid[iq], side_t.level_feat_valid[it]
        if guess is not None:
            lq, lt = side_q.level_kps[iq], side_t.level_kps[it]
            idx, dist, mask = matchers.match_local(
                lq.xyz, lq.valid & vq, fq, lt.xyz, lt.valid & vt, ft,
                np.asarray(guess, np.float32), params.match_search_radius, k=k)
        else:
            idx, dist, mask = matchers.match_bf(fq, ft, vq, vt, k=k, tile=tile,
                                                bf16=params.bf16_matching)
        rows_q = side_q.level_kp_rows[iq]
        rows_t = side_t.level_kp_rows[it]
        nq = rows_q.shape[0]
        m_ok = mask[:nq]
        if rows_t.shape[0]:
            tglob = rows_t[idx[:nq].clamp(0, rows_t.shape[0] - 1)]
        else:
            tglob = torch.zeros((nq, k), dtype=torch.int64, device=dev)
        gi = torch.zeros((Mq, k), dtype=torch.int64, device=dev)
        gd = torch.full((Mq, k), BIG, dtype=torch.float32, device=dev)
        gm = torch.zeros((Mq, k), dtype=torch.bool, device=dev)
        gi[rows_q] = torch.where(m_ok, tglob, 0)
        gd[rows_q] = torch.where(m_ok, dist[:nq], BIG)
        gm[rows_q] = m_ok
        cand_i.append(gi)
        cand_d.append(gd)
        cand_m.append(gm)
    if not cand_i:
        big = np.full((Mq,), np.float32(BIG), np.float32)
        none = np.zeros((Mq,), bool)
        return np.zeros((Mq,), np.int64), big, none, big.copy(), none.copy()
    out = _consensus_vote(torch.cat(cand_i, 1), torch.cat(cand_d, 1), torch.cat(cand_m, 1),
                          side_t.kps.xyz, float(side_t.iss_radius))
    return tuple(v.cpu().numpy() for v in out)


# ---------------------------------------------------------------------------
# Matching strategies (matching.h:386-551)
# ---------------------------------------------------------------------------
def _kp_thresholds(side: PyramidSide) -> np.ndarray:
    """Per keypoint row the k = 2 smoothed density of the keypoint cloud
    (calculateSmoothedDensities(kps), matching.h:396-397), 0 at padding."""
    v = side.kps.valid
    dens = torch.zeros((side.kps.capacity,), dtype=torch.float32, device=v.device)
    dens[v] = smoothed_densities(side.kps.xyz[v], k=2)
    return dens.cpu().numpy()


def _kps_knn(side: PyramidSide, k: int):
    """The k nearest keypoints of each keypoint, itself first (the kps_tree
    of matching.h:118; exact, grid.knn).  Returns (idx i64[M, k], mask)."""
    idx, _dist, mask = knn(side.kps.xyz, side.kps.valid, k)
    return idx, mask


def _build_correspondences(rows_q, rows_m, dists, thr_q, thr_m, distance_thr: float,
                           kp_idx_q: np.ndarray, kp_idx_t: np.ndarray,
                           device) -> Correspondences:
    """Correspondences in cloud rows, each with the adaptive threshold
    min(max(dens_q, dens_t), distance_thr) (matching.h:404-407), padded to
    round_up(n) rows on `device`."""
    thr = np.minimum(np.maximum(thr_q[rows_q], thr_m[rows_m]), distance_thr)
    n = len(rows_q)
    out = Correspondences.empty(round_up(max(n, 1)), device)
    for name, v in (("query", kp_idx_q[rows_q]), ("match", kp_idx_t[rows_m]),
                    ("distance", np.asarray(dists, np.float32)),
                    ("threshold", np.asarray(thr, np.float32))):
        getattr(out, name)[:n] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    out.valid[:n] = True
    return out


def match_sides(side_src: PyramidSide, side_tgt: PyramidSide, params: AlignmentParameters,
                debug: Optional[dict] = None) -> Correspondences:
    """The strategy (matching.h:386-551): ratio, one_sided, cluster, or lr
    (the mutual filter; also for an unknown id, with a warning).  `debug`
    receives the source direction's vote winners in cloud rows
    (winners_st)."""
    dev = side_src.kps.xyz.device
    print("Downsampling and normal estimation took "
          f"{1000.0 * (side_src.time_ds_ne + side_tgt.time_ds_ne):.1f}ms.")
    print(f"Feature estimation took {1000.0 * (side_src.time_fe + side_tgt.time_fe):.1f}ms.")
    thr_src = _kp_thresholds(side_src)
    thr_tgt = _kp_thresholds(side_tgt)
    kp_src = side_src.kp_indices.cpu().numpy()
    kp_tgt = side_tgt.kp_indices.cpu().numpy()
    n_src, n_tgt = len(kp_src), len(kp_tgt)

    def build(rows, match_rows, dists):
        return _build_correspondences(rows, match_rows, dists, thr_src, thr_tgt,
                                      params.distance_thr, kp_src, kp_tgt, dev)

    mi_ij, md_ij, mm_ij, sd_ij, sm_ij = match_multiscale(side_src, side_tgt, params)
    if debug is not None:
        rows = np.nonzero(mm_ij[:n_src])[0]
        debug["winners_st"] = dict(query=kp_src[rows],
                                   match=kp_tgt[np.clip(mi_ij[rows], 0, max(n_tgt - 1, 0))])
    matching_id = params.matching_id
    if matching_id == MATCHING_RATIO:
        # the reference's RatioMatcher is a stub (matching.h:460-478); as in
        # the JAX package a match passes when the runner-up is at least
        # MATCHING_RATIO_THRESHOLD farther in descriptor space
        passes = mm_ij[:n_src] & (~sm_ij[:n_src]
                                  | (sd_ij[:n_src] > MATCHING_RATIO_THRESHOLD * md_ij[:n_src]))
        rows = np.nonzero(passes)[0]
        return build(rows, mi_ij[rows], md_ij[rows])
    if matching_id == MATCHING_ONE_SIDED:
        rows = np.nonzero(mm_ij[:n_src])[0]
        return build(rows, mi_ij[rows], md_ij[rows])

    mi_ji, md_ji, mm_ji, _sd, _sm = match_multiscale(side_tgt, side_src, params,
                                                     inverse_tn=True)
    if matching_id == MATCHING_CLUSTER:
        nbq_idx, nbq_mask = _kps_knn(side_src, params.cluster_k)
        nbt_idx, nbt_mask = _kps_knn(side_tgt, params.cluster_k)
        d_i = _cluster_distances(torch.from_numpy(mi_ij).to(dev), torch.from_numpy(mm_ij).to(dev),
                                 nbq_idx, nbq_mask, nbt_idx, nbt_mask).cpu().numpy()
        d_j_all = _cluster_distances(torch.from_numpy(mi_ji).to(dev),
                                     torch.from_numpy(mm_ji).to(dev), nbt_idx, nbt_mask,
                                     nbq_idx, nbq_mask).cpu().numpy()
        d_j = d_j_all[mi_ij]
        keep = (mm_ij[:n_src] & (d_i[:n_src] < MATCHING_CLUSTER_THRESHOLD)
                & (d_j[:n_src] < MATCHING_CLUSTER_THRESHOLD))
        rows = np.nonzero(keep)[0]
        return build(rows, mi_ij[rows], np.maximum(d_i[rows], d_j[rows]))

    # the left-to-right mutual filter (default fallback, matching.h:418-458)
    if matching_id != MATCHING_LEFT_TO_RIGHT:
        warnings.warn(f"feature matcher {matching_id!r} isn't supported, lr will be used")
    j = mi_ij[:n_src]
    mutual = mm_ij[:n_src] & mm_ji[j] & (mi_ji[j] == np.arange(n_src))
    rows = np.nonzero(mutual)[0]
    return build(rows, mi_ij[rows], md_ji[mi_ij[rows]])


def feature_based_correspondence_search(src: Cloud, tgt: Cloud, params: AlignmentParameters,
                                        debug: Optional[dict] = None) -> Correspondences:
    """FeatureBasedCorrespondenceSearch::calculateCorrespondences
    (correspondence_search.cpp:4-16): keypoints, the pyramid of each side,
    the strategy, on the clouds' device.  `debug` (a dict) receives the
    sides' level ranges and buckets and the vote's winners."""
    from lidar_global_registration_tpu_torch.ops.iss import detect_keypoints

    idx_src = detect_keypoints(src, params.keypoint_id, params.iss_radius_src)
    idx_tgt = detect_keypoints(tgt, params.keypoint_id, params.iss_radius_tgt)
    side_src = initialize_side(src, idx_src, params, params.vp_src, params.iss_radius_src,
                               True, debug)
    # lrf 'gt': the target side's frames are the identity (matching.h:153-155)
    params_tgt = params
    if params.lrf_id.lower() == LRF_GT:
        params_tgt = params.replace(ground_truth=np.eye(4, dtype=np.float32))
    side_tgt = initialize_side(tgt, idx_tgt, params_tgt, params.vp_tgt, params.iss_radius_tgt,
                               False, debug)
    return match_sides(side_src, side_tgt, params, debug)


def _cluster_distances(match_of_q, has_q, nbq_idx, nbq_mask, nbt_idx, nbt_mask):
    """1 - (consistent pairs / total pairs) per (i, match(i)) pair
    (ClusterMatcher::calculateCorrespondenceDistance, matching.h:524-550).

    match_of_q i64[Mq] best train row per query row, has_q bool[Mq];
    nbq_idx/mask [Mq, Kc] kNN of query keypoints among query keypoints,
    nbt_idx/mask [Mt, Kc] the same on the train side.  Returns f32[Mq]."""
    j = match_of_q
    jn = nbt_idx[j]  # neighbours of the matched train keypoint
    jn_mask = nbt_mask[j]
    nb_match = match_of_q[nbq_idx]  # matches of i's neighbours
    nb_has = has_q[nbq_idx] & nbq_mask
    member = ((nb_match[:, :, None] == jn[:, None, :]) & jn_mask[:, None, :]).any(2)
    cc = (nb_has & member).sum(1).to(torch.float32)
    cp = nb_has.sum(1).to(torch.float32)
    return torch.where(cp > 0, 1.0 - cc / cp.clamp_min(1.0), 0.0)


def _first_argmax(key: torch.Tensor) -> torch.Tensor:
    """Column of each row's maximum, the lowest among equal maxima (what
    jnp.argmax promises; torch.argmax promises no order among equals)."""
    L = key.shape[1]
    cols = torch.arange(L, device=key.device)[None, :]
    return torch.where(key == key.amax(1, keepdim=True), cols, L).amin(1).clamp_max(L - 1)


def _consensus_vote(cand_idx, cand_dist, cand_mask, train_xyz, iss_radius: float):
    """Winner per query among its cross-level candidates by spatial
    consensus (pyramid._consensus_vote, matching.h:264-354).

    cand_* : [M, L] (L = levels x randomness), cand_idx rows of train_xyz.
    Score of candidate m1 = sum over m2 >= m1 of iss_r / max(d3(m1, m2),
    iss_r) for the pairs within 32 iss_r (the reference's asymmetric
    m2 >= m1 loop, matching.h:330-340); the winner has the highest
    key = score - 1e-6 x descriptor distance, the first of equal keys.  The
    runner-up is the best key among candidates with another train index.

    d3 is a sum of squared differences (no Gram product: nothing for TF32
    or cancellation to touch) and each score is summed over m2 in
    ascending order, so the card and the CPU give the same winners.
    Returns (b_idx i64[M], b_dist f32[M], b_mask bool[M], s_dist f32[M],
    s_mask bool[M])."""
    L = cand_idx.shape[1]
    r = torch.tensor(iss_radius, dtype=torch.float32, device=train_xyz.device)
    pos = train_xyz[cand_idx]  # [M, L, 3]
    col = torch.arange(L, device=cand_idx.device)[None, :]
    counts = torch.zeros(cand_idx.shape, dtype=torch.float32, device=train_xyz.device)
    for m2 in range(L):
        d = pos - pos[:, m2:m2 + 1, :]
        d3 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
              + d[..., 2] * d[..., 2]).clamp_min(0.0).sqrt()  # [M, L]: m1 against m2
        pair_ok = cand_mask & cand_mask[:, m2:m2 + 1] & (d3 < 32.0 * r) & (col <= m2)
        counts = counts + torch.where(pair_ok, r / torch.maximum(d3, r), 0.0)
    counts = torch.where(cand_mask, counts, -torch.inf)
    key = counts - 1e-6 * cand_dist
    best = _first_argmax(key)[:, None]
    b_idx = cand_idx.gather(1, best)[:, 0]
    b_dist = cand_dist.gather(1, best)[:, 0]
    b_mask = cand_mask.gather(1, best)[:, 0]
    key2 = torch.where(cand_idx == b_idx[:, None], -torch.inf, key)
    second = _first_argmax(key2)[:, None]
    s_dist = cand_dist.gather(1, second)[:, 0]
    s_mask = cand_mask.gather(1, second)[:, 0] & (cand_idx.gather(1, second)[:, 0] != b_idx)
    return b_idx, b_dist, b_mask, s_dist, s_mask

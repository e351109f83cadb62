"""Alignment analysis against the ground truth and the CSV report
(lidar_global_registration_tpu/analysis.py:40-334).

Reference: src/analysis.cpp: rotation / translation errors, the point-cloud
RMSE under inv(T) @ T_gt, the overlap RMSE over the GT-overlap region (the
reference's success criterion), the median normal difference, correct
correspondences and inliers, the 3-axis uniformity entropy, the overlap
ratio and area; one row appended to data/debug/test_results.csv (the 38
columns of analysis.cpp:295-328).

The nearest-point queries are exact (ops/grid.nearest_within), as the
reference's kd-tree's; the JAX package's capped cells (cell_cap = 64 at
2 x distance_thr) find their nearest among a cell's first 64 points.
Medians and quantiles are taken on the host.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from lidar_global_registration_tpu_torch.models.ransac import _evaluate_one, build_metric_context
from lidar_global_registration_tpu_torch.ops import metrics as metricsmod
from lidar_global_registration_tpu_torch.ops.density import smoothed_densities
from lidar_global_registration_tpu_torch.ops.downsample import aabb
from lidar_global_registration_tpu_torch.ops.grid import nearest_within
from lidar_global_registration_tpu_torch.ops.transform import rotation_translation_error
from lidar_global_registration_tpu_torch.types import (
    DIST_TO_PLANE_COEFFICIENT,
    MATCHING_RATIO,
    AlignmentParameters,
    AlignmentResult,
    Cloud,
    Correspondences,
)
from lidar_global_registration_tpu_torch.utils.naming import VERSION, construct_path_simple


def _t32(T, device) -> torch.Tensor:
    """A 4x4 transform (array or tensor) as float32 on `device`."""
    if torch.is_tensor(T):
        return T.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(T, np.float32), device=device)


def _rotate(T: torch.Tensor, p: torch.Tensor, translate: bool = True) -> torch.Tensor:
    """p f32[M, 3] under the 4x4 T (its rotation alone unless `translate`)."""
    t = T[None, :3, 3] if translate else torch.zeros_like(T[None, :3, 3])
    return torch.stack(metricsmod.transform_points_soa(T[None, :3, :3], t, p), -1)[0]


def transform_cloud_xyz(xyz: torch.Tensor, valid: torch.Tensor, T) -> torch.Tensor:
    return torch.where(valid[:, None], _rotate(_t32(T, xyz.device), xyz), xyz)


def pointcloud_rmse(src: Cloud, T, T_gt) -> float:
    """calculatePointCloudRmse (analysis.cpp:30-43): rmse between the cloud
    and itself transformed by inv(T) @ T_gt."""
    D = np.linalg.inv(np.asarray(T, np.float32)) @ np.asarray(T_gt, np.float32)
    moved = transform_cloud_xyz(src.xyz, src.valid, D)
    d2 = torch.where(src.valid, ((moved - src.xyz) ** 2).sum(-1), 0.0)
    n = max(int(src.count()), 1)
    return float(np.sqrt(float(d2.sum()) / n))


def overlap_rmse(src: Cloud, tgt: Cloud, T, T_gt, inlier_threshold: float) -> float:
    """calculateOverlapRmse (analysis.cpp:45-88): for source points whose
    GT-aligned position lies within `inlier_threshold` of the target's
    nearest-neighbour plane, the RMSE of || T-aligned point - its
    projection on that plane ||."""
    aligned = transform_cloud_xyz(src.xyz, src.valid, T)
    aligned_gt = transform_cloud_xyz(src.xyz, src.valid, T_gt)
    radius = DIST_TO_PLANE_COEFFICIENT * inlier_threshold
    nn, _dist, found = nearest_within(tgt.xyz, tgt.valid, aligned_gt, src.valid,
                                      max(radius, 1e-12))
    npt, nrm = tgt.xyz[nn], tgt.normal[nn]
    nrm_ok = (nrm * nrm).sum(-1) > 0.5
    off = ((aligned_gt - npt) * nrm).sum(-1)
    plane_pt = aligned_gt - off[:, None] * nrm
    in_ov = found & nrm_ok & (off.abs() <= inlier_threshold)
    d = ((aligned - plane_pt) ** 2).sum(-1).clamp_min(0.0).sqrt()
    cnt = int(in_ov.sum())
    if cnt == 0:
        return float("nan")
    return float(np.sqrt(float(torch.where(in_ov, d * d, 0.0).sum()) / cnt))


def normal_difference(src: Cloud, tgt: Cloud, distance_thr: float, T_gt) -> float:
    """calculateNormalDifference (analysis.cpp:141-185): the median |angle|
    between the GT-aligned source normals and their nearest target point's
    normal within distance_thr."""
    Tg = _t32(T_gt, src.xyz.device)
    aligned = transform_cloud_xyz(src.xyz, src.valid, Tg)
    srcn = _rotate(Tg, src.normal, translate=False)
    nn, _dist, found = nearest_within(tgt.xyz, tgt.valid, aligned, src.valid,
                                      max(distance_thr, 1e-12))
    tn = tgt.normal[nn]
    ok = found & ((srcn * srcn).sum(-1) > 0.5) & ((tn * tn).sum(-1) > 0.5)
    ang = torch.arccos((srcn * tn).sum(-1).clamp(-1.0, 1.0)).abs()
    a = ang[ok].cpu().numpy()
    if len(a) == 0:
        return float(np.pi)
    return float(np.partition(a, len(a) // 2)[len(a) // 2])


def merge_overlaps(pcd1: Cloud, pcd2: Cloud, distance_thr: float):
    """mergeOverlaps (common.cpp:558-591): the symmetric point-to-NN-plane
    test; a boolean mask per side (the points in the overlap)."""
    out = []
    radius = DIST_TO_PLANE_COEFFICIENT * distance_thr
    for compared, reference in ((pcd1, pcd2), (pcd2, pcd1)):
        nn, dist, found = nearest_within(reference.xyz, reference.valid, compared.xyz,
                                         compared.valid, max(radius, 1e-12))
        npt, nrm = reference.xyz[nn], reference.normal[nn]
        d2p = (nrm * (npt - compared.xyz)).sum(-1).abs()
        nrm_ok = (nrm * nrm).sum(-1) > 0.5
        d2p = torch.where(nrm_ok, d2p, dist ** 2)
        out.append(found & (d2p < distance_thr) & compared.valid)
    return out[0], out[1]


def correct_correspondences(src: Cloud, tgt: Cloud, corrs: Correspondences, T_gt) -> np.ndarray:
    """buildCorrectCorrespondences (analysis.cpp:187-206): the GT-aligned
    source point lies within its pair's own threshold of its match."""
    p = transform_cloud_xyz(src.xyz, src.valid, T_gt)[corrs.query]
    d = ((p - tgt.xyz[corrs.match]) ** 2).sum(-1).clamp_min(0.0).sqrt()
    return ((d < corrs.threshold) & corrs.valid).cpu().numpy()


def correspondence_uniformity(src: Cloud, corrs: Correspondences, sel_mask) -> float:
    """calculateCorrespondenceUniformity over a subset of correspondences."""
    lo, hi = aabb(src.xyz, src.valid)
    bins3 = metricsmod.uniformity_bins(src.xyz[corrs.query], lo, hi)
    mask = torch.as_tensor(np.asarray(sel_mask), device=src.xyz.device)[None, :]
    return float(metricsmod.uniformity_entropy(mask, bins3)[0])


@dataclass
class AlignmentAnalysis:
    """AlignmentAnalysis (analysis.cpp:208-328 + analysis.h:36-98)."""

    result: AlignmentResult
    parameters: AlignmentParameters
    metric: float = 0.0
    rmse: float = 0.0
    n_inliers: int = 0
    n_correct_inliers: int = 0
    n_correspondences: int = 0
    n_correct_correspondences: int = 0
    r_error: float = float("nan")
    t_error: float = float("nan")
    pcd_error: float = float("nan")
    overlap_error: float = float("nan")
    normal_diff: float = float("nan")
    corr_uniformity: float = float("nan")
    overlap: float = float("nan")
    overlap_area: float = float("nan")

    def has_converged(self) -> bool:
        return self.result.converged

    def running_time(self) -> float:
        return self.result.time_cs + self.result.time_te

    def start(self, transformation_gt, testname: str, save: bool = True):
        src, tgt = self.result.src, self.result.tgt
        params = self.parameters
        corrs = self.result.correspondences
        T = self.result.transformation

        ctx = build_metric_context(src, tgt, corrs, params, sparse=False)
        m, inl, rmse, mask, _sup = _evaluate_one(ctx, T)
        self.metric = float(m)
        self.rmse = float(rmse)
        self.n_inliers = int(inl)
        self.n_correspondences = int(corrs.count())

        if transformation_gt is not None:
            T_gt = np.asarray(transformation_gt, np.float32)
            thr = params.distance_thr
            # overlap ratio / area under the GT alignment (analysis.cpp:226-234)
            src_gt = src.transformed(_t32(T_gt, src.xyz.device))
            ov_src, ov_tgt = merge_overlaps(src_gt, tgt, thr)
            n_ov = int(ov_src.sum()) + int(ov_tgt.sum())
            n_total = int(src.count()) + int(tgt.count())
            self.overlap = n_ov / max(n_total, 1)
            self.overlap_area = self._overlap_area(src_gt, tgt, ov_src, ov_tgt, src)

            cc = correct_correspondences(src, tgt, corrs, T_gt)
            self.n_correct_correspondences = int(cc.sum())
            # correct inliers: inlier mask AND the GT check (metric.cpp:83-101)
            self.n_correct_inliers = int((mask.cpu().numpy() & cc).sum())
            self.pcd_error = pointcloud_rmse(src, T, T_gt)
            self.overlap_error = overlap_rmse(src, tgt, T, T_gt, thr)
            self.normal_diff = normal_difference(src, tgt, thr, T_gt)
            self.corr_uniformity = correspondence_uniformity(src, corrs, cc)
            r, t = rotation_translation_error(torch.from_numpy(np.asarray(T, np.float32)),
                                              torch.from_numpy(T_gt))
            self.r_error = float(r)
            self.t_error = float(t)

        self.print_report(transformation_gt)
        if save:
            self.save(testname)
        return self

    def _overlap_area(self, src_gt, tgt, ov_src, ov_tgt, src) -> float:
        """Density-squared sums ratio (analysis.cpp:229-234)."""
        xyz = torch.cat([src_gt.xyz[ov_src], tgt.xyz[ov_tgt]], 0)
        if xyz.shape[0] < 2:
            return 0.0
        num = float((smoothed_densities(xyz) ** 2).sum())
        den = float((smoothed_densities(src.xyz[src.valid]) ** 2).sum())
        return num / max(den, 1e-30)

    def print_report(self, transformation_gt):
        T = self.result.transformation
        print("\n Estimated transformation:")
        print(np.array_str(np.asarray(T), precision=3, suppress_small=True))
        if transformation_gt is not None:
            print(" Ground truth transformation:")
            print(np.array_str(np.asarray(transformation_gt), precision=3, suppress_small=True))
        print(f"converged: {str(self.result.converged).lower()}")
        print(f"metric: {self.metric:.7f}")
        print(f"inliers_rmse: {self.rmse:.7f}")
        if transformation_gt is not None:
            print(f"correct inliers: {self.n_correct_inliers}/{self.n_inliers}")
            print(
                "correct correspondences: "
                f"{self.n_correct_correspondences}/{self.n_correspondences}"
            )
            print(f"rotation error (deg): {np.degrees(self.r_error):.7f}")
            print(f"translation error: {self.t_error:.7f}")
            print(f"point cloud error: {self.pcd_error:.7f}")
            print(f"median of normal differences (deg): {np.degrees(self.normal_diff):.7f}")
            print(
                "uniformity of correct correspondences' distribution: "
                f"{self.corr_uniformity:.7f}"
            )
        else:
            print(f"inliers: {self.n_inliers}")
            print(f"correspondences: {self.n_correspondences}")

    HEADER = (
        "version,descriptor,testname,metric,rmse,correspondences,"
        "correct_correspondences,inliers,correct_inliers,nr_points,"
        "distance_thr,edge_thr,iteration,matching_type,randomness,r_err,"
        "t_err,pcd_err,normal_diff,corr_uniformity,lrf_type,metric_type,"
        "overlap_rmse,alignment_type,keypoint_type,time_cs,time_te,"
        "score_type,iss_radius_src,iss_radius_tgt,normal_nr_points,"
        "reestimate,scale,cluster_k,feature_radius,overlap,overlap_area,"
        "converged\n"
    )

    def save(self, testname: str, dir_path: Optional[str] = None):
        """Append a row to test_results.csv (analysis.cpp:274-328)."""
        p = self.parameters
        filepath = construct_path_simple(
            "test", "results", "csv", with_version=False,
            dir_path=dir_path or p.dir_path,
        )
        exists = os.path.exists(filepath)
        matching_id = p.matching_id
        if matching_id == MATCHING_RATIO:
            matching_id += str(p.ratio_k)
        with open(filepath, "a") as f:
            if not exists:
                f.write(self.HEADER)
            row = [
                VERSION,
                p.descriptor_id,
                testname,
                f"{self.metric:g}",
                f"{self.rmse:g}",
                str(self.n_correspondences),
                str(self.n_correct_correspondences),
                str(self.n_inliers),
                str(self.n_correct_inliers),
                str(p.feature_nr_points),
                f"{p.distance_thr:g}",
                f"{p.edge_thr_coef:g}",
                str(self.result.iterations),
                matching_id,
                str(p.randomness),
                f"{self.r_error:g}",
                f"{self.t_error:g}",
                f"{self.pcd_error:g}",
                f"{self.normal_diff:g}",
                f"{self.corr_uniformity:g}",
                p.lrf_id,
                p.metric_id,
                f"{self.overlap_error:g}",
                p.alignment_id,
                p.keypoint_id,
                f"{self.result.time_cs:g}",
                f"{self.result.time_te:g}",
                p.score_id,
                f"{p.iss_radius_src:g}",
                f"{p.iss_radius_tgt:g}",
                str(p.normal_nr_points),
                str(int(p.reestimate_frames)),
                f"{p.scale_factor:g}",
                str(p.cluster_k),
                "" if p.feature_radius is None else f"{p.feature_radius:g}",
                f"{self.overlap:g}",
                f"{self.overlap_area:g}",
                str(int(self.result.converged)),
            ]
            f.write(",".join(row) + "\n")

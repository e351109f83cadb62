"""Multi-hypothesis pool and the choice of a hypothesis by the uniformity
of its inliers (lidar_global_registration_tpu/models/hypotheses.py).

Reference: src/hypotheses.cpp (compiled in with SAVE_MULTIPLE_HYPOTHESES,
sac_prerejective_omp.cpp:11).  The pool keeps dissimilar transforms (two are
similar when their rotations lie within 20 degrees and their translations
within 20 x distance_thr) and drops any below 0.1 x the best metric; the
winner is the hypothesis whose correspondence inliers are spread most
uniformly (the 3-axis projected entropy).  The pool is a few host entries;
scoring it is one batched metric evaluation on the clouds' device.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from lidar_global_registration_tpu_torch.ops import metrics as metricsmod
from lidar_global_registration_tpu_torch.ops.downsample import aabb
from lidar_global_registration_tpu_torch.ops.transform import rotation_translation_error
from lidar_global_registration_tpu_torch.types import AlignmentParameters, Cloud, Correspondences
from lidar_global_registration_tpu_torch.utils.naming import construct_path_simple

MIN_ANGLE = np.pi / 9  # hypotheses.cpp:8
MIN_DISTANCE_COEF = 20
MIN_METRIC_COEF = 0.1
CSV_HEADER = ("testname,id,r_err,t_err,inliers,mse,inliers_area,uniformity,overlap,"
              "overlap_area\n")


def _errors(T1, T2):
    r, t = rotation_translation_error(torch.as_tensor(np.asarray(T1, np.float32)),
                                      torch.as_tensor(np.asarray(T2, np.float32)))
    return float(r), float(t)


def update_hypotheses(transformations: List[np.ndarray], metrics: List[float],
                      new_transformation: np.ndarray, new_metric: float,
                      params: AlignmentParameters) -> None:
    """updateHypotheses (hypotheses.cpp:14-48), in place: a new hypothesis
    below 0.1 x the best metric, or similar to a better one, is dropped; it
    replaces the similar ones it beats; a new best drops every hypothesis
    below 0.1 x its metric."""
    assert len(transformations) == len(metrics)
    best = max(metrics) if metrics else 0.0
    if new_metric < MIN_METRIC_COEF * best:
        return
    similar_desc = []
    for i in range(len(transformations) - 1, -1, -1):
        r, t = _errors(new_transformation, transformations[i])
        if r < MIN_ANGLE and t < MIN_DISTANCE_COEF * params.distance_thr:
            if metrics[i] > new_metric:
                return  # a better similar hypothesis is in the pool
            similar_desc.append(i)
    for i in similar_desc:  # descending
        del transformations[i]
        del metrics[i]
    transformations.append(np.asarray(new_transformation))
    metrics.append(float(new_metric))
    if new_metric > best:
        for i in range(len(transformations) - 1, -1, -1):
            if metrics[i] < MIN_METRIC_COEF * new_metric:
                del transformations[i]
                del metrics[i]


def _area(xyz: torch.Tensor) -> float:
    """Sum of squared k = 2 smoothed densities of the points (their area)."""
    from lidar_global_registration_tpu_torch.ops.density import smoothed_densities

    return float((smoothed_densities(xyz) ** 2).sum())


def choose_best_hypothesis(src: Cloud, tgt: Cloud, corrs: Correspondences,
                           params: AlignmentParameters, tns: List[np.ndarray],
                           save_csv: bool = True) -> np.ndarray:
    """chooseBestHypothesis (hypotheses.cpp:50-130): of the hypotheses
    `tns`, the one whose correspondence inliers have the highest 3-axis
    entropy uniformity (the first of equal ones; the identity for an empty
    pool).  With save_csv one row per hypothesis (the ground truth first,
    labelled gt, when params has one) is appended to test_hypotheses.csv:
    rotation and translation errors against the ground truth, inliers,
    metric, the inliers' area, uniformity, the overlap's points and area."""
    from lidar_global_registration_tpu_torch.analysis import merge_overlaps

    if not tns:
        return np.eye(4, dtype=np.float32)
    dev = src.xyz.device
    p = src.xyz[corrs.query]
    q = tgt.xyz[corrs.match]
    lo, hi = aabb(src.xyz, src.valid)
    bins3 = metricsmod.uniformity_bins(p, lo, hi)
    analyzed, ids = [], []
    if params.ground_truth is not None:
        analyzed.append(np.asarray(params.ground_truth, np.float32))
        ids.append("gt")
    analyzed += [np.asarray(t, np.float32) for t in tns]
    ids += [str(i + 1) for i in range(len(tns))]
    T = torch.from_numpy(np.stack(analyzed)).to(dev)
    metric, cnt, _rmse, mask, _d = metricsmod.corr_metric(
        T[:, :3, :3], T[:, :3, 3], p, q, corrs.threshold, corrs.valid, "mse")
    unif = metricsmod.uniformity_entropy(mask, bins3).cpu().numpy()
    metric, cnt = metric.cpu().numpy(), cnt.cpu().numpy()
    rows, best_u, best_T = [], 0.0, np.eye(4, dtype=np.float32)
    for i, label in enumerate(ids):
        r_err = t_err = ""
        if params.ground_truth is not None:
            r, t = _errors(analyzed[i], params.ground_truth)
            r_err, t_err = f"{r:g}", f"{t:g}"
        inlier_xyz = p[mask[i]]
        inl_area = _area(inlier_xyz) if inlier_xyz.shape[0] > 1 else 0.0
        moved = src.transformed(T[i])
        ovs, ovt = merge_overlaps(moved, tgt, params.distance_thr)
        xyz_ov = torch.cat([moved.xyz[ovs], tgt.xyz[ovt]])
        ov_count = int(xyz_ov.shape[0])
        ov_area = _area(xyz_ov) if ov_count > 1 else 0.0
        u = float(unif[i])
        rows.append(f"{params.testname},{label},{r_err},{t_err},{int(cnt[i])},"
                    f"{float(metric[i]):g},{inl_area:g},{u:g},{ov_count},{ov_area:g}\n")
        if label != "gt" and u > best_u:
            best_u, best_T = u, analyzed[i]
    if save_csv:
        filepath = construct_path_simple("test", "hypotheses", "csv", with_version=False)
        exists = os.path.exists(filepath)
        with open(filepath, "a") as f:
            if not exists:
                f.write(CSV_HEADER)
            f.writelines(rows)
    return best_T

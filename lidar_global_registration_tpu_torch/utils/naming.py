"""Versioned artifact naming — the experiment cache key
(lidar_global_registration_tpu/utils/naming.py, copied: pure host code).

Reference: constructName / constructPath (src/common.cpp:1168-1221).  Every
output file name encodes the full parameter tuple + VERSION, making the
filesystem an addressable cache of results keyed by canonical parameter
strings (SURVEY.md section 5 "checkpoint/resume").  The format is kept
byte-compatible so artifacts can be exchanged with the reference pipeline.
"""
from __future__ import annotations

import os

from lidar_global_registration_tpu_torch.types import (
    AlignmentParameters,
    MATCHING_RATIO,
    METRIC_WEIGHT_CONSTANT,
    METRIC_WEIGHTED_CLOSEST_PLANE,
)

DATA_DEBUG_PATH = os.path.join("data", "debug")
TRANSFORMATIONS_CSV = "transformations.csv"
ITERATIONS_CSV = "iterations.csv"
VERSION = "15"
SUBVERSION = ""


def _fmt_float(x: float) -> str:
    """std::to_string(float) prints 6 fixed decimals."""
    return f"{x:.6f}"


def construct_name(
    params: AlignmentParameters,
    name: str,
    with_version: bool = True,
    with_metric: bool = True,
    with_weights: bool = True,
    with_subversion: bool = False,
) -> str:
    with_weights = (
        params.metric_id == METRIC_WEIGHTED_CLOSEST_PLANE
        and params.weight_id != METRIC_WEIGHT_CONSTANT
        and with_weights
    )
    matching_id = params.matching_id
    if matching_id == MATCHING_RATIO:
        matching_id += str(params.ratio_k)
    parts = [
        params.testname,
        name,
        str(params.feature_nr_points),
        params.descriptor_id,
        "bf" if params.use_bfmatcher else "flann",
    ]
    if with_metric:
        parts.append(params.alignment_id)
    parts += [params.keypoint_id, params.lrf_id]
    if with_metric:
        parts += [params.metric_id, params.score_id]
    parts += [matching_id, str(params.randomness)]
    if with_weights:
        parts.append(params.weight_id)
    parts += [
        str(params.normal_nr_points),
        str(int(params.reestimate_frames)),
        _fmt_float(params.iss_radius_src),
        _fmt_float(params.iss_radius_tgt),
        _fmt_float(params.scale_factor),
        str(params.cluster_k),
    ]
    if params.feature_radius is not None:
        parts.append(_fmt_float(params.feature_radius))
    if with_version:
        parts.append(VERSION)
    full = "_".join(parts)
    if with_subversion:
        full += SUBVERSION
    return full


def construct_path_simple(
    test: str,
    name: str,
    extension: str = "ply",
    with_version: bool = True,
    with_subversion: bool = False,
    dir_path: str = DATA_DEBUG_PATH,
) -> str:
    filename = f"{test}_{name}"
    if with_version:
        filename += f"_{VERSION}"
    if with_subversion:
        filename += SUBVERSION
    os.makedirs(dir_path, exist_ok=True)
    return os.path.join(dir_path, f"{filename}.{extension}")


def construct_path(
    params: AlignmentParameters,
    name: str,
    extension: str = "ply",
    with_version: bool = True,
    with_metric: bool = True,
    with_weights: bool = True,
    with_subversion: bool = False,
) -> str:
    test_dir = os.path.join(params.dir_path, params.testname)
    os.makedirs(test_dir, exist_ok=True)
    filename = construct_name(
        params, name, with_version, with_metric, with_weights, with_subversion
    )
    return os.path.join(test_dir, f"{filename}.{extension}")

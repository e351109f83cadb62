"""Data model of the registration path: constants, the parameter and result
records, and padded clouds and correspondences as torch tensors
(lidar_global_registration_tpu/types.py).

Reference equivalents: AlignmentParameters <-> include/common.h:135-163
(defaults common.h:38-60), AlignmentResult <-> common.h:165-174, Cloud <->
pcl::PointCloud<PointN>, Correspondences <-> common.h:120-131.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

SEED = 566  # the reference's default random seed

# ---------------------------------------------------------------------------
# String ids (reference: src/common.cpp:29-59)
# ---------------------------------------------------------------------------
ALIGNMENT_RANSAC = "ransac"
ALIGNMENT_GROR = "gror"
ALIGNMENT_TEASER = "teaser"
KEYPOINT_ANY = "any"
KEYPOINT_ISS = "iss"
DESCRIPTOR_FPFH = "fpfh"
DESCRIPTOR_SHOT = "shot"
DESCRIPTOR_ROPS = "rops"
DESCRIPTOR_USC = "usc"
DEFAULT_LRF = "default"
LRF_GRAVITY = "gravity"
LRF_GT = "gt"
METRIC_CORRESPONDENCES = "correspondences"
METRIC_UNIFORMITY = "uniformity"
METRIC_CLOSEST_PLANE = "closest_plane"
METRIC_WEIGHTED_CLOSEST_PLANE = "weighted_closest_plane"
METRIC_COMBINATION = "combination"
MATCHING_LEFT_TO_RIGHT = "lr"
MATCHING_RATIO = "ratio"
MATCHING_CLUSTER = "cluster"
MATCHING_ONE_SIDED = "one_sided"
METRIC_WEIGHT_CONSTANT = "constant"
METRIC_WEIGHT_EXP_CURVATURE = "exp_curvature"
METRIC_WEIGHT_CURVEDNESS = "curvedness"
METRIC_WEIGHT_HARRIS = "harris"
METRIC_WEIGHT_TOMASI = "tomasi"
METRIC_WEIGHT_CURVATURE = "curvature"
METRIC_WEIGHT_NSS = "nss"
METRIC_SCORE_CONSTANT = "constant"
METRIC_SCORE_MAE = "mae"
METRIC_SCORE_MSE = "mse"
METRIC_SCORE_EXP = "exp"

# Defaults (reference: include/common.h:38-60)
ALIGNMENT_EDGE_THR = 0.95
ALIGNMENT_CONFIDENCE = 0.999
ALIGNMENT_USE_BFMATCHER = True
ALIGNMENT_RANDOMNESS = 1
ALIGNMENT_N_SAMPLES = 3
ALIGNMENT_BLOCK_SIZE = 10000
FEATURES_SCALE_FACTOR = 2.0
FEATURES_REESTIMATE_FRAMES = True
MATCHING_CLUSTER_THRESHOLD = 0.95
MATCHING_CLUSTER_K = 40
MATCHING_RATIO_K = 2
MATCHING_RATIO_THRESHOLD = 1.1  # common.h:49
SPARSE_POINTS_FRACTION = 0.01
FEATURE_NR_POINTS = 352
NORMAL_NR_POINTS = 30
FINE_VOXEL_SIZE_COEFFICIENT = 2.0
DIST_TO_PLANE_COEFFICIENT = 2.0

DESCRIPTOR_DIMS = {
    DESCRIPTOR_FPFH: 33,
    DESCRIPTOR_SHOT: 352,
    DESCRIPTOR_ROPS: 135,
    DESCRIPTOR_USC: 1960,
}


def round_up(n: int, m: int = 128) -> int:
    """Round `n` up to a multiple of `m`, at least `m`."""
    return max(m, ((int(n) + m - 1) // m) * m)


@dataclass
class Cloud:
    """Padded struct-of-arrays point cloud on one device.

    xyz:       f32[N, 3]  positions (padding rows hold PAD_COORD)
    normal:    f32[N, 3]  unit normals (zero where unknown)
    weight:    f32[N]     accumulated downsample weight (ref `intensity`)
    curvature: f32[N]     surface-variation curvature from the normal PCA
    valid:     bool[N]    mask of real points
    """

    xyz: torch.Tensor
    normal: torch.Tensor
    weight: torch.Tensor
    curvature: torch.Tensor
    valid: torch.Tensor

    # Padding coordinate: finite (no NaN propagation) and beyond any radius.
    PAD_COORD = 1.0e18

    @property
    def capacity(self) -> int:
        return int(self.xyz.shape[0])

    def count(self) -> torch.Tensor:
        return self.valid.sum()

    @staticmethod
    def from_numpy(xyz, normal=None, weight=None, capacity: Optional[int] = None,
                   pad_multiple: int = 128, device=None) -> "Cloud":
        """A padded cloud of the rows given (arrays or tensors) on `device`,
        by default the device of a tensor `xyz` (the CPU for an array)."""
        xyz = torch.as_tensor(xyz, dtype=torch.float32, device=device)
        dev = xyz.device
        n = xyz.shape[0]
        cap = capacity if capacity is not None else round_up(n, pad_multiple)
        if cap < n:
            raise ValueError(f"capacity {cap} below the {n} points given")
        f32 = dict(dtype=torch.float32, device=dev)
        pxyz = torch.full((cap, 3), Cloud.PAD_COORD, **f32)
        pxyz[:n] = xyz
        pnormal = torch.zeros((cap, 3), **f32)
        if normal is not None:
            pnormal[:n] = torch.as_tensor(normal, **f32)
        pweight = torch.zeros((cap,), **f32)
        pweight[:n] = 1.0 if weight is None else torch.as_tensor(weight, **f32)
        pvalid = torch.arange(cap, device=dev) < n
        return Cloud(pxyz, pnormal, pweight, torch.zeros((cap,), **f32), pvalid)

    def compact(self, capacity: Optional[int] = None, pad_multiple: int = 128) -> "Cloud":
        """The valid rows, in order, re-padded to a fresh capacity
        (round_up(n, pad_multiple) unless given), on the same device."""
        idx = torch.nonzero(self.valid).squeeze(1)
        n = idx.shape[0]
        cap = capacity if capacity is not None else round_up(n, pad_multiple)
        if cap < n:
            raise ValueError(f"capacity {cap} below the {n} points given")

        def take(a, fill):
            out = torch.full((cap,) + a.shape[1:], fill, dtype=a.dtype, device=a.device)
            out[:n] = a[idx]
            return out

        return Cloud(take(self.xyz, Cloud.PAD_COORD), take(self.normal, 0.0),
                     take(self.weight, 0.0), take(self.curvature, 0.0), take(self.valid, False))

    def transformed(self, T: torch.Tensor) -> "Cloud":
        """Positions (valid rows) and normals under the rigid 4x4 transform T,
        in elementwise float32 arithmetic (metrics.transform_points_soa)."""
        from lidar_global_registration_tpu_torch.ops.metrics import transform_points_soa

        T = torch.as_tensor(T, dtype=torch.float32, device=self.xyz.device)
        R, t = T[None, :3, :3], T[None, :3, 3]
        xyz = torch.stack(transform_points_soa(R, t, self.xyz), -1)[0]
        xyz = torch.where(self.valid[:, None], xyz, self.xyz)
        normal = torch.stack(transform_points_soa(R, torch.zeros_like(t), self.normal), -1)[0]
        return dataclasses.replace(self, xyz=xyz, normal=normal)


@dataclass
class Correspondences:
    """Padded correspondence set with a per-pair adaptive inlier threshold
    min(max(density_src_i, density_tgt_j), distance_thr) (matching.h:404-407)."""

    query: torch.Tensor  # i64[M] row of the source cloud
    match: torch.Tensor  # i64[M] row of the target cloud
    distance: torch.Tensor  # f32[M] descriptor distance
    threshold: torch.Tensor  # f32[M] adaptive inlier threshold
    valid: torch.Tensor  # bool[M]

    @property
    def capacity(self) -> int:
        return int(self.query.shape[0])

    def count(self) -> torch.Tensor:
        return self.valid.sum()

    @staticmethod
    def empty(capacity: int, device=None) -> "Correspondences":
        return Correspondences(
            query=torch.zeros((capacity,), dtype=torch.int64, device=device),
            match=torch.zeros((capacity,), dtype=torch.int64, device=device),
            distance=torch.zeros((capacity,), dtype=torch.float32, device=device),
            threshold=torch.ones((capacity,), dtype=torch.float32, device=device),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )

    def to_numpy(self) -> dict:
        """The valid rows as host arrays: query, match, distance, threshold."""
        m = self.valid
        return {k: getattr(self, k)[m].cpu().numpy()
                for k in ("query", "match", "distance", "threshold")}

    def compact(self, capacity: Optional[int] = None,
                pad_multiple: int = 128) -> "Correspondences":
        """The valid rows first, re-padded to a fresh capacity, on the same
        device (padding: rows 0, threshold 1, invalid)."""
        idx = torch.nonzero(self.valid).squeeze(1)
        n = idx.shape[0]
        cap = capacity if capacity is not None else round_up(max(n, 1), pad_multiple)
        out = Correspondences.empty(cap, self.valid.device)
        for k in ("query", "match", "distance", "threshold", "valid"):
            getattr(out, k)[:n] = getattr(self, k)[idx]
        return out


# ---------------------------------------------------------------------------
# Parameters / result records (host-side)
# ---------------------------------------------------------------------------
@dataclass
class AlignmentParameters:
    """The single parameter record threaded through every layer.

    Field for field include/common.h:135-163; numeric defaults from
    common.h:38-60.
    """

    reestimate_frames: bool = FEATURES_REESTIMATE_FRAMES
    feature_nr_points: int = FEATURE_NR_POINTS
    normal_nr_points: int = NORMAL_NR_POINTS
    edge_thr_coef: float = ALIGNMENT_EDGE_THR
    distance_thr: float = 0.0
    iss_radius_src: float = 0.0
    iss_radius_tgt: float = 0.0
    feature_radius: Optional[float] = None  # None => multi-scale pyramid
    scale_factor: float = FEATURES_SCALE_FACTOR
    confidence: float = ALIGNMENT_CONFIDENCE
    use_bfmatcher: bool = ALIGNMENT_USE_BFMATCHER
    bf_block_size: int = ALIGNMENT_BLOCK_SIZE
    ratio_k: int = MATCHING_RATIO_K
    cluster_k: int = MATCHING_CLUSTER_K
    randomness: int = ALIGNMENT_RANDOMNESS
    n_samples: int = ALIGNMENT_N_SAMPLES
    alignment_id: str = ALIGNMENT_RANSAC
    descriptor_id: str = DESCRIPTOR_SHOT
    keypoint_id: str = KEYPOINT_ISS
    metric_id: str = METRIC_COMBINATION
    matching_id: str = MATCHING_CLUSTER
    lrf_id: str = DEFAULT_LRF
    weight_id: str = METRIC_WEIGHT_CONSTANT
    score_id: str = METRIC_SCORE_MSE
    max_iterations: int = 2**31 - 1
    save_features: bool = False
    testname: str = ""
    ground_truth: Optional[np.ndarray] = None  # 4x4
    # runtime-only fields (common.h:156-162)
    fix_seed: bool = True
    normals_available: bool = False
    match_search_radius: float = 0.0
    guess: Optional[np.ndarray] = None  # 4x4
    dir_path: str = "data/debug"
    vp_src: Optional[np.ndarray] = None  # 3
    vp_tgt: Optional[np.ndarray] = None  # 3
    # knobs of the staged path (no reference counterpart)
    hypothesis_batch: int = 512
    seed: int = 566
    bf16_matching: bool = False

    def replace(self, **kw) -> "AlignmentParameters":
        return dataclasses.replace(self, **kw)



@dataclass
class AlignmentResult:
    """Reference: include/common.h:165-174."""

    src: Cloud
    tgt: Cloud
    transformation: np.ndarray  # 4x4 float32
    correspondences: Correspondences
    iterations: int
    converged: bool
    time_te: float = 0.0  # transformation estimation time
    time_cs: float = 0.0  # correspondence search time
    metric: float = 0.0

"""The reference module of the feature-scale route: ISS keypoints, FPFH-33
on the feature-scale surface and the cluster gate.  A configuration names it
with `"reference": "feature_scale"`; manifest.load_cell loads it by that name
and refuses a configuration whose `flagship` differs from COVERS.

It works every product the check compares out again from the inputs the
benchmark gave the program: each side's pre-downsample, the radii, the ISS
keypoints (stages.py), the surface, normals and FPFH-33 at the keypoints,
the descriptor 1-NN both ways and the cluster gate (features.py), and a
least-squares pose over the gated correspondences (check.fit).  `control`
gives the same pose's correspondences and pose with every matrix product in
TF32, the control of the configuration's float32 with TF32 off.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark import check
from benchmark.reference import features, stages

# the flagship settings whose route this module reproduces
COVERS = {"use_iss": True, "feature_scale": True, "masked_features": True,
          "cluster_matching": True, "descriptor": "fpfh", "pyramid": False}
CONTROL_PRECISION = "tf32"


@dataclass
class PoseProducts:
    """The reference's products for one pooled pair."""
    vox_src: tuple  # (centroids, keys, grid)
    vox_tgt: tuple
    radii: dict
    kp_src: torch.Tensor  # bool[m] ISS flags of the source's rows
    kp_tgt: torch.Tensor
    corr: torch.Tensor  # i64[c, 2] the gated correspondences, reference rows
    T: np.ndarray  # the fit over the correspondences within thr of the truth
    counts: dict  # what the run's log prints of this pair
    desc_src: features.Keypoints
    desc_tgt: features.Keypoints


class Reference:
    """The reference's products for one run's traffic, worked out lazily per
    pose: the raw pair's densities, then each pose's voxel centroids, radii,
    keypoints, descriptors, gated correspondences and fitted pose."""

    def __init__(self, traffic, config: dict):
        self.tr = traffic
        self.factor = float(config["pre_downsample_voxel_per_density"])
        self.gate_cfg = config["flagship"]
        self.ds = stages.cloud_density(traffic.src)
        self.dt = stages.cloud_density(traffic.tgt_world)
        self._poses = {}

    def voxels(self) -> tuple[float, float]:
        return self.factor * self.ds, self.factor * self.dt

    def pose(self, k: int) -> PoseProducts:
        if k not in self._poses:
            self._poses[k] = self._pose(k)
        return self._poses[k]

    def _pose(self, k: int) -> PoseProducts:
        pair = self.tr.pairs[k]
        vs, vt = self.voxels()
        rs = stages.voxel_centroids(self.tr.src, vs, pair.aabb[0, 0])
        rt = stages.voxel_centroids(pair.tgt, vt, pair.aabb[1, 0])
        rr = stages.radii(stages.cloud_density(rs[0]), stages.cloud_density(rt[0]))
        kps = stages.iss_keypoints(rs[0], rr["iss_src"])
        kpt = stages.iss_keypoints(rt[0], rr["iss_tgt"])
        ds = features.describe(rs[0], kps, rr["feature"], self.tr.vp_src)
        dt = features.describe(rt[0], kpt, rr["feature"], pair.vp_tgt)
        corr = features.gate(ds, dt, self.gate_cfg, "float32")
        T = check.fit(rs[0], rt[0], corr, pair.T_gt, rr["thr"], "float32")
        counts = {"ISS keypoints": f"{int(kps.sum())} / {int(kpt.sum())}",
                  "descriptors": f"{int(ds.valid.sum())} / {int(dt.valid.sum())}",
                  "gated correspondences": corr.shape[0]}
        return PoseProducts(rs, rt, rr, kps, kpt, corr, T, counts, ds, dt)


def control(ref: Reference, k: int) -> tuple[torch.Tensor, np.ndarray]:
    """(gated correspondences, pose) of pose k with every matrix product in
    TF32: the descriptor 1-NN's and the gate's keypoint distances and the
    fit's cross-covariance; the stages before them form none."""
    pp = ref.pose(k)
    corr = features.gate(pp.desc_src, pp.desc_tgt, ref.gate_cfg, CONTROL_PRECISION)
    T = check.fit(pp.vox_src[0], pp.vox_tgt[0], corr, ref.tr.pairs[k].T_gt, pp.radii["thr"],
                  CONTROL_PRECISION)
    return corr, T

"""From an expanded parameter record to the staged path
(lidar_global_registration_tpu/models/pipeline.py: `staged_envelope`,
`_align_staged` and the staged branch of `align_point_clouds`,
alignment.cpp:72-110).

Loading and preprocessing scans, the host pyramid that the JAX package
takes outside the envelope, the analysis and the CSV artifacts are not
ported yet (ROADMAP.md, Queue 1, 'Host pipeline and CLI' and 'Host-path
ops'): outside the envelope `align_point_clouds` raises.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from lidar_global_registration_tpu_torch.models.flagship import (
    FlagshipConfig,
    register_pair_staged,
)
from lidar_global_registration_tpu_torch.ops.density import cloud_density
from lidar_global_registration_tpu_torch.types import (
    ALIGNMENT_GROR,
    ALIGNMENT_RANSAC,
    DEFAULT_LRF,
    DESCRIPTOR_FPFH,
    DESCRIPTOR_SHOT,
    FEATURE_NR_POINTS,
    FEATURES_REESTIMATE_FRAMES,
    KEYPOINT_ANY,
    KEYPOINT_ISS,
    LRF_GRAVITY,
    MATCHING_CLUSTER,
    MATCHING_LEFT_TO_RIGHT,
    METRIC_CORRESPONDENCES,
    METRIC_UNIFORMITY,
    NORMAL_NR_POINTS,
    AlignmentParameters,
    AlignmentResult,
    Cloud,
    Correspondences,
)


def staged_envelope(params: AlignmentParameters):
    """Whether an expanded parameter set lies inside what
    flagship.register_pair_staged can run: fpfh / shot x ransac / gror x a
    fixed feature radius or the AUTO pyramid x cluster / lr matching x the
    correspondences / uniformity metric.  Returns (FlagshipConfig | None,
    reason); the reason names the field that is outside.

    The AUTO radius (feature_radius None) is the multi-scale pyramid, which
    the staged path runs for ISS keypoints with cluster matching only.  The
    JAX package also asks for its cell-kernel backend there; this package
    always has its cell kernels (or their plain versions on the CPU)."""
    gates = [
        (params.alignment_id in (ALIGNMENT_RANSAC, ALIGNMENT_GROR),
         f"alignment {params.alignment_id!r}"),
        (params.descriptor_id in (DESCRIPTOR_FPFH, DESCRIPTOR_SHOT),
         f"descriptor {params.descriptor_id!r}"),
        (params.keypoint_id in (KEYPOINT_ISS, KEYPOINT_ANY),
         f"keypoint {params.keypoint_id!r}"),
        # cluster consensus is defined over ISS keypoints; dense (any) mode
        # matches mutually (lr).  one_sided / ratio are host strategies.
        (params.matching_id == MATCHING_LEFT_TO_RIGHT
         or (params.matching_id == MATCHING_CLUSTER
             and params.keypoint_id == KEYPOINT_ISS),
         f"matching {params.matching_id!r} with keypoint {params.keypoint_id!r}"),
        (params.descriptor_id != DESCRIPTOR_SHOT
         or params.lrf_id in (LRF_GRAVITY, DEFAULT_LRF),
         f"lrf {params.lrf_id!r}"),
        (params.metric_id in (METRIC_CORRESPONDENCES, METRIC_UNIFORMITY),
         f"metric {params.metric_id!r}"),
        (not params.save_features, "save_features"),
        (params.guess is None, "initial guess (matchLocal is host-side)"),
        # file normals: the host path post-processes estimated normals
        # against them (common.cpp:593-628); the staged kernels re-estimate
        # from positions only
        (not params.normals_available, "file normals present"),
        (params.feature_nr_points == FEATURE_NR_POINTS,
         f"feature_nr {params.feature_nr_points}"),
        (params.normal_nr_points == NORMAL_NR_POINTS,
         f"normal_nr {params.normal_nr_points}"),
        (params.reestimate_frames == FEATURES_REESTIMATE_FRAMES,
         f"reestimate {params.reestimate_frames}"),
    ]
    for ok, reason in gates:
        if not ok:
            return None, reason
    if params.feature_radius is None and not (
            params.keypoint_id == KEYPOINT_ISS and params.matching_id == MATCHING_CLUSTER):
        return None, ("AUTO feature radius (multi-scale pyramid) needs the "
                      "cell-kernel backend with iss+cluster")
    use_iss = params.keypoint_id == KEYPOINT_ISS
    cfg = FlagshipConfig(
        rounds=64 if use_iss else 8,
        hypothesis_batch=params.hypothesis_batch,
        use_iss=use_iss,
        match_tile=4096,
        metric=params.metric_id,
        descriptor=params.descriptor_id,
        lrf=params.lrf_id if params.descriptor_id == DESCRIPTOR_SHOT else LRF_GRAVITY,
        alignment=params.alignment_id,
        pyramid=params.feature_radius is None,
        scale_factor=params.scale_factor,
        pyramid_randomness=params.randomness,
        cluster_matching=params.matching_id == MATCHING_CLUSTER,
        cluster_k=params.cluster_k,
        n_samples=params.n_samples,
        edge_thr=params.edge_thr_coef,
        confidence=params.confidence,
        bf16_matching=params.bf16_matching,
    )
    return cfg, ""


def _align_staged(src: Cloud, tgt: Cloud, params: AlignmentParameters, cfg: FlagshipConfig,
                  density_src: Optional[float] = None, density_tgt: Optional[float] = None,
                  device="cuda") -> AlignmentResult:
    """Run the staged path on `device` and repackage its result
    (pipeline._align_staged).  The ISS radii and distance_thr come from
    the params record (expand_parameters derived them where the config
    left them unset, common.cpp:268, 327-333); the normal cell and, for the
    AUTO radius, the feature radius that gates the pyramid follow the
    FEATURE_NR_POINTS-disk derivation of the host pyramid
    (matching.h:177-208) from the larger density."""
    device = torch.device(device)
    density_src = float(cloud_density(src.xyz, src.valid) if density_src is None else density_src)
    density_tgt = float(cloud_density(tgt.xyz, tgt.valid) if density_tgt is None else density_tgt)
    d = max(density_src, density_tgt)
    normal_cell = float(np.sqrt(params.normal_nr_points * d * d / np.pi))
    feature_radius = (float(params.feature_radius) if params.feature_radius is not None
                      else float(np.sqrt(FEATURE_NR_POINTS * d * d / np.pi)))
    # the staged path sizes target buffers with the source capacity: pad
    # both sides to one shared capacity
    cap = max(src.capacity, tgt.capacity)

    def pad(c: Cloud):
        xyz = torch.full((cap, 3), Cloud.PAD_COORD, dtype=torch.float32, device=device)
        xyz[:c.capacity] = c.xyz
        valid = torch.zeros((cap,), dtype=torch.bool, device=device)
        valid[:c.capacity] = c.valid
        return xyz, valid

    sx, sv = pad(src)
    tx, tv = pad(tgt)
    seed = params.seed if params.fix_seed else int(np.random.default_rng().integers(2**31))
    generator = torch.Generator(device=device).manual_seed(seed)
    vps = {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
           for k, v in (("vp_src", params.vp_src), ("vp_tgt", params.vp_tgt)) if v is not None}
    t0 = time.time()
    out = register_pair_staged(
        sx, sv, tx, tv, generator, normal_cell, density_src, density_tgt,
        float(params.iss_radius_src), float(params.iss_radius_tgt), feature_radius,
        float(params.distance_thr), cfg=cfg, return_correspondences=True, **vps)
    T = out["transformation"].cpu().numpy()
    q_idx, m_idx, thr, valid = out["correspondences"]
    elapsed = time.time() - t0
    corrs = Correspondences(
        query=q_idx, match=m_idx,
        # the staged path does not export descriptor distances (the
        # correspondence stage consumes them on the device): 0.0 placeholders
        distance=torch.zeros((q_idx.shape[0],), dtype=torch.float32, device=q_idx.device),
        threshold=thr, valid=valid)
    return AlignmentResult(
        src=src, tgt=tgt, transformation=T.astype(np.float32), correspondences=corrs,
        iterations=int(out["iterations"]), converged=bool(out["converged"]),
        time_te=elapsed,
        time_cs=0.0,  # the staged path fuses search and solve into one timed run
        metric=float(out["metric"]))


def align_point_clouds(src: Cloud, tgt: Cloud, params: AlignmentParameters,
                       save_artifacts: bool = True,
                       correspondences: Optional[Correspondences] = None,
                       density_src: Optional[float] = None,
                       density_tgt: Optional[float] = None, device="cuda") -> AlignmentResult:
    """alignPointClouds (alignment.cpp:72-110), its staged branch: a
    parameter set inside the staged envelope runs register_pair_staged on
    `device`.  Everything else (pre-loaded correspondences, one_sided /
    ratio matching, rops / usc descriptors, closest-plane metrics, a guess,
    file normals) is the host pyramid path in the JAX package and raises
    here, as does saving the artifacts."""
    if save_artifacts:
        raise NotImplementedError(
            "save_artifacts=True (the correspondence CSV cache and transformations.csv) is "
            "not ported yet: see ROADMAP.md, Queue 1, 'Host pipeline and CLI' (utils/io.py, "
            "utils/naming.py)")
    if correspondences is not None:
        reason = "pre-loaded correspondences"
    else:
        cfg, reason = staged_envelope(params)
        if cfg is not None:
            return _align_staged(src, tgt, params, cfg, density_src, density_tgt, device)
    raise NotImplementedError(
        f"staged path unavailable ({reason}) and the host pyramid path is not ported yet: "
        "see ROADMAP.md, Queue 1, 'Host-path ops'")

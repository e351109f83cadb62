"""End-to-end registration pipeline: load -> preprocess -> the staged path
-> persist (lidar_global_registration_tpu/models/pipeline.py).

Reference call stack: loadPointClouds (common.cpp:429-470) ->
getParametersFromConfig -> alignPointClouds (alignment.cpp:72-110),
persisting the correspondence CSV cache and transformations.csv; runTest
(main.cpp:21-39) adds the analysis.

Every entry point runs on `device`, "cuda" unless the caller names
another; without a CUDA device the default raises.  The PLY parsing is
NumPy on the host; the duplicate filter, density, downsample and normals
run on the device.  A parameter set inside the staged envelope runs
register_pair_staged; outside it, and with pre-loaded correspondences,
`align_point_clouds` takes the host pyramid path (models/pyramid.py, then
models/ransac.align_ransac or models/gror.align_gror), as the JAX package
does.
"""
from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch

from lidar_global_registration_tpu_torch.models.flagship import (
    FlagshipConfig,
    register_pair_staged,
)
from lidar_global_registration_tpu_torch.models.gror import align_gror
from lidar_global_registration_tpu_torch.models.pyramid import (
    feature_based_correspondence_search,
)
from lidar_global_registration_tpu_torch.models.ransac import align_ransac
from lidar_global_registration_tpu_torch.ops.density import cloud_density
from lidar_global_registration_tpu_torch.ops.downsample import dedup_points, voxel_downsample
from lidar_global_registration_tpu_torch.ops.normals import estimate_normals_knn
from lidar_global_registration_tpu_torch.types import (
    ALIGNMENT_GROR,
    ALIGNMENT_RANSAC,
    ALIGNMENT_TEASER,
    DEFAULT_LRF,
    DESCRIPTOR_FPFH,
    DESCRIPTOR_SHOT,
    FEATURE_NR_POINTS,
    FEATURES_REESTIMATE_FRAMES,
    FINE_VOXEL_SIZE_COEFFICIENT,
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
from lidar_global_registration_tpu_torch.utils import io as iomod
from lidar_global_registration_tpu_torch.utils.config import Config, expand_parameters
from lidar_global_registration_tpu_torch.utils.naming import (
    DATA_DEBUG_PATH,
    TRANSFORMATIONS_CSV,
    construct_name,
    construct_path,
)


def resolve_device(device) -> torch.device:
    """torch.device(device); a CUDA device must exist (no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card unless the caller names "
                           "another device (device='cpu' runs the kernels' plain versions)")
    return dev


class _Clock:
    """Seconds of each step on `dev` (synchronised on a CUDA device)."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.last = time.perf_counter()

    def __call__(self) -> float:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        dt, self.last = now - self.last, now
        return dt


def cloud_from_ply(path: str, device="cuda", log: Optional[list] = None):
    """Load one scan: read the PLY on the host, then remove exact duplicate
    points on `device` (common.cpp:417-427).  Returns (Cloud, field_names);
    `log` gets the step lines."""
    dev = resolve_device(device)
    clock = _Clock(dev)
    fields, names = iomod.read_ply(path)
    xyz = np.stack([fields["x"], fields["y"], fields["z"]], axis=1).astype(np.float32)
    normal = None
    if iomod.cloud_has_normals(names):
        normal = np.stack([fields["normal_x"], fields["normal_y"], fields["normal_z"]],
                          axis=1).astype(np.float32)
    t_read = clock()
    x = torch.from_numpy(xyz).to(dev)
    keep = dedup_points(x)
    x = x[keep]
    nrm = None if normal is None else torch.from_numpy(normal).to(dev)[keep]
    cloud = Cloud.from_numpy(x, nrm)
    t_dedup = clock()
    if log is not None:
        log.append(f"read {t_read:.4f} s, dedup {t_dedup:.4f} s ({x.shape[0]} / {xyz.shape[0]} "
                   f"kept)")
    return cloud, names


def preprocess_cloud(cloud: Cloud, viewpoint=None, normals_available: bool = False,
                     normal_nr_points: int = NORMAL_NR_POINTS,
                     log: Optional[list] = None) -> Cloud:
    """The fine pre-downsample at 2x the density and the kNN normals
    (loadPointClouds, common.cpp:444-464), on the cloud's device."""
    clock = _Clock(cloud.xyz.device)
    density = cloud_density(cloud.xyz, cloud.valid)
    t_density = clock()
    voxel = FINE_VOXEL_SIZE_COEFFICIENT * density
    if voxel > 0:
        cloud = voxel_downsample(cloud, voxel).compact()
    t_down = clock()
    cloud = estimate_normals_knn(cloud, k=normal_nr_points, viewpoint=viewpoint,
                                 normals_available=normals_available)
    t_normals = clock()
    if log is not None:
        log.append(f"density {t_density:.4f} s ({density:.6g}), downsample {t_down:.4f} s "
                   f"({int(cloud.count())} rows), normals {t_normals:.4f} s")
    return cloud


def load_point_clouds(config: Config, device="cuda"):
    """loadPointClouds: both scans read, deduplicated and preprocessed on
    `device`, with their densities after preprocessing.  Returns (testname,
    src, tgt, fields_src, fields_tgt, density_src, density_tgt,
    normals_available, vp_src, vp_tgt) as the JAX function.  Prints each
    step's seconds, one line a scan."""
    src_path = config.get("source")
    tgt_path = config.get("target")
    logs = ([], [])
    src, fields_src = cloud_from_ply(src_path, device, logs[0])
    tgt, fields_tgt = cloud_from_ply(tgt_path, device, logs[1])
    normals_available = (iomod.cloud_has_normals(fields_src)
                         and iomod.cloud_has_normals(fields_tgt))
    vp_src = iomod.load_viewpoint(config.get("viewpoints"), src_path)
    vp_tgt = iomod.load_viewpoint(config.get("viewpoints"), tgt_path)
    src = preprocess_cloud(src, vp_src, normals_available, log=logs[0])
    tgt = preprocess_cloud(tgt, vp_tgt, normals_available, log=logs[1])
    densities = []
    for c, lg in ((src, logs[0]), (tgt, logs[1])):
        clock = _Clock(c.xyz.device)
        densities.append(cloud_density(c.xyz, c.valid))
        lg.append(f"density {clock():.4f} s ({densities[-1]:.6g})")
    for path, lg in ((src_path, logs[0]), (tgt_path, logs[1])):
        print(f"# load {os.path.basename(path)}: " + ", ".join(lg), flush=True)
    sb = os.path.basename(src_path)
    tb = os.path.basename(tgt_path)
    testname = sb[: sb.rfind(".")] + "_" + tb[: tb.rfind(".")]
    return (testname, src, tgt, fields_src, fields_tgt, densities[0], densities[1],
            normals_available, vp_src, vp_tgt)


parameters_from_config = expand_parameters  # the JAX package's name for it


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


def _on(record, dev: torch.device):
    """The Cloud or Correspondences with its tensors on `dev`."""
    return dataclasses.replace(record, **{f.name: getattr(record, f.name).to(dev)
                                          for f in dataclasses.fields(record)})


def align_point_clouds(src: Cloud, tgt: Cloud, params: AlignmentParameters,
                       save_artifacts: bool = True,
                       correspondences: Optional[Correspondences] = None,
                       density_src: Optional[float] = None,
                       density_tgt: Optional[float] = None, device="cuda") -> AlignmentResult:
    """alignPointClouds (alignment.cpp:72-110) on `device`.  A parameter set
    inside the staged envelope runs register_pair_staged.  Everything else
    (pre-loaded correspondences, one_sided / ratio matching, the
    closest-plane metrics, file normals, a non-default feature_nr /
    normal_nr / reestimate, ...) takes the host pyramid path, as the JAX
    package does, printing why: the correspondence search (models/pyramid,
    timed as time_cs) unless correspondences are given, then align_gror or
    align_ransac.  With save_artifacts the correspondence CSV cache and
    transformations.csv are written."""
    dev = resolve_device(device)
    if correspondences is None:
        cfg, reason = staged_envelope(params)
        if cfg is not None:
            result = _align_staged(src, tgt, params, cfg, density_src, density_tgt, dev)
            if save_artifacts:
                _persist_alignment_artifacts(src, tgt, params, result)
            return result
        print(f"# staged TPU path unavailable ({reason}); host pyramid path used", flush=True)

    src, tgt = _on(src, dev), _on(tgt, dev)
    if correspondences is not None:
        correspondences = _on(correspondences, dev)
    time_cs = 0.0
    if correspondences is None:
        t0 = time.time()
        correspondences = feature_based_correspondence_search(src, tgt, params)
        time_cs = time.time() - t0
    if params.alignment_id == ALIGNMENT_GROR:
        result = align_gror(src, tgt, correspondences, params)
    elif params.alignment_id == ALIGNMENT_TEASER:
        raise NotImplementedError("Not implemented: support TEASER")
    else:
        if params.alignment_id != ALIGNMENT_RANSAC:
            warnings.warn(f"alignment {params.alignment_id!r} isn't supported, RANSAC used")
        result = align_ransac(src, tgt, correspondences, params)
    result.time_cs = time_cs
    if save_artifacts:
        _persist_alignment_artifacts(src, tgt, params, result)
    return result


def _persist_alignment_artifacts(src: Cloud, tgt: Cloud, params: AlignmentParameters,
                                 result: AlignmentResult):
    """The correspondence CSV cache (alignment.cpp:87) and the
    transformations.csv rows (the GT first, when known) keyed by
    construct_name, as the JAX package writes them."""
    filepath = construct_path(params, "correspondences", "csv", True, False, False)
    iomod.save_correspondences_csv(filepath, src.xyz.cpu().numpy(), tgt.xyz.cpu().numpy(),
                                   result.correspondences)
    csv = os.path.join(DATA_DEBUG_PATH, TRANSFORMATIONS_CSV)
    os.makedirs(DATA_DEBUG_PATH, exist_ok=True)
    if params.ground_truth is not None:
        iomod.save_transformation(csv, construct_name(params, "transformation_gt"),
                                  params.ground_truth)
    iomod.save_transformation(csv, construct_name(params, "transformation"),
                              result.transformation)


def ground_truth(config: Config):
    """GT = inv(pose_tgt) @ pose_src from the config's ground_truth CSV, or
    None (common.cpp:83-106)."""
    gt_csv = config.get("ground_truth")
    if not gt_csv:
        return None
    return iomod.get_transformation_gt(gt_csv, os.path.basename(config.get("source")),
                                       os.path.basename(config.get("target")))


def run_test(config: Config, save_artifacts: bool = True, device="cuda"):
    """runTest (main.cpp:21-39): load, expand, align and analyse each
    parameter set on `device`.  Returns the analyses."""
    from lidar_global_registration_tpu_torch.analysis import AlignmentAnalysis

    dev = resolve_device(device)
    (testname, src, tgt, _fs, _ft, density_src, density_tgt, normals_available, vp_src,
     vp_tgt) = load_point_clouds(config, dev)
    gt = ground_truth(config)
    analyses = []
    for params in parameters_from_config(config, density_src, density_tgt, normals_available,
                                         vp_src, vp_tgt):
        params = params.replace(testname=testname,
                                ground_truth=None if gt is None else np.asarray(gt))
        print("Starting alignment...")
        result = align_point_clouds(src, tgt, params, save_artifacts, density_src=density_src,
                                    density_tgt=density_tgt, device=dev)
        clock = _Clock(dev)
        analysis = AlignmentAnalysis(result, params).start(gt, testname, save_artifacts)
        print(f"# alignment {result.time_te:.4f} s, analysis {clock():.4f} s", flush=True)
        analyses.append(analysis)
    return analyses

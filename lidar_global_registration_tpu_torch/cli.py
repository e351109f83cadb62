"""CLI / experiment entry point (lidar_global_registration_tpu/cli.py).

Reference: src/main.cpp, `registration <alignment|metric|debug> config.yaml`
with multi-test dispatch over the `tests:` list; test types: test / compare
/ keypoint / measure (main.cpp:384-431).

Usage:  python -m lidar_global_registration_tpu_torch <command> config.yaml

Runs on the CUDA device; `main(argv, device="cpu")` runs the kernels'
plain versions on the CPU (the tests do).  LGR_PROFILE=<dir> traces the
whole run with torch.profiler (utils/profiling.maybe_torch_profile).
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from lidar_global_registration_tpu_torch.types import (
    ALIGNMENT_RANSAC,
    Correspondences,
    round_up,
)
from lidar_global_registration_tpu_torch.utils import io as iomod
from lidar_global_registration_tpu_torch.utils.config import Config
from lidar_global_registration_tpu_torch.utils.naming import (
    DATA_DEBUG_PATH,
    TRANSFORMATIONS_CSV,
    construct_name,
    construct_path,
    construct_path_simple,
)

ALIGNMENT = "alignment"
METRIC_ANALYSIS = "metric"
DEBUG = "debug"


def _load_common(config: Config, device):
    from lidar_global_registration_tpu_torch.models.pipeline import (
        ground_truth,
        load_point_clouds,
        parameters_from_config,
    )

    (testname, src, tgt, _fs, _ft, density_src, density_tgt, normals_available, vp_src,
     vp_tgt) = load_point_clouds(config, device)
    gt = ground_truth(config)
    params_list = parameters_from_config(config, density_src, density_tgt, normals_available,
                                         vp_src, vp_tgt)
    params_list = [p.replace(testname=testname, ground_truth=None if gt is None else np.asarray(gt))
                   for p in params_list]
    return testname, src, tgt, gt, params_list


def _read_cached_correspondences(params, device) -> Correspondences:
    """The correspondence CSV cache of `params` as a padded set on `device`;
    exits when it is missing."""
    path = construct_path(params, "correspondences", "csv", True, False, False)
    data = iomod.read_correspondences_csv(path)
    if data is None:
        print(f"Failed to read correspondences for {params.testname} ({path})")
        sys.exit(1)
    q, m, d, t = data
    n = len(q)
    c = Correspondences.empty(round_up(max(n, 1)), device)
    for name, v in (("query", q), ("match", m), ("distance", d), ("threshold", t)):
        getattr(c, name)[:n] = torch.from_numpy(v).to(device)
    c.valid[:n] = True
    return c


def estimate_test_metric(config: Config, device="cuda"):
    """`metric` command (main.cpp:41-116): re-score the cached
    transformation and the GT over the cached correspondences with the
    correspondence and closest-plane metrics; appends test_metrics.csv."""
    from lidar_global_registration_tpu_torch.models.ransac import (
        _evaluate_one,
        build_metric_context,
    )

    testname, src, tgt, gt, params_list = _load_common(config, device)
    if gt is None:
        print(f"Failed to read ground truth for {testname}!")
        sys.exit(1)
    filepath = construct_path_simple("test", "metrics", "csv", with_version=False)
    exists = os.path.exists(filepath)
    with open(filepath, "a") as fout:
        if not exists:
            fout.write(
                "testname,metric_corr,metric_icp,inliers_corr,inliers_icp,"
                "metric_corr_gt,metric_icp_gt,inliers_corr_gt,inliers_icp_gt\n"
            )
        for params in params_list:
            tn_name = config.get("transformation", construct_name(params, "transformation"))
            tn = iomod.get_transformation(os.path.join(DATA_DEBUG_PATH, TRANSFORMATIONS_CSV),
                                          tn_name)
            corrs = _read_cached_correspondences(params, src.xyz.device)
            ctx_corr = build_metric_context(
                src, tgt, corrs, params.replace(metric_id="correspondences"), False)
            ctx_icp = build_metric_context(
                src, tgt, corrs, params.replace(metric_id="closest_plane"), False)
            row = [construct_name(params, "metric", True, True, False)]
            for T in (tn, gt):
                mc, ic, _r, _m, _s = _evaluate_one(ctx_corr, T)
                mi, ii, _r2, _m2, _s2 = _evaluate_one(ctx_icp, T)
                row += [f"{float(mc):g}", f"{float(mi):g}", str(int(ic)), str(int(ii))]
            fout.write(",".join(row) + "\n")
    print(f"appended {filepath}")


def _cached_transformation(params):
    return iomod.get_transformation(os.path.join(DATA_DEBUG_PATH, TRANSFORMATIONS_CSV),
                                    construct_name(params, "transformation"))


def generate_debug_files(config: Config, device="cuda"):
    """`debug` command (main.cpp:229-284): from the correspondence and
    transformation caches, both downsampled clouds coloured by keypoints,
    correspondences, inliers and correct correspondences, the ISS saliency
    (keypoint iss), the weights (metric weighted_closest_plane) and the
    temperature maps under the cached transformation."""
    from lidar_global_registration_tpu_torch.analysis import correct_correspondences
    from lidar_global_registration_tpu_torch.models.ransac import (
        _evaluate_one,
        build_metric_context,
    )
    from lidar_global_registration_tpu_torch.ops.iss import detect_keypoints, iss_keypoints
    from lidar_global_registration_tpu_torch.ops.weights import weight_function
    from lidar_global_registration_tpu_torch.types import (
        KEYPOINT_ISS,
        METRIC_WEIGHTED_CLOSEST_PLANE,
    )
    from lidar_global_registration_tpu_torch.utils import debug_viz

    testname, src, tgt, gt, params_list = _load_common(config, device)
    eye = np.eye(4, dtype=np.float32)
    for params in params_list:
        corrs = _read_cached_correspondences(params, src.xyz.device)
        tn = _cached_transformation(params)
        if params.keypoint_id == KEYPOINT_ISS:
            # one ISS pass a side gives the keypoints and the saliency dump
            # (ISSKeypoint3DDebug::saveEigenValues, iss_debug.cpp:4-12), named
            # iss_saliency as in the JAX package, apart from the weights below
            kps = []
            for cloud, r, tag in ((src, params.iss_radius_src, "src"),
                                  (tgt, params.iss_radius_tgt, "tgt")):
                is_kp, saliency = iss_keypoints(cloud, r)
                kps.append(torch.nonzero(is_kp & cloud.valid).squeeze(1))
                debug_viz.save_colorized_weights(cloud, saliency, f"iss_saliency_{tag}", params,
                                                 eye)
            idx_src, idx_tgt = kps
        else:
            idx_src = detect_keypoints(src, params.keypoint_id, params.iss_radius_src)
            idx_tgt = detect_keypoints(tgt, params.keypoint_id, params.iss_radius_tgt)
        ctx = build_metric_context(src, tgt, corrs, params, sparse=False)
        inliers = _evaluate_one(ctx, tn)[3][corrs.valid]
        correct = None
        if gt is not None:
            correct = correct_correspondences(src, tgt, corrs, gt)[corrs.valid.cpu().numpy()]
            debug_viz.save_cloud_with_correspondences(src, idx_src, corrs, correct, inliers,
                                                      params, gt, True)
        debug_viz.save_cloud_with_correspondences(tgt, idx_tgt, corrs, correct, inliers, params,
                                                  eye, False)
        if params.metric_id == METRIC_WEIGHTED_CLOSEST_PLANE:
            w = weight_function(params.weight_id, params.normal_nr_points, src)
            debug_viz.save_colorized_weights(src, w, "weights", params, tn)
        debug_viz.save_temperature_maps(src, tgt, "temperature", params, params.distance_thr, tn)
    print("debug artifacts written")


def compare_hypotheses(config: Config, device="cuda"):
    """`compare` test type (main.cpp:152-227): the temperature maps under
    the GT and under the cached transformation, and for each the points in
    the overlap and their count weighted by the squared smoothed density."""
    from lidar_global_registration_tpu_torch.analysis import merge_overlaps
    from lidar_global_registration_tpu_torch.ops.density import smoothed_densities
    from lidar_global_registration_tpu_torch.utils import debug_viz

    testname, src, tgt, gt, params_list = _load_common(config, device)
    if gt is None:
        print(f"Failed to read ground truth for {testname}!")
        sys.exit(1)
    for params in params_list:
        tn = _cached_transformation(params)
        debug_viz.save_temperature_maps(src, tgt, "temperature_gt", params, params.distance_thr,
                                        gt)
        debug_viz.save_temperature_maps(src, tgt, "temperature", params, params.distance_thr, tn)
        for label, T in (("incorrect", tn), ("correct", gt)):
            moved = src.transformed(T)
            ov_s, ov_t = merge_overlaps(moved, tgt, params.distance_thr)
            xyz = torch.cat([moved.xyz[ov_s], tgt.xyz[ov_t]])
            count = xyz.shape[0]
            wcount = float((smoothed_densities(xyz) ** 2).sum()) if count > 1 else 0.0
            print(f"\t{label} hypothesis: {count} points, {wcount} weighted points")


def analyze_keypoints(config: Config, device="cuda"):
    """`keypoint` test type (main.cpp:286-310): both clouds coloured by
    their keypoints, and the sub-voxel refinement of the first ISS
    keypoints (main.cpp:302-306) as red clouds; prints the keypoint counts
    and, as a step line, how many keypoints the refinement moved and how
    far."""
    from lidar_global_registration_tpu_torch.ops.iss import (
        detect_keypoints,
        subvoxel_iss_keypoints,
    )
    from lidar_global_registration_tpu_torch.types import Cloud
    from lidar_global_registration_tpu_torch.utils import debug_viz

    testname, src, tgt, gt, params_list = _load_common(config, device)
    eye = np.eye(4, dtype=np.float32)
    src_pose = gt if gt is not None else eye
    for params in params_list:
        idx_src = detect_keypoints(src, params.keypoint_id, params.iss_radius_src)
        idx_tgt = detect_keypoints(tgt, params.keypoint_id, params.iss_radius_tgt)
        for cloud, r, pose, tag in ((src, params.iss_radius_src, src_pose, "src"),
                                    (tgt, params.iss_radius_tgt, eye, "tgt")):
            refined, rows, ok = subvoxel_iss_keypoints(cloud, r)
            shift = (refined - cloud.xyz[rows]).norm(dim=1)
            print(f"# keypoint subvoxel {tag}: {rows.shape[0]} keypoints, {int(ok.sum())} "
                  f"refined, largest shift {float(shift.max()) if rows.numel() else 0.0:.6g} "
                  f"(iss radius {r:.6g})", flush=True)
            if rows.numel():
                debug_viz.save_colorized_cloud(Cloud.from_numpy(refined), pose,
                                               debug_viz.COLOR_RED,
                                               construct_path(params, f"subvoxel_kps_{tag}"))
        debug_viz.save_cloud_with_correspondences(src, idx_src, None, None, None, params,
                                                  src_pose, True)
        debug_viz.save_cloud_with_correspondences(tgt, idx_tgt, None, None, None, params, eye,
                                                  False)
        print(f"{len(idx_src)} src / {len(idx_tgt)} tgt keypoints")


def measure_test_results(config: Config, device="cuda"):
    """`measure` test type, the reference's benchmark harness
    (main.cpp:312-382): n_times alignments, reseeded; success = converged
    AND overlap_error < distance_thr; appends test_measurements.csv."""
    from lidar_global_registration_tpu_torch.analysis import AlignmentAnalysis
    from lidar_global_registration_tpu_torch.models.pipeline import align_point_clouds

    testname, src, tgt, gt, params_list = _load_common(config, device)
    n_times_cfg = int(config.get("n_times", 10))
    filepath = construct_path_simple("test", "measurements", "csv", with_version=False)
    exists = os.path.exists(filepath)
    with open(filepath, "a") as fout:
        if not exists:
            fout.write("testname,success_rate,mae,sae,mte,ste,mrmse,srmse,mtime,stime\n")
        for params in params_list:
            params = params.replace(fix_seed=False)
            if params.save_features and gt is not None:
                # main.cpp:342-344: the target's nearest-point ids under the GT
                from lidar_global_registration_tpu_torch.utils.debug_viz import (
                    save_extracted_point_ids,
                )

                save_extracted_point_ids(src, tgt, gt, params, tgt.xyz[tgt.valid])
            n_times = n_times_cfg if params.alignment_id == ALIGNMENT_RANSAC else 1
            r_errs, t_errs, ov_errs, times = [], [], [], []
            n_success = 0
            for _ in range(n_times):
                print("Starting alignment...")
                result = align_point_clouds(src, tgt, params, device=src.xyz.device)
                analysis = AlignmentAnalysis(result, params).start(gt, testname)
                ok = analysis.has_converged() and analysis.overlap_error < params.distance_thr
                if ok:
                    n_success += 1
                    r_errs.append(analysis.r_error)
                    t_errs.append(analysis.t_error)
                    ov_errs.append(analysis.overlap_error)
                times.append(analysis.running_time())

            def mean(v):
                return float(np.mean(v)) if v else float("nan")

            def std(v):
                return float(np.std(v)) if v else float("nan")

            fout.write(",".join([
                construct_name(params, "measure"), f"{n_success / n_times:g}",
                f"{mean(r_errs):g}", f"{std(r_errs):g}", f"{mean(t_errs):g}", f"{std(t_errs):g}",
                f"{mean(ov_errs):g}", f"{std(ov_errs):g}", f"{mean(times):g}", f"{std(times):g}",
            ]) + "\n")
            print(f"# measure: success rate {n_success}/{n_times}", flush=True)
    print(f"appended {filepath}")


def process_tests(tests, command: str, device="cuda"):
    from lidar_global_registration_tpu_torch.models.pipeline import run_test

    for test_type, cfg in tests:
        if test_type == "test":
            if command == ALIGNMENT:
                run_test(cfg, device=device)
            elif command == METRIC_ANALYSIS:
                estimate_test_metric(cfg, device)
            elif command == DEBUG:
                generate_debug_files(cfg, device)
        elif test_type == "compare":
            compare_hypotheses(cfg, device)
        elif test_type == "keypoint":
            analyze_keypoints(cfg, device)
        elif test_type == "measure":
            measure_test_results(cfg, device)
        else:
            print(f"Test type {test_type} isn't supported!")


def _device_report(dev: torch.device) -> None:
    """One line after a run on the card: peak device memory and the launches
    of each kernel wrapper in this process."""
    from lidar_global_registration_tpu_torch.ops import cellgrid, nn_l2

    wrappers = (cellgrid.surface_cuda, cellgrid.surface_at_cuda, cellgrid.iss_count_cuda,
                cellgrid.iss_saliency_cuda, cellgrid.iss_nms_cuda, cellgrid.iss_count_at_cuda,
                cellgrid.iss_saliency_at_cuda, cellgrid.iss_nms_at_cuda, cellgrid.spfh_cuda,
                cellgrid.spfh_at_cuda, cellgrid.combine_cuda, cellgrid.combine_at_cuda,
                nn_l2.nn_l2_cuda, nn_l2.nn_l2_bf16_cuda)
    launches = {w.__name__: w.launches for w in wrappers}
    print(f"# device: peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB; "
          f"launches {json.dumps(launches)}", flush=True)


def main(argv=None, device="cuda"):
    """`python -m lidar_global_registration_tpu_torch <command> config.yaml`;
    `device` is for the tests (the CLI itself always runs on the card)."""
    from lidar_global_registration_tpu_torch.models.pipeline import resolve_device, run_test
    from lidar_global_registration_tpu_torch.utils.profiling import maybe_torch_profile

    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2 or argv[0] not in (ALIGNMENT, METRIC_ANALYSIS, DEBUG):
        print(
            f"Syntax is: python -m lidar_global_registration_tpu_torch "
            f"[{ALIGNMENT}, {METRIC_ANALYSIS}, {DEBUG}] config.yaml"
        )
        sys.exit(1)
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)  # the context exists before the first timed step
    command, config_path = argv
    config = Config.load(config_path)
    tests = config.tests()
    with maybe_torch_profile(cuda=dev.type == "cuda"):
        if tests is not None:
            process_tests(tests, command, dev)
        elif command == ALIGNMENT:
            run_test(config, device=dev)
        elif command == METRIC_ANALYSIS:
            estimate_test_metric(config, dev)
        elif command == DEBUG:
            generate_debug_files(config, dev)
    if dev.type == "cuda":
        _device_report(dev)


if __name__ == "__main__":
    main()

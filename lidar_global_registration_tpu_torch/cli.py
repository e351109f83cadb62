"""CLI / experiment entry point (lidar_global_registration_tpu/cli.py).

Reference: src/main.cpp, `registration <alignment|metric|debug> config.yaml`
with multi-test dispatch over the `tests:` list; test types: test / compare
/ keypoint / measure (main.cpp:384-431).

Usage:  python -m lidar_global_registration_tpu_torch <command> config.yaml

Runs on the CUDA device; `main(argv, device="cpu")` runs the kernels'
plain versions on the CPU (the tests do).  The `debug` command and the
`compare` and `keypoint` test types need the debug PLY writers
(utils/debug_viz.py) and the sub-voxel ISS keypoints, which are not ported
yet: they raise.
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
_NOT_PORTED = ("needs utils/debug_viz.py and the sub-voxel ISS keypoints "
               "(ops/iss.subvoxel_iss_keypoints, ops/quadric.py), which are not ported yet: see "
               "ROADMAP.md, Queue 1, item 2 (the debug side of the CLI)")


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


def generate_debug_files(config: Config, device="cuda"):
    """`debug` command (main.cpp:229-284): not ported yet."""
    raise NotImplementedError(f"the debug command {_NOT_PORTED}")


def compare_hypotheses(config: Config, device="cuda"):
    """`compare` test type (main.cpp:152-227): not ported yet."""
    raise NotImplementedError(f"the compare test type {_NOT_PORTED}")


def analyze_keypoints(config: Config, device="cuda"):
    """`keypoint` test type (main.cpp:286-310): not ported yet."""
    raise NotImplementedError(f"the keypoint test type {_NOT_PORTED}")


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
                raise NotImplementedError(f"save_features in the measure test type {_NOT_PORTED}")
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
                cellgrid.iss_saliency_cuda, cellgrid.iss_nms_cuda, cellgrid.spfh_cuda,
                cellgrid.spfh_at_cuda, cellgrid.combine_cuda, cellgrid.combine_at_cuda,
                nn_l2.nn_l2_cuda, nn_l2.nn_l2_bf16_cuda)
    launches = {w.__name__: w.launches for w in wrappers}
    print(f"# device: peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB; "
          f"launches {json.dumps(launches)}", flush=True)


def main(argv=None, device="cuda"):
    """`python -m lidar_global_registration_tpu_torch <command> config.yaml`;
    `device` is for the tests (the CLI itself always runs on the card)."""
    from lidar_global_registration_tpu_torch.models.pipeline import resolve_device, run_test

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

"""The PyTorch port's host path end to end against the JAX package's:
align_point_clouds on parameter sets outside the staged envelope (SHOT +
gravity frames + cluster matching + the combination metric, RANSAC; FPFH +
lr matching + the weighted closest-plane metric, GROR), and one
`alignment` command of the port's CLI on such a set (RANSAC and GROR).

The pair is the range-graded scene of tests/test_torch_e2e_pyramid.py at
4,096 points a side; each package estimates its own kNN normals.  Their ISS
keypoints differ where the JAX package's capped fallback drops points (32 a
cell, 64 neighbours; the port's are exact), and RANSAC draws from other
generators, so the runs are compared by their poses.  RANSAC runs at most
4,096 iterations, in rounds of 128 hypotheses.
"""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

from lidar_global_registration_tpu import cli as jcli
from lidar_global_registration_tpu import types as jtypes
from lidar_global_registration_tpu.analysis import AlignmentAnalysis
from lidar_global_registration_tpu.models import pipeline as jpipe
from lidar_global_registration_tpu.ops.normals import estimate_normals_knn as jnormals
from lidar_global_registration_tpu_torch import cli as tcli
from lidar_global_registration_tpu_torch import types as ttypes
from lidar_global_registration_tpu_torch.models import pipeline as tpipe
from lidar_global_registration_tpu_torch.ops.normals import estimate_normals_knn as tnormals
from lidar_global_registration_tpu_torch.ops.transform import rotation_translation_error
from test_torch_cli import make_scan_pair
from test_torch_e2e_pyramid import pair_inputs

torch.set_num_threads(2)

BASE = dict(keypoint_id="iss", iss_radius_src=0.4, iss_radius_tgt=0.4, distance_thr=0.6,
            hypothesis_batch=128, max_iterations=4096)
SETS = {
    "shot_combination": dict(descriptor_id="shot", lrf_id="gravity", matching_id="cluster",
                             metric_id="combination", feature_radius=2.4),
    "fpfh_lr_weighted_gror": dict(descriptor_id="fpfh", matching_id="lr",
                                  metric_id="weighted_closest_plane",
                                  weight_id="exp_curvature", feature_radius=2.4,
                                  alignment_id="gror"),
}


def _err(T, ref):
    r, t = rotation_translation_error(torch.as_tensor(np.asarray(T, np.float32)),
                                      torch.as_tensor(np.asarray(ref, np.float32)))
    return float(r), float(t)


@pytest.fixture(scope="module")
def inputs():
    a, b, vp_a, vp_b, T_gt = pair_inputs()
    vps = dict(vp_src=vp_a, vp_tgt=vp_b)
    jc = [jnormals(jtypes.Cloud.from_numpy(x), k=30, viewpoint=v) for x, v in ((a, vp_a),
                                                                               (b, vp_b))]
    tc = [tnormals(ttypes.Cloud.from_numpy(x), k=30, viewpoint=v) for x, v in ((a, vp_a),
                                                                               (b, vp_b))]
    return dict(jax=jc, port=tc, vps=vps, T_gt=T_gt)


@pytest.fixture(scope="module", params=list(SETS))
def run(request, inputs):
    kw = {**BASE, **SETS[request.param], **inputs["vps"]}
    out = {}
    for name, mod, types, extra in (("jax", jpipe, jtypes, {}),
                                    ("port", tpipe, ttypes, {"device": "cpu"})):
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            res = mod.align_point_clouds(*inputs[name], types.AlignmentParameters(**kw),
                                         save_artifacts=False, **extra)
        out[name] = dict(res=res, log=log.getvalue())
    return dict(name=request.param, T_gt=inputs["T_gt"], **out)


def test_host_path_is_taken(run):
    metric = SETS[run["name"]]["metric_id"]
    for name in ("jax", "port"):
        assert (f"# staged TPU path unavailable (metric {metric!r}); host pyramid path used"
                in run[name]["log"]), name
    res = run["port"]["res"]
    assert res.time_cs > 0 and res.time_te > 0 and int(res.correspondences.count()) > 20


def test_pose_matches_jax_and_the_gt(run):
    """Both converge; the port's pose within 0.05 rad and 0.3 of the GT (the
    pair's distance_thr is 0.6) and of JAX's.  Measured, port (JAX) from the
    GT: SHOT + combination 0.017 rad / 0.040 (0.042 / 0.198), FPFH + the
    weighted metric + GROR 0.024 / 0.19 (0.0044 / 0.18); port from JAX at
    most 0.028 rad / 0.18.  The ISS keypoints differ (69 lr correspondences
    in the port against JAX's 45 on its capped neighbourhoods), and a
    rotation of 0.02 rad moves the far end of the scene by ~0.2.  With
    2,048 iterations JAX's SHOT pose was 0.054 rad / 0.36 from the GT."""
    (jr, tr), T_gt = (run[k]["res"] for k in ("jax", "port")), run["T_gt"]
    assert tr.converged and jr.converged
    assert tr.transformation.dtype == np.float32
    for ref in (T_gt, np.asarray(jr.transformation)):
        r, t = _err(tr.transformation, ref)
        assert r < 0.05 and t < 0.3, (run["name"], r, t)


def test_preloaded_correspondences_skip_the_search(run, inputs):
    """The port's own correspondences fed back: no search (time_cs 0, no
    fallback line), the same solver on the same set gives the same pose
    (GROR draws nothing; RANSAC from the same seed)."""
    tr = run["port"]["res"]
    kw = {**BASE, **SETS[run["name"]], **inputs["vps"]}
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        again = tpipe.align_point_clouds(*inputs["port"], ttypes.AlignmentParameters(**kw),
                                         save_artifacts=False, correspondences=tr.correspondences,
                                         device="cpu")
    assert "host pyramid" not in log.getvalue() and again.time_cs == 0.0
    np.testing.assert_allclose(again.transformation, tr.transformation, rtol=0, atol=1e-5)


CLI_CONFIG = ("source: scanA.ply\ntarget: scanB.ply\nground_truth: ground_truth.csv\n"
              "viewpoints: viewpoints.csv\ndescriptor: fpfh\nkeypoint: any\n"
              "matching: one_sided\nmetric: correspondences\nfeature_radius: 5.0\n"
              "alignment: [ransac, gror]\n")


def _cli_rows(main, d, **kw):
    """`alignment` of CLI_CONFIG through one package's CLI in directory d,
    on the pair of tests/test_torch_cli.py; (log, header line, result rows)."""
    d.mkdir()
    make_scan_pair(str(d))
    (d / "config.yaml").write_text(CLI_CONFIG)
    log = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(log):
        mp.chdir(d)
        main(["alignment", "config.yaml"], **kw)
    lines = (d / "data/debug/test_results.csv").read_text().strip().splitlines()
    return log.getvalue(), lines[0], [dict(zip(lines[0].split(","), ln.split(",")))
                                      for ln in lines[1:]]


def test_cli_runs_a_set_outside_the_envelope(tmp_path, monkeypatch):
    """`alignment` on the 16,000-point terrain pair of tests/test_torch_cli.py
    with one_sided matching (outside the staged envelope), RANSAC and GROR,
    through the port's CLI and the JAX package's on identical copies of the
    files: both of the port's rows converge within 3 degrees, RANSAC within
    one unit, GROR within one unit or JAX's own GROR t_err on these files
    where that is larger (JAX's misses one unit here: 1.207), under the JAX
    package's 38-column header, with the setting columns the JAX package
    writes for these parameters; `metric` then re-scores their caches."""
    log, header, rows = _cli_rows(tcli.main, tmp_path / "port", device="cpu")
    _jlog, _jheader, jrows = _cli_rows(jcli.main, tmp_path / "jax")
    tmp_path = tmp_path / "port"
    monkeypatch.chdir(tmp_path)
    assert log.count("host pyramid path used") == 2
    assert header == AlignmentAnalysis.HEADER.strip() and len(header.split(",")) == 38
    assert [r["alignment_type"] for r in rows] == ["ransac", "gror"]
    assert [r["alignment_type"] for r in jrows] == ["ransac", "gror"]
    bound = dict(ransac=1.0, gror=max(1.0, float(jrows[1]["t_err"])))
    for r in rows:
        assert r["converged"] == "1" and float(r["r_err"]) < np.deg2rad(3.0), r
        assert float(r["t_err"]) < bound[r["alignment_type"]] and float(r["time_cs"]) > 0, (
            r, jrows)
        want = dict(version="15", descriptor="fpfh", testname="scanA_scanB", nr_points="352",
                    edge_thr="0.95", matching_type="one_sided", randomness="1",
                    lrf_type="default", metric_type="correspondences", keypoint_type="any",
                    score_type="mse", normal_nr_points="30", reestimate="1", scale="2",
                    cluster_k="40", feature_radius="5")
        assert {k: r[k] for k in want} == want
    assert os.path.exists(tmp_path / "data/debug/transformations.csv")
    # `metric` reads the host rows' caches back: each cached transform's
    # correspondence inliers as the alignment counted them (RANSAC; within
    # 1 %: the cache prints the thresholds with %g)
    with contextlib.redirect_stdout(io.StringIO()):
        tcli.main(["metric", "config.yaml"], device="cpu")
    mlines = (tmp_path / "data/debug/test_metrics.csv").read_text().strip().splitlines()
    metrics = [dict(zip(mlines[0].split(","), ln.split(","))) for ln in mlines[1:]]
    assert len(metrics) == 2
    got, want = int(metrics[0]["inliers_corr"]), int(rows[0]["inliers"])
    assert abs(got - want) <= 0.01 * want, (got, want)
    assert all(int(m["inliers_icp"]) > 0 and int(m["inliers_icp_gt"]) > 0 for m in metrics)

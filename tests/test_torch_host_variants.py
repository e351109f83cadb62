"""The PyTorch port's host path end to end against the JAX package's on
the settings this slice ports: the RoPS and USC descriptors, ground-truth
frames (lrf gt) with USC and with FPFH (which reads no frames: FPFH + gt +
one_sided matching registered in JAX and raised in the port before), and
an initial guess (the local matcher, match_local).

The pair and kNN normals of tests/test_torch_host_e2e.py (the graded scene
at 4,096 points a side); each package runs align_point_clouds outside the
staged envelope at a fixed feature radius, RANSAC over the correspondence
metric.  RANSAC draws come from other generators and the JAX package's
host queries are capped (its ISS keeps 32 points a cell and 64 neighbours,
which moves keypoints in the scene's dense corner), so the runs are
compared by their poses.  Each JAX configuration
runs once, in a module-scoped fixture.
"""
import contextlib
import io

import numpy as np
import pytest

from lidar_global_registration_tpu import types as jtypes
from lidar_global_registration_tpu.models import pipeline as jpipe
from lidar_global_registration_tpu_torch import types as ttypes
from lidar_global_registration_tpu_torch.models import pipeline as tpipe
from test_torch_host_e2e import _err, inputs  # noqa: F401  (the module fixture)

BASE = dict(keypoint_id="iss", iss_radius_src=0.4, iss_radius_tgt=0.4, distance_thr=0.6,
            hypothesis_batch=128, max_iterations=4096, metric_id="correspondences",
            feature_radius=2.4)


def _turned_guess(T_gt: np.ndarray) -> np.ndarray:
    """The ground truth turned by 2 degrees about z and moved by
    distance_thr along x."""
    c, s = np.cos(np.deg2rad(2.0)), np.sin(np.deg2rad(2.0))
    D = np.eye(4, dtype=np.float32)
    D[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    D[0, 3] = BASE["distance_thr"]
    return (D @ T_gt).astype(np.float32)


SETS = {
    "rops": dict(descriptor_id="rops", lrf_id="default", matching_id="cluster"),
    "usc_gt": dict(descriptor_id="usc", lrf_id="gt", matching_id="cluster"),
    "fpfh_gt_one_sided": dict(descriptor_id="fpfh", lrf_id="gt", matching_id="one_sided"),
    "fpfh_guess": dict(descriptor_id="fpfh", matching_id="lr", match_search_radius=1.0),
}


@pytest.fixture(scope="module", params=list(SETS))
def run(request, inputs):
    kw = {**BASE, **SETS[request.param], **inputs["vps"]}
    T_gt = inputs["T_gt"]
    if request.param != "rops":
        kw["ground_truth"] = T_gt
    if request.param == "fpfh_guess":
        kw["guess"] = _turned_guess(T_gt)
    out = {}
    for name, mod, types, extra in (("jax", jpipe, jtypes, {}),
                                    ("port", tpipe, ttypes, {"device": "cpu"})):
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            res = mod.align_point_clouds(*inputs[name], types.AlignmentParameters(**kw),
                                         save_artifacts=False, **extra)
        out[name] = dict(res=res, log=log.getvalue())
    return dict(name=request.param, T_gt=T_gt, **out)


def test_host_path_is_taken(run):
    """Outside the staged envelope in both packages (the descriptor, the lrf
    with a non-SHOT descriptor does not leave it, one_sided or the guess
    does), with a search (time_cs > 0) and correspondences."""
    for name in ("jax", "port"):
        assert "host pyramid path used" in run[name]["log"], (name, run[name]["log"][-300:])
    res = run["port"]["res"]
    assert res.time_cs > 0 and int(res.correspondences.count()) >= 10


def test_pose_matches_jax_and_the_gt(run):
    """The port converges, its pose within 0.05 rad and 0.3 of the GT (the
    pair's distance_thr is 0.6) and of JAX's.  JAX converges too, except on
    FPFH + one_sided, where its pose is as near the GT (measured 0.014 rad
    / 0.13) but its refit keeps 7 inliers of 149 correspondences, under the
    20 the convergence gate asks (the port: 22 of 142, 0.019 rad / 0.11);
    one-sided FPFH matches on this pair are ~5-15 % right in both, and the
    gate there follows the draws."""
    (jr, tr), T_gt = (run[k]["res"] for k in ("jax", "port")), run["T_gt"]
    assert tr.converged, run["name"]
    assert jr.converged or run["name"] == "fpfh_gt_one_sided", run["name"]
    for ref in (T_gt, np.asarray(jr.transformation)):
        r, t = _err(tr.transformation, ref)
        assert r < 0.05 and t < 0.3, (run["name"], r, t)


def test_correspondence_counts_match_jax(run):
    """The same search in both: correspondence counts within 25 % of JAX's.
    The JAX package's host ISS keeps 32 points a cell and 64 neighbours,
    and its FPFH combine rounds to bfloat16, which move keypoints and
    near-tied matches (measured: RoPS, USC and one-sided within 5 %, the
    guess 79 against 70)."""
    nj = int(np.asarray(run["jax"]["res"].correspondences.valid).sum())
    nt = int(run["port"]["res"].correspondences.count())
    assert abs(nt - nj) <= 0.25 * nj + 3, (run["name"], nt, nj)

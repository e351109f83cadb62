"""The PyTorch port's classic masked route end to end against the JAX
package's register_pair_staged: ISS + the need-masked surface on the
working cloud, FPFH or SHOT at the keypoints, then matching, as the JAX
package runs it with `cluster_matching=False` (the CLI's `keypoint: iss,
matching: lr`) and where a data gate of the feature-scale route sends it.

The fixture of tests/test_torch_e2e_iss.py; the JAX side runs its Pallas
cells in interpret mode (LGR_CELL_FPFH=force), the port its plain versions.
"""
import pytest
import torch

from test_torch_e2e_iss import _errors, pair_share, run_pair

torch.set_num_threads(2)

# the density radii (0.1) under the scene's spacing make a voxel of 0.09,
# which passes the pre-gate (>= 0.9 x density) but keeps ~3,500 of 4,096
# rows: the shrink gate fails
SHRINK_RADII = (0.5, 0.1, 0.1, 0.35, 0.35, 1.0, 0.5)
NOTICE = "# feature-scale surface -> classic masked path: voxel surfaces"


@pytest.fixture(scope="module", params=["fpfh", "shot"])
def lr_runs(request):
    # mutual 1-NN over ~100 keypoints leaves few inliers; the inlier-count
    # score keeps the pose where the uniformity gate would reject both.  So
    # few inliers also keep RANSAC from stopping early: 16 rounds bound the
    # CPU time
    return run_pair(cluster_matching=False, descriptor=request.param,
                    metric="correspondences", rounds=16)


@pytest.fixture(scope="module")
def shrink_runs():
    return run_pair(SHRINK_RADII)


def test_lr_takes_the_classic_masked_route(lr_runs):
    assert "->" not in lr_runs["jlog"] and "->" not in lr_runs["tlog"]
    desc = "shot" if "shot_src" in lr_runs["times"] else "fpfh"
    want = (["side_src", "fpfh_src", "side_tgt", "fpfh_tgt"] if desc == "fpfh"
            else ["side_src", "side_tgt", "shot_src", "shot_tgt"])
    assert list(lr_runs["times"]) == want + ["match_corr", "ransac"]


def test_lr_matches_jax(lr_runs):
    jax_pairs, share = pair_share(lr_runs)
    # measured: the same mutual pairs in both packages (99 with FPFH, 84
    # with SHOT); from the two RANSAC draws 15 / 14 and 10 / 9 refit
    # inliers, poses within 0.005 rad; with SHOT neither converges (10
    # inliers of 84 is under the 0.15 rate gate)
    assert len(jax_pairs) > 50 and share >= 0.95, share
    jout, tout = lr_runs["jout"], lr_runs["tout"]
    assert bool(tout["converged"]) == bool(jout["converged"])
    assert abs(int(tout["inliers"]) - int(jout["inliers"])) <= 2
    for out in (jout, tout):
        r, t = _errors(out["transformation"], lr_runs["T_gt"])
        assert r < 0.05 and t < 0.3, (r, t)


def test_shrink_gate_sends_both_to_the_classic_masked_route(shrink_runs):
    assert NOTICE in shrink_runs["jlog"] and NOTICE in shrink_runs["tlog"]
    # the feature-scale route's stages, then the classic route's (its side
    # stages summed under the same labels)
    assert list(shrink_runs["times"]) == ["fs_maps", "plan", "side_src", "side_tgt",
                                          "fpfh_src", "fpfh_tgt", "match_corr", "ransac"]
    for out in (shrink_runs["jout"], shrink_runs["tout"]):
        r, t = _errors(out["transformation"], shrink_runs["T_gt"])
        assert bool(out["converged"]) and r < 0.05 and t < 0.3, (r, t)
    jax_pairs, share = pair_share(shrink_runs)
    # measured: 189 of JAX's 192 cluster pairs, 40 and 41 refit inliers
    assert len(jax_pairs) > 100 and share >= 0.9, share

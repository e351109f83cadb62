"""The PyTorch port's unmasked ISS route (`masked_features=False`) and its
keypoint-any SHOT route (`use_iss=False, descriptor="shot"`) end to end
against the JAX package's register_pair_staged, and the unmasked route
against the port's own classic masked route.

The fixture of tests/test_torch_e2e_iss.py; the JAX side runs its Pallas
cells in interpret mode (LGR_CELL_FPFH=force), the port its plain versions.
Each JAX configuration runs once, in a module-scoped fixture.
"""
import numpy as np
import pytest
import torch

from lidar_global_registration_tpu_torch.ops import cellgrid as cg
from test_torch_e2e_iss import RADII, _errors, pair_inputs, pair_share, port_pair, run_pair

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def unmasked():
    return run_pair(masked_features=False)


@pytest.fixture(scope="module")
def classic():
    """The port's classic masked route on the same pair."""
    return port_pair(feature_scale=False)


def _pairs(out):
    rows, match, _thr, ok = out["correspondences"]
    return set(zip(rows[ok].tolist(), match[ok].tolist()))


def test_unmasked_takes_its_own_route(unmasked):
    """No fallback notice in either package, and the stages of the unmasked
    route: per side the side stage, then FPFH over every row; no
    feature-scale maps (that route needs the masked features)."""
    assert "->" not in unmasked["jlog"] and "->" not in unmasked["tlog"]
    assert list(unmasked["times"]) == ["side_src", "fpfh_src", "side_tgt", "fpfh_tgt",
                                       "match_corr", "ransac"]


def test_unmasked_matches_jax(unmasked):
    jax_pairs, share = pair_share(unmasked)
    # measured: all 183 of the JAX package's cluster pairs and no other (the
    # rate tests/test_torch_e2e_iss.py holds the masked route to), 75 refit
    # inliers in both, poses 0.02 / 0.012 rad from the truth (two draws)
    assert len(jax_pairs) > 100 and share >= 0.95, share
    for out in (unmasked["jout"], unmasked["tout"]):
        r, t = _errors(out["transformation"], unmasked["T_gt"])
        assert bool(out["converged"]) and r < 0.05 and t < 0.3, (r, t)
    assert abs(int(unmasked["tout"]["inliers"]) - int(unmasked["jout"]["inliers"])) <= 3
    r, _t = _errors(unmasked["tout"]["transformation"],
                    np.asarray(unmasked["jout"]["transformation"]))
    assert r < 0.02, r  # the two RANSAC draws on the same correspondences


def test_unmasked_equals_the_classic_masked_route(unmasked, classic):
    """"Identical values at every consumed row": the two routes of the port
    leave the same correspondences, thresholds included, and with the same
    seed the same pose."""
    cout, times = classic
    assert "fs_maps" not in times
    tout = unmasked["tout"]
    assert _pairs(tout) == _pairs(cout) and len(_pairs(cout)) > 100
    for a, b in zip(tout["correspondences"], cout["correspondences"]):
        assert torch.equal(a, b)
    assert int(tout["inliers"]) == int(cout["inliers"])
    torch.testing.assert_close(tout["transformation"], cout["transformation"], atol=1e-6, rtol=0)


def test_unmasked_side_values_equal_the_masked_ones():
    """On the pair's source cloud: the unmasked side stage and FPFH over
    every row against the classic route's masked stage and its FPFH at the
    compacted keypoints.  Keypoints equal; FPFH at keypoint rows within 1e-4
    (histograms that sum to 100 a block; the plain versions chunk their
    queries differently, the sums are the same: measured equal)."""
    from lidar_global_registration_tpu_torch.models.flagship import _compact_rows, _pad_quantum

    a, _b, vp_a, _vp_b = pair_inputs()
    xyz, valid = torch.from_numpy(a), torch.ones(len(a), dtype=torch.bool)
    normal_cell, iss_r, feature_r = RADII[0], RADII[3], RADII[5]
    pn = cg.plan_grid(xyz, valid, max(normal_cell, iss_r))
    pf = cg.plan_grid(xyz, valid, feature_r)
    out = cg.surface_iss_cells(pn, normal_cell, iss_r, torch.from_numpy(vp_a))
    mn, mkp, _md, _msal = cg.surface_iss_masked(pn, pf, normal_cell, iss_r,
                                                torch.from_numpy(vp_a))
    assert torch.equal(out["kp"], mkp) and int(mkp.sum()) > 50
    feat, fv = cg.fpfh_pass(cg.set_normals(pf, out["normal"]), feature_r)
    n = int(mkp.sum())
    sj = _compact_rows(mkp, n, _pad_quantum(n))
    featc, fvc = cg.fpfh_pass(cg.set_normals(pf, mn), feature_r, kp=mkp, kp_rows=sj)
    rows = sj[:n]
    assert torch.equal(fv[rows], fvc[:n]) and bool(fvc[:n].all()) and not bool(fvc[n:].any())
    torch.testing.assert_close(feat[rows], featc[:n], atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# keypoint-any SHOT (the staged envelope's `keypoint: any, descriptor: shot,
# matching: lr`, pipeline.py:154-163)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def any_shot():
    # 2,048 points a side: SHOT over every row stays under half a minute
    return run_pair(n=2048, use_iss=False, descriptor="shot", metric="correspondences",
                    rounds=8)


def test_any_shot_stages(any_shot):
    assert "->" not in any_shot["jlog"] and "->" not in any_shot["tlog"]
    assert list(any_shot["times"]) == ["plan", "side_src", "side_tgt", "shot_src", "shot_tgt",
                                       "match_st", "match_ts", "corr", "ransac"]


def test_any_shot_matches_jax(any_shot):
    jax_pairs, share = pair_share(any_shot)
    # measured: the same 572 mutual pairs in both packages; 91 / 97 refit
    # inliers and poses 0.015 / 0.016 rad from the truth from the two draws
    assert len(jax_pairs) > 300 and share >= 0.95, share
    for out in (any_shot["jout"], any_shot["tout"]):
        r, t = _errors(out["transformation"], any_shot["T_gt"])
        assert bool(out["converged"]) and r < 0.05 and t < 0.3, (r, t)

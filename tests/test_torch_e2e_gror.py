"""The PyTorch port's GROR solver stage (`alignment="gror"`) on the ISS FPFH
route end to end against the JAX package's register_pair_staged, and
gror_solve of both packages on one correspondence set exported from the port.

The fixture of tests/test_torch_e2e_iss.py; the JAX side runs its Pallas
cells in interpret mode (LGR_CELL_FPFH=force), the port its plain versions.
GROR draws nothing, so the two results differ only by what the two fronts'
correspondence sets differ by.  The same on the keypoint-any route.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_global_registration_tpu.models.gror import gror_solve as jax_gror_solve
from lidar_global_registration_tpu_torch.models import flagship as tfl
from lidar_global_registration_tpu_torch.models.gror import gror_solve
from test_torch_e2e_iss import RADII, _errors, pair_inputs, pair_share, run_pair

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs():
    return run_pair(alignment="gror")


def test_gror_stage_replaces_ransac(runs):
    assert "->" not in runs["jlog"] and "->" not in runs["tlog"]
    assert list(runs["times"]) == ["fs_maps", "plan", "side_src", "side_tgt", "fpfh_src",
                                   "fpfh_tgt", "match_corr", "gror"]
    assert sorted(k for k in runs["tout"] if k != "correspondences") == sorted(
        ["transformation", "metric", "inliers", "converged", "n_correspondences", "iterations"])


def test_gror_e2e_matches_jax(runs):
    jax_pairs, share = pair_share(runs)
    assert len(jax_pairs) > 100 and share >= 0.95, share  # the masked e2e test's rate
    jout, tout = runs["jout"], runs["tout"]
    assert bool(tout["converged"]) and bool(jout["converged"])
    # measured: the same 178 correspondences, 116 inliers and 1 round in both
    # packages.  Each correspondence the sets differ by can move the count by
    # one
    differ = round((1.0 - share) * len(jax_pairs)) + abs(
        int(tout["n_correspondences"]) - int(jout["n_correspondences"]))
    assert abs(int(tout["inliers"]) - int(jout["inliers"])) <= differ
    # GROR is the reference's initial alignment: its own success criterion is
    # a pose within distance_thr (main.cpp:356)
    thr = RADII[6]
    for out in (jout, tout):
        r, t = _errors(out["transformation"], runs["T_gt"])
        assert r < 0.05 and t < thr, (r, t)
    Tj, Tt = np.asarray(jout["transformation"]), tout["transformation"].numpy()
    assert np.abs(Tj[:3, 3] - Tt[:3, 3]).max() < thr
    if differ == 0:  # the same set: the tight bound of the test below
        np.testing.assert_allclose(Tt, Tj, atol=1e-4)


def test_gror_solve_on_the_exported_set_matches_jax(runs):
    """Both packages' gror_solve on THE SAME correspondence set, exported
    from the port (return_correspondences): equal counts, rounds and gate;
    transformation atol 1e-4 (the Umeyama refit's 4 x 4 eigh, XLA and
    PyTorch up to 5e-5 apart)."""
    a, b, _vp_a, _vp_b = pair_inputs()
    rows, match, _thr, ok = runs["tout"]["correspondences"]
    p, q = a[rows.numpy()], b[match.numpy()]
    res = RADII[6]
    want = jax_gror_solve(jnp.asarray(p), jnp.asarray(q), jnp.asarray(ok.numpy()), res)
    got = gror_solve(torch.from_numpy(p), torch.from_numpy(q), ok, res)
    for k in ("inliers", "iterations", "converged", "n_correspondences"):
        assert got[k] == want[k], (k, got[k], want[k])
    np.testing.assert_allclose(got["transformation"].numpy(),
                               np.asarray(want["transformation"]), atol=1e-4)
    # and it is what the staged run returned
    assert got["inliers"] == int(runs["tout"]["inliers"])
    torch.testing.assert_close(got["transformation"], runs["tout"]["transformation"])


def test_gror_stage_compacts_to_the_full_count():
    """_gror_stage hands gror_solve every realised correspondence, padded to
    a count quantum, never ransac_compact rows; the subset keeps the valid
    rows first in row order."""
    rng = np.random.default_rng(5)
    n, k = 9000, 5000
    p = torch.from_numpy(rng.uniform(0, 30, (n, 3)).astype(np.float32))
    ang = 0.4
    R = torch.tensor([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                     dtype=torch.float32)
    q = p @ R.T + torch.tensor([2.0, -1.0, 0.5])
    valid = torch.zeros(n, dtype=torch.bool)
    valid[torch.from_numpy(rng.permutation(n)[:k])] = True
    q[~valid] = 0.0
    cfg = tfl.FlagshipConfig(alignment="gror", ransac_compact=4096)
    M = tfl._pad_quantum(k)
    assert cfg.ransac_compact < k < M < n
    ps, qs, vs = tfl._corr_subset(p, q, valid, M)
    assert ps.shape == (M, 3) and int(vs.sum()) == k and bool(vs[:k].all())
    assert torch.equal(ps[:k], p[valid])
    out = tfl._gror_stage(p, q, valid, 0.3, cfg)
    assert out["n_correspondences"] == k and out["inliers"] == k and out["converged"]
    np.testing.assert_allclose(out["transformation"][:3, :3].numpy(), R.numpy(), atol=1e-4)


def test_gror_on_the_keypoint_any_route():
    """alignment="gror" behind the keypoint-any route against the JAX package,
    2,048 points a side: mutual correspondences shared at the any-route e2e
    rate, the same gate, inlier counts within what the differing
    correspondences explain, both poses within distance_thr of the truth and
    of each other."""
    runs = run_pair(n=2048, use_iss=False, metric="correspondences", rounds=8,
                    alignment="gror")
    assert list(runs["times"])[-1] == "gror" and "ransac" not in runs["times"]
    jax_pairs, share = pair_share(runs)
    # measured: 506 mutual correspondences in both packages, 98.6 % shared; 319
    # and 320 inliers in 1 round
    assert len(jax_pairs) > 300 and share >= 0.95, share
    jout, tout = runs["jout"], runs["tout"]
    assert bool(tout["converged"]) and bool(jout["converged"])
    differ = round((1.0 - share) * len(jax_pairs)) + abs(
        int(tout["n_correspondences"]) - int(jout["n_correspondences"]))
    assert abs(int(tout["inliers"]) - int(jout["inliers"])) <= differ
    thr = RADII[6]
    for out in (jout, tout):
        r, t = _errors(out["transformation"], runs["T_gt"])
        assert r < 0.05 and t < thr, (r, t)
    Tj, Tt = np.asarray(jout["transformation"]), tout["transformation"].numpy()
    assert np.abs(Tj[:3, 3] - Tt[:3, 3]).max() < thr

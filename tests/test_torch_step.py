"""The PyTorch port's one-graph entry points against the JAX package's:
_side_stage (kNN normals within the normal cell, the k = 2 density from
them, ISS keypoints), register_pair_step, register_pair_two_stage and the
grid-hash route of register_pair_staged (use_cell_fpfh=False), which the
JAX package takes off the TPU.

Two pairs at 2,048 points a side: the ISS fixture of
tests/test_torch_e2e_iss.py (its radii) and the bench's keypoint-any pair
(bench.py's scene and derived radii).  The JAX side runs
plain XLA here.  Its capped queries (neighbor_cap 32 a cell, 48 ISS
neighbours, 128 FPFH neighbours within feature_cap 96 a cell) differ from
the port's exact ones where a cap binds, and the RANSAC draws come from
other generators, so the registrations are compared by their poses; the
side stage, whose normals and densities sit under the caps, row by row.
Each JAX configuration runs once, in a module-scoped fixture.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_pair
from bench import _derive_radii
from lidar_global_registration_tpu.models import flagship as jfl
from lidar_global_registration_tpu_torch.models import flagship as tfl
from lidar_global_registration_tpu_torch.types import SEED
from test_torch_analysis import max_bucket
from test_torch_e2e_iss import RADII, SETTINGS, _errors, pair_inputs

torch.set_num_threads(2)

N = 2048
ANY = dict(rounds=8, hypothesis_batch=1024, use_iss=False, match_tile=4096,
           metric="correspondences")  # bench.py:238-256 in keypoint-any mode


def _any_inputs(n: int = N):
    """The bench's keypoint-any pair (bench.py:182-190, 225-233) at n points
    a side, bench.py's derived radii."""
    a, b = _synthetic_pair(n)
    ang = 0.4
    Rb = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                  np.float32)
    tb = np.array([2.0, -1.0, 0.5], np.float32)
    vp_a = np.array([15.0, 15.0, 120.0], np.float32)
    vp_b = Rb.T @ (vp_a - tb)
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3] = Rb.T
    T_gt[:3, 3] = -Rb.T @ tb
    jr = _derive_radii(a, b, n)
    radii = tuple(jr[k] for k in ("normal_cell", "density_src", "density_tgt", "iss_src",
                                  "iss_tgt", "feature", "thr"))
    return a, b, vp_a, vp_b, T_gt, radii


def _iss_inputs():
    a, b, vp_a, vp_b = pair_inputs(N)
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3] = [[np.cos(0.3), -np.sin(0.3), 0], [np.sin(0.3), np.cos(0.3), 0], [0, 0, 1]]
    T_gt[:3, 3] = [1.5, -0.8, 0.2]
    return a, b, vp_a, vp_b, T_gt, RADII


def _run(entry: str, inputs, cfg: dict):
    """One entry point of both packages on one pair: (jax dict, port dict, T_gt)."""
    a, b, vp_a, vp_b, T_gt, radii = inputs
    ones = np.ones(N, bool)
    jcfg = jfl.FlagshipConfig(**cfg)
    tcfg = tfl.config_from_jax(jcfg.__dict__)
    extra = {"return_correspondences": True} if entry == "register_pair_staged" else {}
    jout = getattr(jfl, entry)(jnp.asarray(a), jnp.asarray(ones), jnp.asarray(b),
                               jnp.asarray(ones), jax.random.PRNGKey(SEED), *radii,
                               vp_src=jnp.asarray(vp_a), vp_tgt=jnp.asarray(vp_b), cfg=jcfg,
                               **extra)
    tones = torch.ones(N, dtype=torch.bool)
    tout = getattr(tfl, entry)(torch.from_numpy(a), tones, torch.from_numpy(b), tones,
                               torch.Generator().manual_seed(SEED), *radii,
                               vp_src=torch.from_numpy(vp_a), vp_tgt=torch.from_numpy(vp_b),
                               cfg=tcfg, **extra)
    return jout, tout, T_gt


@pytest.fixture(scope="module")
def side():
    a, _b, vp_a, _vp_b = pair_inputs(N)
    normal_cell, iss_r = RADII[0], RADII[3]
    jcfg = jfl.FlagshipConfig(**SETTINGS)
    jn, jk, jd = (np.asarray(v) for v in jfl._side_stage(
        jnp.asarray(a), jnp.ones(N, bool), normal_cell, iss_r, jcfg, jnp.asarray(vp_a)))
    tn, tk, td = (v.numpy() for v in tfl._side_stage(
        torch.from_numpy(a), torch.ones(N, dtype=torch.bool), normal_cell, iss_r,
        tfl.config_from_jax(jcfg.__dict__), torch.from_numpy(vp_a)))
    return dict(a=a, jax=(jn, jk, jd), port=(tn, tk, td))


def test_side_stage_normals_and_density_match_jax(side):
    """Under the JAX package's caps (at most 32 points a normal cell) the
    16 nearest points within the normal cell are the same: the density is
    the same float32 distance in every row, and the normals agree (oriented
    to the same viewpoint) within 1e-5 of a unit dot (measured: 1e-6 in
    every row but one isolated point with 2 neighbours in the cell, whose
    normal is 0 in both); densities within 1.2e-7 relatively (measured)."""
    a = side["a"]
    assert max_bucket(a, RADII[0]) <= 32
    (jn, _jk, jd), (tn, _tk, td) = side["jax"], side["port"]
    np.testing.assert_allclose(td, jd, rtol=1e-6, atol=0)
    assert (td > 0).all()
    zero = (jn == 0).all(1)
    np.testing.assert_array_equal(zero, (tn == 0).all(1))
    assert zero.sum() <= 2
    dot = (jn * tn).sum(1)[~zero]
    assert (dot > 1 - 1e-5).all(), np.sort(dot)[:5]


def test_side_stage_keypoints_match_jax(side):
    """The ISS keypoints: the port's are exact (K2-K4's plain versions, every
    neighbour within r), JAX's take 48 neighbours within 32 points a cell;
    no cell or neighbourhood of this pair reaches those caps, so the sets
    are equal (measured: 179 keypoints each)."""
    jk, tk = side["jax"][1], side["port"][1]
    assert max_bucket(side["a"], RADII[3]) <= 32
    assert tk.sum() > 50
    np.testing.assert_array_equal(tk, jk)


@pytest.fixture(scope="module")
def step_iss():
    return _run("register_pair_step", _iss_inputs(), SETTINGS)


@pytest.fixture(scope="module")
def step_any():
    return _run("register_pair_step", _any_inputs(), ANY)


@pytest.fixture(scope="module")
def two_stage_any():
    return _run("register_pair_two_stage", _any_inputs(), ANY)


@pytest.fixture(scope="module")
def grid_hash_iss():
    return _run("register_pair_staged", _iss_inputs(), {**SETTINGS, "use_cell_fpfh": False})


def _holds(run, r_max=0.05, t_max=0.3):
    jout, tout, T_gt = run
    for out in (jout, tout):
        r, t = _errors(np.asarray(out["transformation"]), T_gt)
        assert bool(out["converged"]) and r < r_max and t < t_max, (r, t)
    return _errors(np.asarray(tout["transformation"]), np.asarray(jout["transformation"]))


def test_step_iss_matches_jax(step_iss):
    """ISS + FPFH + the cluster filter over full rows + uniformity RANSAC:
    both converge near the truth (measured: port 0.030 rad / 0.22, JAX
    0.005 / 0.068; the same 46 refit inliers of 173 against 175
    correspondences); the port's keys are JAX's."""
    r, _t = _holds(step_iss)
    assert r < 0.05, r
    jout, tout, _T = step_iss
    assert set(tout) == set(jout)
    n_j, n_t = int(jout["n_correspondences"]), int(tout["n_correspondences"])
    assert abs(n_j - n_t) <= 0.1 * n_j, (n_j, n_t)


def test_step_any_matches_jax(step_any):
    """Keypoint-any FPFH + mutual 1-NN: both converge near the truth and
    near each other."""
    r, t = _holds(step_any)
    assert r < 0.05 and t < 0.3, (r, t)


def test_two_stage_any_matches_jax(two_stage_any):
    """The step with FPFH and the mutual filter (JAX: _front_stage, then
    RANSAC): both converge near the truth and near each other."""
    r, t = _holds(two_stage_any)
    assert r < 0.05 and t < 0.3, (r, t)


def test_grid_hash_route_matches_jax_and_the_step(grid_hash_iss, step_iss):
    """use_cell_fpfh=False: the side stage and the full FPFH of the step,
    then the staged matching region (compacted cluster matching).  Both
    packages converge; in each package it is the step's pipeline, so with
    the same seed the port's pose and inliers equal its step's (measured in
    JAX too: 46 inliers each)."""
    r, _t = _holds(grid_hash_iss)
    assert r < 0.05, r
    _j, tout, _T = grid_hash_iss
    _js, sout, _Ts = step_iss
    assert int(tout["inliers"]) == int(sout["inliers"])
    torch.testing.assert_close(tout["transformation"], sout["transformation"], atol=1e-5, rtol=0)
    rows, _m, _thr, ok = tout["correspondences"]
    assert int(ok.sum()) == int(tout["n_correspondences"])

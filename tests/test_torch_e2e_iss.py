"""The PyTorch port's ISS route end to end against the JAX package's
register_pair_staged(use_iss=True) with its Pallas cell kernels in
interpret mode (LGR_CELL_FPFH=force): ISS keypoints, the feature-scale
surface with masked FPFH, cluster matching and uniformity RANSAC.

The dense scene of tests/test_feature_scale.py at 4,096 points per side,
with scanner-like noise (as tests/test_cell_iss.py: on exactly planar
patches the smallest eigenvalue's sign and the normal's orientation are
float32 coin flips in either package) and a viewpoint above the scene.
The radii are chosen so the feature-scale gates pass at this size
(feature radius 1.6: voxel_f = sqrt(pi 1.6^2 / 352) = 0.151 >= 0.9 x the
density 0.15, and the surfaces keep ~2,800 of 4,096 rows).  On the CPU
the port runs the plain PyTorch versions of its CUDA kernels.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _scene_tables
from lidar_global_registration_tpu.models import flagship as jfl
from lidar_global_registration_tpu_torch.models import flagship as tfl
from lidar_global_registration_tpu_torch.ops.transform import rotation_translation_error
from lidar_global_registration_tpu_torch.scene import scene_pair
from lidar_global_registration_tpu_torch.types import SEED
from test_feature_scale import _scene

torch.set_num_threads(2)

N = 4096
ANG = 0.3
OFF = np.array([1.5, -0.8, 0.2], np.float32)
# normal_cell, density_src, density_tgt, iss_src, iss_tgt, feature, thr
RADII = (0.5, 0.15, 0.15, 0.35, 0.35, 1.6, 0.5)


def _rot():
    return np.array([[np.cos(ANG), -np.sin(ANG), 0], [np.sin(ANG), np.cos(ANG), 0], [0, 0, 1]],
                    np.float32)


SETTINGS = dict(rounds=64, hypothesis_batch=1024, use_iss=True, match_tile=4096,
                metric="uniformity")  # bench.py:238-256 in ISS mode


def pair_inputs(n=N):
    """The fixture pair (a, b, vp_a, vp_b) at n points per side."""
    rng = np.random.default_rng(7)
    a = (_scene(n, 3) + rng.normal(scale=0.004, size=(n, 3))).astype(np.float32)
    b = ((_scene(n, 4) + rng.normal(scale=0.004, size=(n, 3))) @ _rot().T
         + OFF).astype(np.float32)
    vp_a = np.array([5.0, 5.0, 30.0], np.float32)
    vp_b = (_rot() @ vp_a + OFF).astype(np.float32)
    return a, b, vp_a, vp_b


def port_pair(radii=RADII, n=N, **cfg):
    """The fixture pair through the port alone; (result, stage times)."""
    a, b, vp_a, vp_b = pair_inputs(n)
    tones = torch.ones(n, dtype=torch.bool)
    times = {}
    out = tfl.register_pair_staged(
        torch.from_numpy(a), tones, torch.from_numpy(b), tones,
        torch.Generator().manual_seed(SEED), *radii, vp_src=torch.from_numpy(vp_a),
        vp_tgt=torch.from_numpy(vp_b), cfg=tfl.FlagshipConfig(**{**SETTINGS, **cfg}),
        return_correspondences=True, stage_times=times)
    return out, times


def run_pair(radii=RADII, n=N, **cfg):
    """The fixture pair through both packages with bench.py's ISS settings
    (bench.py:238-256) changed by `cfg`; the JAX side with its Pallas cells
    in interpret mode.  Returns both results, both packages' printed
    notices, the port's stage times and the ground truth."""
    a, b, vp_a, vp_b = pair_inputs(n)
    ones = np.ones(n, bool)
    jcfg = jfl.FlagshipConfig(**{**SETTINGS, **cfg})
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setenv("LGR_CELL_FPFH", "force")
        jout = jfl.register_pair_staged(
            jnp.asarray(a), jnp.asarray(ones), jnp.asarray(b), jnp.asarray(ones),
            jax.random.PRNGKey(SEED), *radii, vp_src=jnp.asarray(vp_a),
            vp_tgt=jnp.asarray(vp_b), cfg=jcfg, return_correspondences=True)
    tones = torch.ones(n, dtype=torch.bool)
    times = {}
    tlog = io.StringIO()
    with contextlib.redirect_stdout(tlog):
        tout = tfl.register_pair_staged(
            torch.from_numpy(a), tones, torch.from_numpy(b), tones,
            torch.Generator().manual_seed(SEED), *radii, vp_src=torch.from_numpy(vp_a),
            vp_tgt=torch.from_numpy(vp_b), cfg=tfl.config_from_jax(jcfg.__dict__),
            return_correspondences=True, stage_times=times)
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3] = _rot()
    T_gt[:3, 3] = OFF
    return dict(jout=jout, tout=tout, jlog=out.getvalue(), tlog=tlog.getvalue(), times=times,
                T_gt=T_gt)


@pytest.fixture(scope="module")
def runs():
    return run_pair()


def pair_share(runs):
    """(JAX's cluster correspondences, the share of them the port has)."""
    rows, match, _thr, ok = (np.asarray(v) for v in runs["jout"]["correspondences"])
    jax_pairs = set(zip(rows[ok].tolist(), match[ok].tolist()))
    trows, tmatch, _tthr, tok = runs["tout"]["correspondences"]
    port_pairs = set(zip(trows[tok].tolist(), tmatch[tok].tolist()))
    return jax_pairs, len(jax_pairs & port_pairs) / max(len(jax_pairs), 1)


def _errors(T, T_gt):
    r, t = rotation_translation_error(torch.as_tensor(np.array(T)), torch.from_numpy(T_gt))
    return float(r), float(t)


def test_both_take_the_feature_scale_route(runs):
    assert "->" not in runs["jlog"], runs["jlog"]  # no JAX fallback fired
    assert list(runs["times"]) == ["fs_maps", "plan", "side_src", "side_tgt", "fpfh_src",
                                   "fpfh_tgt", "match_corr", "ransac"]


def test_both_converge(runs):
    for out in (runs["jout"], runs["tout"]):
        r, t = _errors(out["transformation"], runs["T_gt"])
        assert bool(out["converged"]) and r < 0.05 and t < 0.3, (r, t)
    assert float(runs["tout"]["metric"]) > 0.3  # the uniformity gate


def test_rotations_agree(runs):
    r, _t = _errors(runs["tout"]["transformation"],
                    np.asarray(runs["jout"]["transformation"]))
    # measured 0.0 rad (float32 acos of a trace within rounding of 3): the
    # same 79 refit inliers of the same 178 correspondences, poses apart by
    # 0.011 m of translation from the two RANSAC draws and Kabsch rounding
    assert r < 0.01


def test_cluster_correspondences_agree(runs):
    jax_pairs, share = pair_share(runs)
    # measured: all 178 of the JAX package's pairs, and no other.  A
    # descriptor whose bin-edge pair flips (atan2f against the TPU
    # polynomial) could flip a near-tied 1-NN and move the consensus gate
    # with it, hence the margin
    assert len(jax_pairs) > 100
    assert share >= 0.95, share


def test_scene_sampler_matches_the_host_scene():
    """The device sampler's pair: shapes, the ground plane's share of the
    points (its area share of the patch tables), and b mapped back onto a's
    frame by the ground truth."""
    tables = _scene_tables(SEED, extent=30.0)
    a, b, vp_a, vp_b, T_gt = scene_pair(tables, 20000, 30.0, SEED, torch.device("cpu"))
    assert a.shape == b.shape == (20000, 3) and a.dtype == torch.float32
    areas = tables[5]
    ground = float((a[:, 2].abs() < 0.04).float().mean())
    assert abs(ground - areas[0] / areas.sum()) < 0.03
    R, t = T_gt[:3, :3], T_gt[:3, 3]
    b_in_a = (b - t) @ R  # a = R^T (b - t)
    assert float(b_in_a[:, :2].min()) > -0.1 and float(b_in_a[:, :2].max()) < 30.1
    torch.testing.assert_close(vp_b, R @ vp_a + t)

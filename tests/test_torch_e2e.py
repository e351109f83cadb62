"""The PyTorch port's keypoint-any registration path end to end against the
JAX package's register_pair_staged with its Pallas cell kernels in interpret
mode (LGR_CELL_FPFH=force), on the bench's synthetic pair at 4,096 points.

On the CPU the port runs the plain PyTorch versions of its CUDA kernels.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_pair
from bench import R_ERR_MAX, _derive_radii
from lidar_global_registration_tpu.models import flagship as jfl
from lidar_global_registration_tpu.ops.transform import rotation_translation_error as jax_rte
from lidar_global_registration_tpu_torch.models import flagship as tfl
from lidar_global_registration_tpu_torch.ops.density import derive_radii
from lidar_global_registration_tpu_torch.ops.transform import rotation_translation_error
from lidar_global_registration_tpu_torch.types import SEED

torch.set_num_threads(2)

N = 4096
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scene():
    """bench.py:182-190 and 225-233: the pair, viewpoints and ground truth."""
    a, b = _synthetic_pair(N)
    ang = 0.4
    Rb = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                  np.float32)
    tb = np.array([2.0, -1.0, 0.5], np.float32)
    vp_a = np.array([15.0, 15.0, 120.0], np.float32)
    vp_b = Rb.T @ (vp_a - tb)
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3] = Rb.T
    T_gt[:3, 3] = -Rb.T @ tb
    return a, b, vp_a, vp_b, T_gt


@pytest.fixture(scope="module")
def runs():
    a, b, vp_a, vp_b, T_gt = _scene()
    jr = _derive_radii(a, b, N)
    tr = derive_radii(torch.from_numpy(a), torch.from_numpy(b))
    floats = [jr[k] for k in ("normal_cell", "density_src", "density_tgt", "iss_src",
                              "iss_tgt", "feature", "thr")]
    jcfg = jfl.FlagshipConfig(rounds=8, hypothesis_batch=1024, use_iss=False, match_tile=4096,
                              metric="correspondences")
    ones = np.ones(N, bool)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LGR_CELL_FPFH", "force")
        jout = jfl.register_pair_staged(
            jnp.asarray(a), jnp.asarray(ones), jnp.asarray(b), jnp.asarray(ones),
            jax.random.PRNGKey(SEED), *floats, vp_src=jnp.asarray(vp_a),
            vp_tgt=jnp.asarray(vp_b), cfg=jcfg, return_correspondences=True)
    tones = torch.ones(N, dtype=torch.bool)
    tout = tfl.register_pair_staged(
        torch.from_numpy(a), tones, torch.from_numpy(b), tones,
        torch.Generator().manual_seed(SEED), *floats, vp_src=torch.from_numpy(vp_a),
        vp_tgt=torch.from_numpy(vp_b), cfg=tfl.FlagshipConfig(
            rounds=8, hypothesis_batch=1024, use_iss=False, match_tile=4096,
            metric="correspondences"),
        return_correspondences=True)
    return dict(jr=jr, tr=tr, jout=jout, tout=tout, T_gt=T_gt)


def test_derived_radii_equal(runs):
    assert runs["tr"] == runs["jr"]


def test_jax_meets_the_bench_rule(runs):
    out = runs["jout"]
    r, t = (float(v) for v in jax_rte(out["transformation"], jnp.asarray(runs["T_gt"])))
    assert bool(out["converged"]) and r < R_ERR_MAX and t < runs["jr"]["thr"]


def test_port_meets_the_bench_rule(runs):
    out = runs["tout"]
    r, t = (float(v) for v in rotation_translation_error(
        out["transformation"], torch.from_numpy(runs["T_gt"])))
    assert bool(out["converged"]) and r < R_ERR_MAX and t < runs["tr"]["thr"]
    assert int(out["inliers"]) > 100


def test_rotations_agree(runs):
    r, _t = rotation_translation_error(
        runs["tout"]["transformation"],
        torch.from_numpy(np.array(runs["jout"]["transformation"])))
    assert float(r) < 0.01


def test_mutual_correspondences_agree(runs):
    rows, match, _thr, ok = (np.asarray(v) for v in runs["jout"]["correspondences"])
    jax_pairs = set(zip(rows[ok].tolist(), match[ok].tolist()))
    trows, tmatch, _tthr, tok = runs["tout"]["correspondences"]
    port_pairs = set(zip(trows[tok].tolist(), tmatch[tok].tolist()))
    share = len(jax_pairs & port_pairs) / len(jax_pairs)
    # measured: 0.9987 (1,495 of the JAX package's 1,497 mutual pairs; the
    # port has 1,496): descriptors that differ only in a bin-edge pair
    # flip a near-tied 1-NN
    assert len(jax_pairs) > 500
    assert share >= 0.9, share


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import lidar_global_registration_tpu_torch.models.flagship; "
            "import lidar_global_registration_tpu_torch.models.pyramid; "
            "import lidar_global_registration_tpu_torch.ops.density; "
            "import lidar_global_registration_tpu_torch.ops.downsample; "
            "import lidar_global_registration_tpu_torch.scene; "
            "import lidar_global_registration_tpu_torch.kernels; "
            "assert not any(m == 'lidar_global_registration_tpu' "
            "or m.startswith('lidar_global_registration_tpu.') for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_chip_smoke_refuses_without_a_card():
    """chip_smoke.py exits non-zero and prints no result line without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

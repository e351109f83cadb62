"""The PyTorch port's staged multi-scale pyramid end to end against the JAX
package's register_pair_staged(pyramid=True) with its Pallas cell kernels
in interpret mode (LGR_CELL_FPFH=force) and its debug record
(LGR_PYRAMID_DEBUG=1, flagship.PYRAMID_DEBUG), with FPFH and with SHOT.

The range-graded scene of tests/test_staged_pyramid.py at 4,096 points a
side (density falls ~64x across it, so the keypoints' feature radii span
three to four buckets), with scanner-like noise (on exactly planar patches
the ISS eigenvalue gates are float32 coin flips in either package) and a
viewpoint above the scene.  On the CPU the port runs the plain PyTorch
versions of its CUDA kernels.

The two packages' level surfaces and descriptors are the same functions of
the same inputs; what differs is the bucket query (the JAX package's cell
list drops points of cells over 64 in cloud order, the port's is exact),
so a keypoint in the scene's dense corner may sit one bucket lower in the
port, and float32 rounding in the descriptors.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_global_registration_tpu.models import flagship as jfl
from lidar_global_registration_tpu_torch.models import flagship as tfl
from lidar_global_registration_tpu_torch.ops.transform import rotation_translation_error
from lidar_global_registration_tpu_torch.types import SEED
from test_staged_pyramid import graded_scene

torch.set_num_threads(2)

N = 4096
ANG = 0.3
OFF = np.array([1.5, -0.8, 0.2], np.float32)
# normal_cell, density_src, density_tgt, iss_src, iss_tgt, feature, thr
RADII = (0.6, 0.15, 0.15, 0.4, 0.4, 2.4, 0.6)
SETTINGS = dict(rounds=64, hypothesis_batch=1024, use_iss=True, match_tile=4096,
                metric="uniformity", pyramid=True)  # bench.py:238-256, LGR_BENCH_PYRAMID=1
NOTICE = "# staged pyramid -> single feature-scale path: "


def _rot():
    return np.array([[np.cos(ANG), -np.sin(ANG), 0], [np.sin(ANG), np.cos(ANG), 0], [0, 0, 1]],
                    np.float32)


def pair_inputs(n=N):
    """The graded pair (a, b, vp_a, vp_b, T_gt) at n points per side.  The
    noise seed is one whose ISS keypoints are the same in both packages:
    with seed 7 one of 132 flips, where a neighbour's saliency lies within
    5e-8 of the keypoint's own and the non-maximum suppression goes by
    float32 rounding."""
    rng = np.random.default_rng(8)
    a = (graded_scene(n, 3) + rng.normal(scale=0.004, size=(n, 3))).astype(np.float32)
    b = ((graded_scene(n, 4) + rng.normal(scale=0.004, size=(n, 3))) @ _rot().T
         + OFF).astype(np.float32)
    vp_a = np.array([5.0, 5.0, 30.0], np.float32)
    vp_b = (_rot() @ vp_a + OFF).astype(np.float32)
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3] = _rot()
    T_gt[:3, 3] = OFF
    return a, b, vp_a, vp_b, T_gt


def port_pair(inputs, radii=RADII, **cfg):
    """A pair through the port alone: (result, stage times, debug record,
    printed notices)."""
    a, b, vp_a, vp_b, _T = inputs
    ones = torch.ones(a.shape[0], dtype=torch.bool)
    times, debug, log = {}, {}, io.StringIO()
    with contextlib.redirect_stdout(log):
        out = tfl.register_pair_staged(
            torch.from_numpy(a), ones, torch.from_numpy(b), ones,
            torch.Generator().manual_seed(SEED), *radii, vp_src=torch.from_numpy(vp_a),
            vp_tgt=torch.from_numpy(vp_b), cfg=tfl.FlagshipConfig(**{**SETTINGS, **cfg}),
            return_correspondences=True, stage_times=times, pyramid_debug=debug)
    return out, times, debug, log.getvalue()


def jax_pair(inputs, radii=RADII, **cfg):
    """The pair through the JAX package: (result, its PYRAMID_DEBUG record,
    printed notices)."""
    a, b, vp_a, vp_b, _T = inputs
    ones = jnp.ones((a.shape[0],), bool)
    log = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(log):
        mp.setenv("LGR_CELL_FPFH", "force")
        mp.setenv("LGR_PYRAMID_DEBUG", "1")
        jfl.PYRAMID_DEBUG.clear()
        out = jfl.register_pair_staged(
            jnp.asarray(a), ones, jnp.asarray(b), ones, jax.random.PRNGKey(SEED), *radii,
            vp_src=jnp.asarray(vp_a), vp_tgt=jnp.asarray(vp_b),
            cfg=jfl.FlagshipConfig(**{**SETTINGS, **cfg}), return_correspondences=True)
        record = dict(jfl.PYRAMID_DEBUG)
    return out, record, log.getvalue()


def winners(record):
    """{source row: matched target row} of a debug record's vote."""
    w = record["winners_st"]
    q, m = np.asarray(w["query"]), np.asarray(w["match"])
    if "valid" in w:  # the port keeps padded rows and a mask
        ok = np.asarray(w["valid"])
        q, m = q[ok], m[ok]
    return dict(zip(q.tolist(), m.tolist()))


@pytest.fixture(scope="module", params=["fpfh", "shot"])
def runs(request):
    inputs = pair_inputs()
    change = dict(descriptor=request.param)
    if request.param == "shot":
        change["lrf"] = "gravity"
    jout, jrec, jlog = jax_pair(inputs, **change)
    tout, times, trec, tlog = port_pair(inputs, **change)
    return dict(desc=request.param, jout=jout, jrec=jrec, jlog=jlog, tout=tout, times=times,
                trec=trec, tlog=tlog, T_gt=inputs[4])


def _errors(T, T_gt):
    r, t = rotation_translation_error(torch.as_tensor(np.array(T)), torch.from_numpy(T_gt))
    return float(r), float(t)


def test_both_take_the_pyramid(runs):
    assert "->" not in runs["jlog"] and runs["jrec"], runs["jlog"]
    assert "->" not in runs["tlog"] and runs["trec"], runs["tlog"]
    lo, hi = runs["trec"]["match"]
    assert hi - lo + 1 >= 3  # the scene needs several levels
    labels = list(runs["times"])
    assert labels[:4] == ["plan", "side_src", "side_tgt", "bucket"]
    assert labels[-3:] == ["match_pyramid", "match_corr", "ransac"]
    stage = "fpfh" if runs["desc"] == "fpfh" else "shot"
    for which in ("src", "tgt"):
        side = runs["trec"][f"side_{which}"]
        want = [f"{stage}_{which}_l{l}" for l in range(side["min_log2"], side["max_log2"] + 1)]
        assert [k for k in labels if k.startswith(f"{stage}_{which}_l")] == want


def test_same_keypoints(runs):
    for side in ("side_src", "side_tgt"):
        np.testing.assert_array_equal(runs["trec"][side]["kp_indices"].numpy(),
                                      runs["jrec"][side]["kp_indices"])


def test_level_ranges_and_buckets(runs):
    """Ranges within 1 at each end and equal buckets on at least 95 % of
    the keypoints whose 5th neighbour the JAX window found (the tolerance
    the JAX package holds its own two pyramids to,
    tests/test_staged_pyramid_parity.py); measured: both ranges equal
    ([-1, 2]), 140 of 142 source and 128 of 128 target buckets equal (the JAX
    window found the 5th neighbour of every keypoint; its capped cell list
    lost points of two source keypoints' dense cells)."""
    for side in ("side_src", "side_tgt"):
        j, t = runs["jrec"][side], runs["trec"][side]
        assert abs(j["min_log2"] - t["min_log2"]) <= 1 and abs(j["max_log2"] - t["max_log2"]) <= 1
        lo, hi = max(j["min_log2"], t["min_log2"]), min(j["max_log2"], t["max_log2"])
        jb, tb = np.clip(j["log2_radii"], lo, hi), np.clip(t["log2_radii"].numpy(), lo, hi)
        exact = np.asarray(j["exact_5nn"])
        assert exact.sum() >= 0.5 * exact.size
        assert (jb == tb)[exact].mean() >= 0.95, (side, (jb == tb)[exact].mean())
        # where the port's exact query finds the 5th neighbour, JAX's capped
        # one found it too or estimated
        assert t["exact_5nn"].numpy()[exact].all()


def test_vote_winners_agree(runs):
    """Measured: 140 of 142 winners equal with FPFH, 141 of 142 with SHOT
    (the two keypoints a bucket apart enter other levels)."""
    jw, tw = winners(runs["jrec"]), winners(runs["trec"])
    both = sorted(set(jw) & set(tw))
    assert len(both) >= 0.9 * max(len(jw), len(tw)) and len(both) > 50
    same = np.mean([jw[q] == tw[q] for q in both])
    assert same >= 0.95, same


def test_both_converge(runs):
    """Measured (r_err rad, t_err m): FPFH 0.016 / 0.13 in JAX and 0.043 /
    0.29 in the port from the same 138 correspondences (64 and 66 inliers
    of the two packages' own draws, thresholds of 0.6 m on a 10 m scene);
    SHOT 0.009 / 0.07 and 0.004 / 0.02, 48 inliers of 142 in both."""
    for out in (runs["jout"], runs["tout"]):
        r, t = _errors(out["transformation"], runs["T_gt"])
        assert bool(out["converged"]) and r < 0.05 and t < RADII[6], (r, t)
    assert float(runs["tout"]["metric"]) > 0.3  # the uniformity gate


GATES = {
    # tgt's window (4 x its density cell) holds no neighbour: every row takes
    # the window's estimate, three buckets under the source's lowest
    "disjoint": (dict(), (0.6, 0.15, 0.004, 0.4, 0.4, 2.4, 0.6),
                 "pyramid ranges disjoint: src ["),
    # a level base of 1.25 spreads the same radii over more than 6 levels
    "levels": (dict(scale_factor=1.25), RADII, "pyramid would need >6 levels (src ["),
}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_failed_gate_takes_the_feature_scale_route(gate):
    """A failed level gate prints the JAX package's notice
    (flagship.py:1327-1336, 1501-1503) and the pair registers through the
    feature-scale route."""
    change, radii, message = GATES[gate]
    inputs = pair_inputs()
    out, times, debug, log = port_pair(inputs, radii=radii, **change)
    assert log.startswith(NOTICE + message), log
    assert not debug and "match_pyramid" not in times
    assert "fs_maps" in times and "fpfh_src" in times  # the feature-scale route ran
    r, t = _errors(out["transformation"], inputs[4])
    assert bool(out["converged"]) and r < 0.05 and t < radii[6], (r, t)


def test_prune_levels():
    """The pruned range of a keypoint histogram (flagship._prune): bottom
    levels under 10 % of the fullest, top levels under 0.1 %, and the gate
    on an empty histogram."""
    def hist(**counts):
        h = np.zeros(49, np.int64)
        for b, c in counts.items():
            h[int(b[1:].replace("m", "-")) + 24] = c
        return h

    assert tfl._prune_levels(hist(bm1=3, b0=7, b1=21, b2=11)) == (-1, 2)
    assert tfl._prune_levels(hist(bm2=1, bm1=2, b0=15, b1=23, b2=16)) == (0, 2)
    assert tfl._prune_levels(hist(bm1=1, b1=2000, b3=1)) == (1, 1)  # across an empty bucket
    assert tfl._prune_levels(hist(b24=5)) == (24, 24)
    with pytest.raises(tfl._GateFailed, match="no occupied pyramid buckets"):
        tfl._prune_levels(hist())

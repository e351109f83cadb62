"""The PyTorch port's host pyramid (models/pyramid.py) against the JAX
package's: initialize_side with the AUTO feature radius (level ranges,
buckets, each level's keypoint rows) and with a fixed one (also the level
surface and the valid descriptors), then match_sides with each strategy
(ratio, one_sided, cluster, lr) on the same descriptors: the port's AUTO
sides, given to both packages.

The scene is the range-graded pair of tests/test_torch_e2e_pyramid.py at
4,096 points a side (its density falls ~64x, so the AUTO radii span
several buckets), with the JAX package's kNN normals and the port's ISS
keypoints given to both packages.  On the CPU the port runs the plain
versions of its CUDA kernels (K5 for the level surfaces' SPFH, K7 for the
descriptor 1-NN).

The AUTO bucket of a keypoint comes from the distance to its 5th nearest
point.  The port's query is exact; the JAX package's keeps 32 points a
cell of a grid sized from the mean spacing, which the scene's dense corner
overflows 64 times over.  The AUTO sides are therefore compared with that
cap lifted in JAX (knn_distances(cap=4096)), and the shipped cap's buckets
are counted apart; the JAX side's level work (surfaces, normals,
descriptors) is left out there, and compared on the fixed radius's level.
"""
import functools
import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_global_registration_tpu import types as jtypes
from lidar_global_registration_tpu.models import pyramid as jpyr
from lidar_global_registration_tpu.ops.density import knn_distances
from lidar_global_registration_tpu.ops.normals import estimate_normals_knn as jnormals
from lidar_global_registration_tpu_torch import types as ttypes
from lidar_global_registration_tpu_torch.models import pyramid as tpyr
from lidar_global_registration_tpu_torch.ops.iss import detect_keypoints
from test_torch_e2e_pyramid import pair_inputs

torch.set_num_threads(2)

ISS_RADIUS = 0.4
BASE = dict(descriptor_id="fpfh", keypoint_id="iss", iss_radius_src=ISS_RADIUS,
            iss_radius_tgt=ISS_RADIUS, distance_thr=0.6)


@pytest.fixture(scope="module")
def clouds():
    """Per side: (JAX cloud, port cloud, keypoint rows, viewpoint)."""
    a, b, vp_a, vp_b, _T = pair_inputs()
    out = []
    for x, vp in ((a, vp_a), (b, vp_b)):
        nrm = np.array(jnormals(jtypes.Cloud.from_numpy(x), k=30, viewpoint=vp).normal)[:len(x)]
        tc = ttypes.Cloud.from_numpy(x, nrm)
        kp = detect_keypoints(tc, "iss", ISS_RADIUS)
        out.append((jtypes.Cloud.from_numpy(x, nrm), tc, kp, vp))
    return out


def _sides(clouds, port=True, jax_cap=4096, levels=True, **kw):
    """Both packages' initialize_side on both clouds (the JAX package's
    LGR_PYRAMID_DEBUG record and the port's debug= record); jax_cap the
    JAX package's cell cap of its 5th-neighbour query; levels=False leaves
    out JAX's level work (only its buckets are wanted)."""
    jp, tp = jtypes.AlignmentParameters(**BASE, **kw), ttypes.AlignmentParameters(**BASE, **kw)
    jsides, tsides, tdebug = [], [], {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LGR_PYRAMID_DEBUG", "1")
        mp.setattr(jpyr, "knn_distances", functools.partial(knn_distances, cap=jax_cap))
        if not levels:
            for name in ("voxel_downsample", "estimate_normals_knn"):
                mp.setattr(jpyr, name, lambda c, *a, **k: c)
            mp.setattr(jpyr, "compute_descriptors", lambda p, kps, *a: (kps.xyz, kps.valid))
        jpyr.PYRAMID_DEBUG.clear()
        for i, (jc, tc, kp, vp) in enumerate(clouds):
            jsides.append(jpyr.initialize_side(jc, kp.numpy().astype(np.int32), jp, vp,
                                               ISS_RADIUS, is_source=i == 0))
            if port:
                tsides.append(tpyr.initialize_side(tc, kp, tp, vp, ISS_RADIUS, i == 0, tdebug))
        jdebug = dict(jpyr.PYRAMID_DEBUG)
    return dict(jax=jsides, port=tsides, jdebug=jdebug, tdebug=tdebug, jp=jp, tp=tp)


@pytest.fixture(scope="module")
def auto(clouds):
    return _sides(clouds, levels=False)


def test_auto_sides_match_jax(auto):
    """AUTO radius: the same level range on both sides (at least three
    levels), the same bucket for every keypoint and each level's keypoint
    rows equal."""
    for side in ("src", "tgt"):
        j, t = auto["jdebug"][f"side_{side}"], auto["tdebug"][f"side_{side}"]
        assert (t["min_log2"], t["max_log2"]) == (j["min_log2"], j["max_log2"]), side
        assert t["max_log2"] - t["min_log2"] >= 2
        np.testing.assert_array_equal(t["kp_indices"], j["kp_indices"])
        np.testing.assert_array_equal(t["log2_radii"], j["log2_radii"])
    for js, ts in zip(auto["jax"], auto["port"]):
        assert len(ts.level_kp_rows) == len(js.level_kp_rows)
        for jr, tr in zip(js.level_kp_rows, ts.level_kp_rows):
            np.testing.assert_array_equal(tr.numpy(), jr)


def test_auto_buckets_against_the_capped_query(clouds, auto):
    """With the JAX package's shipped cap (32 a cell) its 5th-neighbour
    distances in the dense corner come from the cell's first 32 points, so
    keypoints there get a larger radius: measured 17 of 142 source and 24
    of 128 target keypoints a bucket or more higher than in the port (none
    lower), and JAX's ranges start a level higher ([0, 2] against
    [-1, 2])."""
    shipped = _sides(clouds, port=False, jax_cap=32, levels=False)["jdebug"]
    for side, most in (("src", 17), ("tgt", 24)):
        j, t = shipped[f"side_{side}"], auto["tdebug"][f"side_{side}"]
        lo = max(j["min_log2"], t["min_log2"])
        tb = np.clip(t["log2_radii"], lo, None)
        assert (j["log2_radii"] >= tb).all(), side
        assert 0 < (j["log2_radii"] > tb).sum() <= most, side


def test_fixed_radius_is_one_level(clouds):
    """A fixed feature_radius: one bucket floor(log2(r) / log2(scale)) for
    every keypoint, as in JAX; every keypoint on the level, whose surface
    has JAX's row count (the two voxel downsamples sum in another order)
    and whose descriptors are valid on the same rows."""
    s = _sides(clouds, feature_radius=2.4)
    for js, ts in zip(s["jax"], s["port"]):
        assert (ts.min_log2, ts.max_log2) == (js.min_log2, js.max_log2) == (1, 1)
        assert len(ts.level_kp_rows) == 1
        np.testing.assert_array_equal(ts.level_kp_rows[0].numpy(), js.level_kp_rows[0])
        assert int(ts.level_surfaces[0].count()) == int(js.level_surfaces[0].count())
        np.testing.assert_array_equal(ts.level_feat_valid[0].numpy(),
                                      np.asarray(js.level_feat_valid[0]))


def _jax_side(ts) -> jpyr.PyramidSide:
    """The port side's state (levels, rows, descriptors) as a JAX side."""
    def cloud(c):
        return jtypes.Cloud(*(jnp.asarray(getattr(c, f).numpy()) for f in
                              ("xyz", "normal", "weight", "curvature", "valid")))
    return jpyr.PyramidSide(
        cloud=cloud(ts.cloud), kp_indices=ts.kp_indices.numpy().astype(np.int32),
        kps=cloud(ts.kps), iss_radius=ts.iss_radius, min_log2=ts.min_log2,
        max_log2=ts.max_log2, level_kp_rows=[r.numpy() for r in ts.level_kp_rows],
        level_features=[jnp.asarray(f.numpy()) for f in ts.level_features],
        level_feat_valid=[jnp.asarray(v.numpy()) for v in ts.level_feat_valid],
        level_kps=[cloud(c) for c in ts.level_kps])


def _jax_set(c) -> dict:
    v = np.asarray(c.valid)
    return {k: np.asarray(getattr(c, k))[v] for k in ("query", "match", "distance", "threshold")}


@pytest.mark.parametrize("matching", ["ratio", "one_sided", "cluster", "lr"])
def test_match_sides_matches_jax(auto, matching):
    """Every strategy on the port sides' descriptors (four levels a side):
    the same correspondences (query, match) but at most one on either
    side, and on them the same thresholds (the keypoint clouds' densities,
    within an ulp: the two kNN round their distances apart) and descriptor
    distances within 0.03.  Both 1-NN use the Gram trick in float32 (JAX's
    XLA matcher, the port's K7 plain version) and sum the products in
    another order: at FPFH norms of ~100 a distance of a few hundredths is
    within their rounding (0.09 against 0.11 measured on other
    descriptors), and 1 of 43 level-1 rows here takes the other of two
    near-tied neighbours.  Measured: the same correspondences for all four
    strategies (67, 142, 142, 55)."""
    jp = auto["jp"].replace(matching_id=matching)
    tp = auto["tp"].replace(matching_id=matching)
    with contextlib.redirect_stdout(io.StringIO()) as log:
        jc = jpyr.match_sides(*[_jax_side(ts) for ts in auto["port"]], jp)
        tc = tpyr.match_sides(*auto["port"], tp)
    assert "Feature estimation took" in log.getvalue()
    j, t = _jax_set(jc), tc.to_numpy()
    jpairs = {(q, m): i for i, (q, m) in enumerate(zip(j["query"].tolist(), j["match"].tolist()))}
    tpairs = {(q, m): i for i, (q, m) in enumerate(zip(t["query"].tolist(), t["match"].tolist()))}
    shared = jpairs.keys() & tpairs.keys()
    assert len(shared) > 30
    assert len(jpairs) - len(shared) <= 1 and len(tpairs) - len(shared) <= 1
    ji = np.array([jpairs[k] for k in sorted(shared)])
    ti = np.array([tpairs[k] for k in sorted(shared)])
    np.testing.assert_allclose(t["threshold"][ti], j["threshold"][ji], rtol=2e-7, atol=0)
    np.testing.assert_allclose(t["distance"][ti], j["distance"][ji], rtol=0, atol=0.03)


def test_unknown_matcher_warns_and_takes_lr(auto):
    sides = auto["port"]
    with contextlib.redirect_stdout(io.StringIO()), pytest.warns(UserWarning, match="lr will"):
        got = tpyr.match_sides(*sides, auto["tp"].replace(matching_id="bogus")).to_numpy()
    with contextlib.redirect_stdout(io.StringIO()):
        want = tpyr.match_sides(*sides, auto["tp"].replace(matching_id="lr")).to_numpy()
    for k in ("query", "match"):
        np.testing.assert_array_equal(got[k], want[k])

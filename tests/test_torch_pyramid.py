"""Parity: the pieces of the PyTorch port's staged pyramid against the JAX
package: pyramid._consensus_vote, the candidate branch of
flagship._compact_match_corr_stage, the radius buckets and level ranges
(against flagship.PYRAMID_DEBUG on a scene of uniform density, where no
cell of the JAX package's capped query overflows), the windowed kNN behind
them, and the graded scene's patch weights."""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _scene_tables
from lidar_global_registration_tpu.models import flagship as jfl
from lidar_global_registration_tpu.models.pyramid import _consensus_vote as jax_vote
from lidar_global_registration_tpu_torch.models import flagship as tfl
from lidar_global_registration_tpu_torch.models.pyramid import _consensus_vote, _first_argmax
from lidar_global_registration_tpu_torch.ops.density import knn_window
from lidar_global_registration_tpu_torch.scene import patch_weights, scene_pair
from lidar_global_registration_tpu_torch.types import SEED
from test_feature_scale import _scene

torch.set_num_threads(2)

T = torch.from_numpy


# ---------------------------------------------------------------------------
# the cross-level vote
# ---------------------------------------------------------------------------
def _candidates(case: str):
    """(cand_idx i32[M, L], cand_dist f32[M, L], cand_mask bool[M, L],
    train_xyz f32[Mt, 3], iss_radius) for one named case."""
    rng = np.random.default_rng(566)
    M, Mt, L, r = 400, 300, 6, 0.4
    if case == "one_level":
        L = 1
    if case == "randomness_2":
        L = 8
    train = rng.uniform(0, 12, size=(Mt, 3)).astype(np.float32)
    train[:, 2] *= 0.1
    idx = rng.integers(0, Mt, size=(M, L)).astype(np.int32)
    dist = rng.uniform(1, 60, size=(M, L)).astype(np.float32)
    mask = np.ones((M, L), bool)
    if case in ("random", "randomness_2", "masked"):
        # half the queries: candidates gathered around one train point
        near = np.argsort(((train[:, None] - train[None]) ** 2).sum(-1), 1)[:, :L]
        idx[:M // 2] = near[rng.integers(0, Mt, M // 2)][:, rng.permutation(L)]
    if case == "masked":
        mask = rng.random((M, L)) < 0.6
        mask[:20] = False  # queries with no candidate at all
        dist[~mask] = 3.0e38
    if case == "ties":
        # candidates too far apart to vote for one another (all scores 1),
        # descriptor distances equal in pairs: the first column wins
        train = (np.arange(Mt)[:, None] * np.array([50.0, 0, 0])).astype(np.float32)
        idx = np.stack([rng.permutation(Mt)[:L] for _ in range(M)]).astype(np.int32)
        dist = np.repeat(rng.uniform(1, 60, size=(M, L // 2)), 2, 1).astype(np.float32)
        dist[: M // 2] = 7.0
    if case == "repeats":
        # every level names one of two train points; some queries one only
        idx = idx[:, :1] + (rng.random((M, L)) < 0.5) * (idx[:, 1:2] - idx[:, :1])
        idx[:50] = idx[:50, :1]
        idx = idx.astype(np.int32)
    return idx, dist, mask, train, r


@pytest.mark.parametrize("case", ["random", "randomness_2", "masked", "ties", "one_level",
                                  "repeats"])
def test_consensus_vote_matches_jax(case):
    """All five outputs equal, the distances exactly: the scores are
    elementwise float32 sums taken in the same order in both packages."""
    idx, dist, mask, train, r = _candidates(case)
    want = [np.asarray(x) for x in jax_vote(jnp.asarray(idx), jnp.asarray(dist),
                                            jnp.asarray(mask), jnp.asarray(train),
                                            jnp.float32(r))]
    got = _consensus_vote(T(idx.astype(np.int64)), T(dist), T(mask), T(train), r)
    for name, g, w in zip(("b_idx", "b_dist", "b_mask", "s_dist", "s_mask"), got, want):
        assert torch.equal(g, T(np.array(w, np.int64 if w.dtype == np.int32 else w.dtype))), (case, name)
    b_idx, _b_dist, b_mask, _s_dist, s_mask = (g.numpy() for g in got)
    if case == "ties":
        np.testing.assert_array_equal(b_idx[:200], idx[:200, 0])
    if case == "masked":
        assert not b_mask[:20].any() and b_mask[20:].sum() > 300
    if case in ("one_level",):
        assert not s_mask.any()
    if case == "repeats":
        assert not s_mask[:50].any() and s_mask[50:].any()
    if case == "random":
        # the consensus moves winners off the best descriptor distance
        assert (b_idx[:200] != idx[np.arange(200), dist[:200].argmin(1)]).any()


def test_first_argmax_takes_the_lowest_of_equal_maxima():
    key = torch.tensor([[1.0, 3.0, 3.0], [-torch.inf] * 3, [2.0, 2.0, 2.0], [0.0, 1.0, 5.0]])
    assert _first_argmax(key).tolist() == [1, 0, 0, 2]


# ---------------------------------------------------------------------------
# the candidate branch of the matching stage
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("max_corr", [1024, 64])
def test_candidate_branch_matches_jax(max_corr):
    """_compact_match_corr_stage fed vote winners in place of descriptors
    (have_cand in the JAX package, its keypoint kNN exact): the same
    matches, mask and thresholds."""
    rng = np.random.default_rng(11)
    N, n_q, n_t = 4096, 700, 650
    src = rng.uniform(0, 40, size=(N, 3)).astype(np.float32)
    src[:, 2] *= 0.05
    ang = 0.3
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                 np.float32)
    tgt = (src @ R.T + np.array([3.0, -2.0, 0.5], np.float32)).astype(np.float32)
    kp_s = np.zeros(N, bool)
    kp_s[rng.permutation(N)[:n_q]] = True
    kp_t = np.zeros(N, bool)
    # most target keypoints are source keypoints' own rows, so true matches exist
    rows_s = np.nonzero(kp_s)[0]
    kp_t[rows_s[:500]] = True
    kp_t[rng.permutation(np.nonzero(~kp_s)[0])[:n_t - 500]] = True
    mq, mt = tfl._pad_quantum(n_q), tfl._pad_quantum(n_t)
    sqj = tfl._compact_rows(T(kp_s), n_q, mq)
    stj = tfl._compact_rows(T(kp_t), n_t, mt)
    sq_g, st_g = sqj.clamp_max(N - 1), stj.clamp_max(N - 1)
    qv, tv = torch.arange(mq) < n_q, torch.arange(mt) < n_t
    qv[5] = tv[9] = False  # keypoints without a valid descriptor on any level
    # winners: the true counterpart where it is a target keypoint, else random
    slot_t = np.full(N, -1)
    slot_t[stj[:n_t].numpy()] = np.arange(n_t)
    slot_s = np.full(N, -1)
    slot_s[sqj[:n_q].numpy()] = np.arange(n_q)
    ic_st = rng.integers(0, n_t, mq)
    true_st = slot_t[sq_g.numpy()]
    ic_st = np.where(true_st >= 0, true_st, ic_st)
    ic_ts = rng.integers(0, n_q, mt)
    true_ts = slot_s[st_g.numpy()]
    ic_ts = np.where(true_ts >= 0, true_ts, ic_ts)
    mc_st = qv.numpy() & (rng.random(mq) < 0.95)
    mc_ts = tv.numpy() & (rng.random(mt) < 0.95)
    dens = np.zeros(N, np.float32)
    jcfg = jfl.FlagshipConfig(cluster_approx_knn=False, max_correspondences=max_corr)
    kc = max(2, min(jcfg.cluster_k, n_q - 1, n_t - 1))
    J = jnp.asarray
    jj, jkeep, jthr = jfl._compact_match_corr_stage(
        None, None, (J(ic_st.astype(np.int32))[:, None], J(mc_st)[:, None],
                     J(ic_ts.astype(np.int32))[:, None], J(mc_ts)[:, None]),
        J(qv.numpy()), J(tv.numpy()), J(sqj.numpy().astype(np.int32)),
        J(stj.numpy().astype(np.int32)), J(sq_g.numpy().astype(np.int32)),
        J(st_g.numpy().astype(np.int32)), J(src), J(tgt), J(dens), J(dens), jnp.float32(0.8),
        jcfg, kc, True)
    tj, tkeep, tthr = tfl._compact_match_corr_stage(
        None, None, qv, tv, sqj, stj, sq_g, st_g, T(src), T(tgt), T(dens), T(dens), 0.8,
        tfl.config_from_jax(dataclasses.asdict(jcfg)), kc,
        cand=(T(ic_st)[:, None], T(mc_st)[:, None], T(ic_ts)[:, None], T(mc_ts)[:, None]))
    jkeep = np.asarray(jkeep)
    np.testing.assert_array_equal(tkeep.numpy(), jkeep)
    assert (jkeep.sum() > 300) if max_corr == 1024 else (64 <= jkeep.sum() < 100)
    np.testing.assert_array_equal(tj.numpy()[jkeep], np.asarray(jj)[jkeep])
    # thresholds: the keypoint cloud's density from Gram-trick distances,
    # whose matmul sums in another order: d2 to a few 1e-4 absolute at
    # |x|^2 ~ 800, the tolerance of tests/test_torch_cluster.py (measured:
    # 3 of 505 thresholds differ by over 2e-4, the most 2.5e-4 at d = 0.27)
    np.testing.assert_allclose(tthr.numpy()[jkeep] ** 2, np.asarray(jthr)[jkeep] ** 2, rtol=0,
                               atol=5e-4)
    assert not tkeep[sqj[5]] and (tthr[tkeep] < 0.8).any()


# ---------------------------------------------------------------------------
# the bucket query and the level ranges
# ---------------------------------------------------------------------------
def test_knn_window_equals_brute_force(rng):
    pts = rng.uniform(0, 10, size=(3000, 3)).astype(np.float32)
    pts[:, 2] *= 0.05
    pts[100] = pts[101]  # a duplicate: both count
    valid = rng.random(3000) < 0.9
    r, k = 0.25, 5
    got = knn_window(T(pts), T(valid), r, k).numpy()
    P = T(pts)
    d = P[:, None, :] - P[None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    d2 = torch.where(T(valid)[None, :] & (d2 <= np.float32(r) * np.float32(r)), d2, torch.inf)
    want = torch.sort(d2, 1).values[:, :k].sqrt().numpy()
    want[~valid] = np.inf
    np.testing.assert_array_equal(got, want)
    found = np.isfinite(got[:, k - 1])
    assert 0.2 < found[valid].mean() < 0.98 and (got[valid, 0] == 0).all()
    # rows whose k-th neighbour a smaller window holds are done in the
    # passes at r / 4 and r / 2, with the same distances; the rest at r
    half = knn_window(T(pts), T(valid), 0.5 * r, k).numpy()
    early = np.isfinite(half[:, k - 1])
    assert early.any() and (got[early] == half[early]).all() and not early[found].all()


UNIFORM_RADII = (0.5, 0.15, 0.15, 0.35, 0.35, 1.6, 0.5)  # tests/test_torch_e2e_iss.py


@pytest.fixture(scope="module")
def uniform_run():
    """The dense scene of tests/test_feature_scale.py (uniform density: no
    4 x density cell holds more than the JAX query's cap of 64) through
    both packages' pyramids, SHOT (the cheaper descriptor; the buckets do
    not depend on it)."""
    n = 4096
    rng = np.random.default_rng(7)
    a = (_scene(n, 3) + rng.normal(scale=0.004, size=(n, 3))).astype(np.float32)
    ang = 0.3
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                 np.float32)
    b = ((_scene(n, 4) + rng.normal(scale=0.004, size=(n, 3))) @ R.T
         + np.array([1.5, -0.8, 0.2], np.float32)).astype(np.float32)
    settings = dict(rounds=4, hypothesis_batch=256, use_iss=True, pyramid=True,
                    descriptor="shot")
    log = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(log):
        mp.setenv("LGR_CELL_FPFH", "force")
        mp.setenv("LGR_PYRAMID_DEBUG", "1")
        jfl.PYRAMID_DEBUG.clear()
        ones = jnp.ones((n,), bool)
        jfl.register_pair_staged(jnp.asarray(a), ones, jnp.asarray(b), ones,
                                 jax.random.PRNGKey(SEED), *UNIFORM_RADII,
                                 cfg=jfl.FlagshipConfig(**settings))
        jrec = dict(jfl.PYRAMID_DEBUG)
    trec = {}
    tones = torch.ones(n, dtype=torch.bool)
    with contextlib.redirect_stdout(log):
        tfl.register_pair_staged(T(a), tones, T(b), tones, torch.Generator().manual_seed(SEED),
                                 *UNIFORM_RADII, cfg=tfl.FlagshipConfig(**settings),
                                 pyramid_debug=trec)
    return dict(a=a, b=b, jrec=jrec, trec=trec, log=log.getvalue())


def test_uniform_scene_ranges_and_buckets_equal(uniform_run):
    assert "->" not in uniform_run["log"], uniform_run["log"]
    jrec, trec = uniform_run["jrec"], uniform_run["trec"]
    assert jrec and trec
    for side, x, dcell in (("side_src", uniform_run["a"], UNIFORM_RADII[1]),
                           ("side_tgt", uniform_run["b"], UNIFORM_RADII[2])):
        j, t = jrec[side], trec[side]
        assert (j["min_log2"], j["max_log2"]) == (t["min_log2"], t["max_log2"])
        np.testing.assert_array_equal(t["kp_indices"].numpy(), j["kp_indices"])
        np.testing.assert_array_equal(t["exact_5nn"].numpy(), j["exact_5nn"])
        # equal buckets but where the radius lies within 1e-5 relatively of
        # a bucket edge (float32 log2 and distance rounding)
        rows = j["kp_indices"]
        d5 = knn_window(T(x), torch.ones(len(x), dtype=torch.bool), 4 * dcell,
                        5)[rows, 4].numpy()
        lg = np.log2(np.sqrt(352.0 * d5.astype(np.float64) ** 2 / np.pi))
        clear = np.abs(lg - np.round(lg)) > 1e-5 / np.log(2.0)
        differ = t["log2_radii"].numpy() != j["log2_radii"]
        assert not (differ & clear & j["exact_5nn"]).any()
        assert differ.mean() <= 0.01


def test_bucket_rows_estimate_and_histogram():
    """Rows with fewer than 5 points in the window take the window's
    estimate 4 dcell sqrt(5 / count); the histogram counts keypoint rows."""
    pts = np.zeros((40, 3), np.float32)
    pts[:, 0] = np.arange(40) * 10.0  # isolated points: count 1
    pts[:8, 0] = np.arange(8) * 0.01  # a cluster of 8 within the window
    valid = np.ones(40, bool)
    valid[39] = False
    kp = np.zeros(40, bool)
    kp[[0, 20, 39]] = True
    dcell = 0.1
    li, hist, found = tfl._bucket_rows(T(pts), T(valid), T(kp), dcell, 2.0)
    assert found[:8].all() and not found[8:].any()
    est = 0.4 * np.sqrt(5.0)
    assert li[20] == int(np.floor(np.log2(np.sqrt(352 * est * est / np.pi))))
    assert li[0] == int(np.floor(np.log2(np.sqrt(352 * 0.04 ** 2 / np.pi))))
    assert int(hist.sum()) == 2 and hist[li[0] + 24] == 1 and hist[li[20] + 24] == 1


# ---------------------------------------------------------------------------
# the graded scene
# ---------------------------------------------------------------------------
def test_graded_patch_weights():
    """patch_weights(graded=True) is the JAX sampler's formula
    (__graft_entry__.py:181-187), and the sampler follows it."""
    tables = _scene_tables(SEED, extent=30.0)
    origins, eus, evs, m_c, _m_r, areas = tables
    w = areas / areas.sum()
    np.testing.assert_allclose(patch_weights(tables, False), w, rtol=1e-6)
    centres = np.concatenate([origins[:, :2] + 0.5 * (eus[:, :2] + evs[:, :2]), m_c])
    dist = np.linalg.norm(centres - np.array([2.0, 2.0]), axis=1)
    wg = w / (1.0 + (dist / 15.0) ** 2)
    wg = wg / wg.sum()
    got = patch_weights(tables, True)
    np.testing.assert_allclose(got, wg, rtol=1e-5)
    assert abs(got.sum() - 1.0) < 1e-9
    a, b, _vp_a, _vp_b, T_gt = scene_pair(tables, 20000, 30.0, SEED, torch.device("cpu"),
                                          graded=True)
    ground = float((a[:, 2].abs() < 0.04).float().mean())
    assert abs(ground - got[0]) < 0.03
    # the boxes and mounds near the scanner at (2, 2) draw more of the points
    flat, _b2, *_ = scene_pair(tables, 20000, 30.0, SEED, torch.device("cpu"))

    def raised_range(x):
        up = x[x[:, 2] > 0.05]
        return float((up[:, :2] - 2.0).norm(dim=1).mean())

    # measured 16.55 m graded, 18.99 m flat
    assert raised_range(a) < raised_range(flat) - 1.5

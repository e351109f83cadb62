"""Parity: the PyTorch port's RANSAC stage (correspondences and uniformity
scores), its helpers, the cloud density and the config bridge against the
JAX package."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_pair
from lidar_global_registration_tpu.models import flagship as jfl
from lidar_global_registration_tpu.models.ransac import draw_hypotheses as jax_draw
from lidar_global_registration_tpu.ops.density import cloud_density as jax_cloud_density
from lidar_global_registration_tpu.ops.metrics import estimate_max_iterations as jax_emi
from lidar_global_registration_tpu.ops import metrics as jmetrics
from lidar_global_registration_tpu.ops.transform import kabsch as jax_kabsch
from lidar_global_registration_tpu.types import Cloud
from lidar_global_registration_tpu_torch.models import flagship as tfl
from lidar_global_registration_tpu_torch.models.ransac import hypotheses_from_samples
from lidar_global_registration_tpu_torch.ops import density as tdensity
from lidar_global_registration_tpu_torch.ops.density import cloud_density
from lidar_global_registration_tpu_torch.ops.metrics import (
    estimate_max_iterations,
    uniformity_bins,
    uniformity_entropy,
)
from lidar_global_registration_tpu_torch.ops.transform import kabsch

torch.set_num_threads(2)

T = torch.from_numpy


def _rot(ax, ang):
    ax = np.asarray(ax, np.float64) / np.linalg.norm(ax)
    K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
    return (np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K).astype(np.float32)


def _corr_set(rng, M=400, inlier=0.7):
    """Correspondences p -> q = R p + t (+ noise) with a share of outliers."""
    R = _rot([0.2, -0.4, 1.0], 0.7)
    t = np.array([3.0, -1.0, 0.5], np.float32)
    p = rng.uniform(-10, 10, size=(M, 3)).astype(np.float32)
    q = (p @ R.T + t + rng.normal(scale=0.01, size=(M, 3))).astype(np.float32)
    out = rng.random(M) > inlier
    q[out] = rng.uniform(-10, 10, size=(out.sum(), 3))
    cvalid = rng.random(M) < 0.9
    thr = np.full(M, 0.1, np.float32)
    return p, q, thr, cvalid, R, t


def test_kabsch_matches_jax_on_batched_triples(rng):
    p = rng.uniform(-5, 5, size=(64, 3, 3)).astype(np.float32)
    R = _rot([1.0, 0.3, -0.2], 1.1)
    q = (p @ R.T + np.array([1.0, 2.0, -3.0], np.float32)
         + rng.normal(scale=0.05, size=p.shape)).astype(np.float32)
    jR, jt = (np.asarray(v) for v in jax_kabsch(jnp.asarray(p), jnp.asarray(q)))
    tR, tt = (v.numpy() for v in kabsch(T(p), T(q)))
    # XLA's and PyTorch's float32 eigh of Horn's 4x4 matrix round apart by
    # up to 5e-5 in R on these triples (each is 1e-5..2e-4 off float64)
    np.testing.assert_allclose(tR, jR, atol=1e-4)
    np.testing.assert_allclose(tt, jt, atol=3e-4)  # |t| ~ 4, lever arm ~5
    # weighted, larger sets
    w = (rng.random((2, 50)) < 0.8).astype(np.float32)
    p = rng.uniform(-5, 5, size=(2, 50, 3)).astype(np.float32)
    q = (p @ R.T + rng.normal(scale=0.05, size=p.shape)).astype(np.float32)
    jR, jt = (np.asarray(v) for v in jax_kabsch(jnp.asarray(p), jnp.asarray(q), jnp.asarray(w)))
    tR, tt = (v.numpy() for v in kabsch(T(p), T(q), T(w)))
    np.testing.assert_allclose(tR, jR, atol=1e-5)
    np.testing.assert_allclose(tt, jt, atol=5e-5)


def test_hypotheses_from_jax_sample_rows(rng):
    p, q, _thr, cvalid, _R, _t = _corr_set(rng)
    order = jnp.argsort(~jnp.asarray(cvalid))  # valid rows first (stable)
    nvalid = int(cvalid.sum())
    key = jax.random.PRNGKey(7)
    B, S = 512, 3
    jR, jt, jok = (np.asarray(v) for v in jax_draw(
        jnp.asarray(p), jnp.asarray(q), key, nvalid, B, S, 0.95, order=order))
    # the same draw jax_draw makes, handed to the port as sample rows
    rows = np.asarray(order[jax.random.randint(key, (B, S), 0, nvalid)])
    tR, tt, tok = (v.numpy() for v in hypotheses_from_samples(
        T(p), T(q), T(rows.astype(np.int64)), 0.95))
    np.testing.assert_array_equal(tok, jok)
    assert 0 < tok.sum() < B
    # samples that pair inliers with outliers give ill-conditioned Horn
    # matrices: against float64 the port's float32 R is off by up to 8e-5
    # here, the JAX package's by up to 1.7e-4
    np.testing.assert_allclose(tR[tok], jR[tok], atol=3e-4)
    np.testing.assert_allclose(tt[tok], jt[tok], atol=2e-3)  # lever arm ~10


def test_estimate_max_iterations_exact():
    support = np.array([0, 1, 5, 37, 120, 300, 555, 799, 800, 5000], np.int32)
    for n_corr in (0.0, 800.0, 4096.0):
        j = np.asarray(jax_emi(jnp.asarray(support), jnp.float32(n_corr), 0.999, 3))
        t = estimate_max_iterations(T(support), n_corr, 0.999, 3).numpy()
        np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
        # exact but for the last bit of float32 log (XLA vs PyTorch)
        np.testing.assert_array_max_ulp(t[np.isfinite(t)], j[np.isfinite(j)], maxulp=1)


@pytest.mark.parametrize("M", [64, 2500])
def test_subset_sel_exact(rng, M):
    # ~1800 valid: a strided sample at M=64, every valid row at M=2500
    cvalid = rng.random(3000) < 0.6
    j = np.asarray(jfl._subset_sel(jnp.asarray(cvalid), M))
    t = tfl._subset_sel(T(cvalid), M).numpy()
    np.testing.assert_array_equal(t, j)


def test_correspondence_stage_exact(rng):
    N = 500
    idx_st = rng.integers(0, N, size=(N, 1)).astype(np.int32)
    idx_ts = rng.integers(0, N, size=(N, 1)).astype(np.int32)
    idx_ts[idx_st[:250, 0], 0] = np.arange(250)  # some mutual pairs
    mask_st = rng.random((N, 1)) < 0.9
    mask_ts = rng.random((N, 1)) < 0.9
    dens_s = rng.uniform(0, 0.5, N).astype(np.float32)
    dens_t = rng.uniform(0, 0.5, N).astype(np.float32)
    dens_s[:20] = 0.0
    dens_t[:40] = 0.0
    jj, jk, jthr = (np.asarray(v) for v in jfl._correspondence_stage(
        *(jnp.asarray(a) for a in (idx_st, mask_st, idx_ts, mask_ts, dens_s, dens_t)), 0.3))
    tj, tk, tthr = (v.numpy() for v in tfl._correspondence_stage(
        T(idx_st.astype(np.int64)), T(mask_st), T(idx_ts.astype(np.int64)), T(mask_ts),
        T(dens_s), T(dens_t), 0.3))
    np.testing.assert_array_equal(tj, jj)
    np.testing.assert_array_equal(tk, jk)
    assert 0 < tk.sum() < N
    np.testing.assert_array_equal(tthr, jthr)


def test_cloud_density_matches_jax():
    a, _b = _synthetic_pair(3000)
    a = np.concatenate([a, np.zeros((100, 3), np.float32)])
    valid = np.arange(a.shape[0]) < 3000
    z = jnp.zeros((a.shape[0],), jnp.float32)
    jd = jax_cloud_density(Cloud(xyz=jnp.asarray(a), normal=jnp.zeros_like(jnp.asarray(a)),
                                 weight=z + 1.0, curvature=z, valid=jnp.asarray(valid)))
    td = cloud_density(T(a), T(valid))
    assert td > 0
    np.testing.assert_allclose(td, jd, rtol=1e-5)


def test_ransac_solve_matches_jax_pose(rng):
    p, q, thr, cvalid, R, t = _corr_set(rng, M=2000)
    cfg_j = jfl.FlagshipConfig(rounds=8, hypothesis_batch=512, use_iss=False)
    jres = jfl._ransac_stage(jnp.asarray(p), jnp.asarray(q), jnp.asarray(thr),
                             jnp.asarray(cvalid), jax.random.PRNGKey(3), cfg_j)
    cfg_t = tfl.config_from_jax(dataclasses.asdict(cfg_j))
    tres = tfl.ransac_solve(T(p), T(q), T(thr), T(cvalid),
                            torch.Generator().manual_seed(3), cfg_t)
    assert bool(jres["converged"]) and bool(tres["converged"])
    assert float(tres["n_correspondences"]) == float(jres["n_correspondences"])
    Tj = np.asarray(jres["transformation"])
    Tt = tres["transformation"].numpy()
    for T4 in (Tj, Tt):
        np.testing.assert_allclose(T4[:3, :3], R, atol=2e-3)
        np.testing.assert_allclose(T4[:3, 3], t, atol=2e-2)
    # both refit on the same inlier set up to the draw
    assert abs(int(tres["inliers"]) - int(jres["inliers"])) <= 3


def test_config_from_jax_round_trip():
    jcfg = jfl.FlagshipConfig(rounds=8, hypothesis_batch=1024, use_iss=False,
                              match_tile=4096, metric="correspondences", degree_top=500)
    tcfg = tfl.config_from_jax(dataclasses.asdict(jcfg))
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


@pytest.mark.parametrize("change", [
    dict(masked_features=False),  # the unmasked ISS route
    dict(use_iss=False, descriptor="shot"),  # keypoint-any SHOT
    dict(use_iss=False, alignment="gror"),
    dict(alignment="gror"),  # GROR on the ISS routes
    dict(masked_features=False, descriptor="shot", alignment="gror"),
    dict(pyramid=True, scale_factor=1.5, pyramid_randomness=2),  # the staged pyramid
    dict(use_iss=False, pyramid=True),  # no pyramid without ISS: ignored, as in JAX
])
def test_config_from_jax_accepts_routes(change):
    """The staged envelope's settings (pipeline.py:151-166) convert field
    for field."""
    jcfg = jfl.FlagshipConfig(**change)
    tcfg = tfl.config_from_jax(dataclasses.asdict(jcfg))
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


@pytest.mark.parametrize("change", [
    dict(use_iss=False, bf16_matching=True),
    dict(descriptor="shot", lrf="gt"),  # ground-truth SHOT frames
    dict(use_iss=False, use_cell_fpfh=False),
])
def test_config_from_jax_refuses_other_routes(change):
    """The three settings the port refused before this slice (the bf16
    matcher, SHOT with lrf "gt", the grid-hash route) convert field by field
    and register a 2,048-point pair as the JAX package does, its cell
    kernels in interpret mode (LGR_CELL_FPFH=force).  Keypoint-any (the
    bench's pair; bf16 1-NN, or _side_stage + the full FPFH): both converge
    within 0.05 rad and 0.3 of the truth.  SHOT + gt on the ISS pair: SHOT
    takes its own LRF in both (flagship.py:465, 1169), which give the same
    correspondences (measured 174 of 174; the threshold 0.95 allows a
    near-tied descriptor 1-NN or two)."""
    from lidar_global_registration_tpu_torch.ops.transform import rotation_translation_error
    from test_torch_e2e_iss import pair_share, run_pair
    from test_torch_step import ANY, _any_inputs, _run

    jcfg = jfl.FlagshipConfig(**change)
    tcfg = tfl.config_from_jax(dataclasses.asdict(jcfg))
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    if change.get("descriptor") == "shot":
        runs = run_pair(n=2048, **change)
        assert "masked" in runs["tlog"] and "masked" in runs["jlog"]  # the same route
        jax_pairs, share = pair_share(runs)
        assert len(jax_pairs) > 100 and share >= 0.95, share
        outs, T_gt = (runs["jout"], runs["tout"]), runs["T_gt"]
    else:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("LGR_CELL_FPFH", "force")
            jout, tout, T_gt = _run("register_pair_staged", _any_inputs(), {**ANY, **change})
        outs = (jout, tout)
    for out in outs:
        r, t = (float(v) for v in rotation_translation_error(
            torch.as_tensor(np.asarray(out["transformation"])), torch.from_numpy(T_gt)))
        assert bool(out["converged"]) and r < 0.05 and t < 0.3, (change, r, t)


def test_config_defaults_equal_jax():
    """The port's defaults are the JAX package's for every field it reads,
    so the JAX default config (the ISS route) converts as it is."""
    jcfg = jfl.FlagshipConfig()
    tcfg = tfl.config_from_jax(dataclasses.asdict(jcfg))
    assert tcfg == tfl.FlagshipConfig()
    for f in dataclasses.fields(tfl.FlagshipConfig):
        assert getattr(tfl.FlagshipConfig(), f.name) == getattr(jcfg, f.name), f.name


@pytest.mark.parametrize("max_doublings", [8, 1])
def test_grid_density_equals_brute_force(rng, max_doublings):
    """The cell-list kNN (auto cell, doubling, exact finish of the rows
    left uncovered) equals a brute-force kNN; with one doubling allowed,
    the sparse outliers are finished against the whole cloud."""
    a, _b = _synthetic_pair(2500)
    far = rng.uniform(-200, 200, size=(40, 3)).astype(np.float32)  # sparse rows
    pts = T(np.concatenate([a, far]))
    k = 7
    dist, idx = tdensity.knn_nonself(pts, k, max_doublings=max_doublings)
    bd, bi = tdensity._knn_brute(pts, torch.arange(pts.shape[0]), k)
    np.testing.assert_array_equal(dist.numpy(), bd.numpy())
    # indices equal wherever the distance to the next neighbour is not a tie
    untied = (bd[:, 1:] > bd[:, :-1])
    assert torch.equal(idx[:, 0][untied[:, 0]], bi[:, 0][untied[:, 0]])


def test_uniformity_bins_and_entropy_match_jax(rng):
    p = rng.uniform(-10, 10, size=(900, 3)).astype(np.float32)
    p[:300, 2] *= 0.01  # a flat third: uneven projections
    lo, hi = p.min(0), p.max(0)
    jb = np.asarray(jmetrics.uniformity_bins(jnp.asarray(p), jnp.asarray(lo), jnp.asarray(hi)))
    tb = uniformity_bins(T(p), T(lo), T(hi)).numpy()
    np.testing.assert_array_equal(tb, jb)
    mask = rng.random((64, 900)) < rng.uniform(0.0, 0.9, size=(64, 1))
    mask[3] = False  # an empty hypothesis scores 0
    je = np.asarray(jmetrics.uniformity_entropy(jnp.asarray(mask), jnp.asarray(jb)))
    te = uniformity_entropy(T(mask), T(tb)).numpy()
    assert te[3] == 0.0 and je[3] == 0.0
    # the same counts; float32 log and cube root (cbrt in XLA, pow(1/3)
    # here) round apart in the last bits: measured up to 2.4e-7 absolute,
    # 3.4e-7 relatively
    np.testing.assert_allclose(te, je, rtol=1e-6, atol=0)


def test_ransac_solve_uniformity_matches_jax_pose(rng):
    p, q, thr, cvalid, R, t = _corr_set(rng, M=1500, inlier=0.5)
    cfg_j = jfl.FlagshipConfig(rounds=16, hypothesis_batch=512, use_iss=False,
                               metric="uniformity")
    jres = jfl._ransac_stage(jnp.asarray(p), jnp.asarray(q), jnp.asarray(thr),
                             jnp.asarray(cvalid), jax.random.PRNGKey(3), cfg_j)
    cfg_t = tfl.config_from_jax(dataclasses.asdict(cfg_j))
    assert cfg_t.metric == "uniformity"
    tres = tfl.ransac_solve(T(p), T(q), T(thr), T(cvalid),
                            torch.Generator().manual_seed(3), cfg_t)
    assert bool(jres["converged"]) and bool(tres["converged"])
    for T4 in (np.asarray(jres["transformation"]), tres["transformation"].numpy()):
        np.testing.assert_allclose(T4[:3, :3], R, atol=2e-3)
        np.testing.assert_allclose(T4[:3, 3], t, atol=2e-2)
    # the final metric is the entropy of the refit inliers, above the 0.3
    # min-tolerable gate in both.  The draws differ; measured: the same 682
    # refit inliers and entropies 0.7025329 / 0.7025328
    assert 0.3 < float(tres["metric"]) <= 1.0
    assert abs(float(tres["metric"]) - float(jres["metric"])) < 0.01
    assert abs(int(tres["inliers"]) - int(jres["inliers"])) <= 3


def test_ransac_uniformity_gate_rejects_a_clumped_pose(rng):
    """All inliers in one corner: the entropy stays below 0.3, so neither
    package converges and both return the identity."""
    p, q, thr, cvalid, R, t = _corr_set(rng, M=400, inlier=0.0)
    p[:60] = rng.uniform(0, 0.05, size=(60, 3)).astype(np.float32)
    q[:60] = (p[:60] @ R.T + t).astype(np.float32)
    cvalid[:] = True
    cfg_j = jfl.FlagshipConfig(rounds=4, hypothesis_batch=256, use_iss=False,
                               metric="uniformity")
    jres = jfl._ransac_stage(jnp.asarray(p), jnp.asarray(q), jnp.asarray(thr),
                             jnp.asarray(cvalid), jax.random.PRNGKey(1), cfg_j)
    tres = tfl.ransac_solve(T(p), T(q), T(thr), T(cvalid), torch.Generator().manual_seed(1),
                            tfl.config_from_jax(dataclasses.asdict(cfg_j)))
    assert not bool(jres["converged"]) and not bool(tres["converged"])
    np.testing.assert_array_equal(tres["transformation"].numpy(), np.eye(4, dtype=np.float32))
    np.testing.assert_array_equal(np.asarray(jres["transformation"]), np.eye(4))

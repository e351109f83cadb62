"""The host path's solvers of the PyTorch port against the JAX package's:
the metric context of the closest-plane metrics (weighted, combination,
sparse samples), one RANSAC round, the two refits, align_ransac and
align_gror, on a pair of samplings of a bumpy closed surface (the sphere of
tests/test_torch_analysis.py with a radial wave, so that a point-to-plane
fit fixes the rotation; the target cut to z > -2 and moved by T_GT) with
300 correspondences, 250 of them true, thresholds 0.15-0.45.  Every grid
of the JAX package holds all of its points there (asserted).

The two packages draw from different generators, so a round is compared
on JAX's own sample rows (the hypotheses_from_samples convention) and a
whole RANSAC run by its pose.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_global_registration_tpu import types as jtypes
from lidar_global_registration_tpu.models import gror as jgror
from lidar_global_registration_tpu.models import ransac as jransac
from lidar_global_registration_tpu_torch import types as ttypes
from lidar_global_registration_tpu_torch.models import gror as tgror
from lidar_global_registration_tpu_torch.models import ransac as transac
from lidar_global_registration_tpu.ops.density import _auto_cell_size
from lidar_global_registration_tpu.ops.normals import estimate_normals_knn as jnormals
from lidar_global_registration_tpu_torch.ops.transform import rotation_translation_error
from test_torch_analysis import T_EST, T_GT, TRANSFORMS, max_bucket, sphere

torch.set_num_threads(2)


def bumpy(seed: int, n: int = 3000) -> np.ndarray:
    u, _ = sphere(seed, n)
    u = u / np.linalg.norm(u, axis=1, keepdims=True)
    r = 5.0 + 0.6 * np.sin(3.0 * u[:, 0]) * np.cos(2.0 * u[:, 1])
    return (u * r[:, None]).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """Both packages' clouds (the JAX package's kNN normals given to both)
    and correspondences."""
    a = bumpy(11)
    b = bumpy(12)
    b = (b[b[:, 2] > -2.0] @ T_GT[:3, :3].T + T_GT[:3, 3]).astype(np.float32)
    rng = np.random.default_rng(13)
    q = rng.choice(len(a), 300, replace=False)
    moved = a[q] @ T_GT[:3, :3].T + T_GT[:3, 3]
    m = np.argmin(((moved[:, None, :] - b[None, :, :]) ** 2).sum(-1), 1)
    m[250:] = rng.integers(0, len(b), 50)
    thr = rng.uniform(0.15, 0.45, 300).astype(np.float32)
    cap = 384
    cols = [np.zeros(cap, np.int64), np.zeros(cap, np.int64), np.zeros(cap, np.float32),
            np.ones(cap, np.float32), np.zeros(cap, bool)]
    for c, v in zip(cols[:2] + cols[3:], (q, m, thr, True)):
        c[:300] = v
    out = dict(a=a, b=b)
    nrm = [np.array(jnormals(jtypes.Cloud.from_numpy(x), k=30).normal)[:len(x)] for x in (a, b)]
    for name, types, conv in (("jax", jtypes, jnp.asarray), ("port", ttypes, torch.from_numpy)):
        clouds = [types.Cloud.from_numpy(x, n) for x, n in zip((a, b), nrm)]
        corr = types.Correspondences(*(conv(v.astype(np.int32) if name == "jax" and
                                            v.dtype == np.int64 else v) for v in cols))
        out[name] = (*clouds, corr)
    return out


def test_scene_is_under_the_caps(pair):
    """The JAX package's closest-plane grid (2 x the target's density, 32 a
    cell) and its weights' kNN grid (64 a cell) hold every point."""
    ja, jb, _ = pair["jax"]
    cp = float(transac.cloud_density(pair["port"][1].xyz, pair["port"][1].valid))
    assert max_bucket(pair["b"], 2.0 * cp) <= 32
    assert max_bucket(pair["a"], _auto_cell_size(ja, 30)) <= 64


def _params(types, **kw):
    return types.AlignmentParameters(**{**dict(distance_thr=0.3, hypothesis_batch=128), **kw})


def _pose_err(T, ref):
    r, t = rotation_translation_error(torch.as_tensor(np.asarray(T, np.float32)),
                                      torch.as_tensor(np.asarray(ref, np.float32)))
    return float(r), float(t)


@pytest.mark.parametrize("metric,weight", [("combination", "constant"),
                                           ("weighted_closest_plane", "curvedness"),
                                           ("weighted_closest_plane", "nss")])
def test_metric_context_matches_jax(pair, metric, weight):
    """build_metric_context (every source point a sample) + _evaluate_one on
    three transforms: counts exact, metric and rmse within 1e-5."""
    ja, jb, jcorr = pair["jax"]
    ta, tb, tcorr = pair["port"]
    kw = dict(metric_id=metric, weight_id=weight)
    jctx = jransac.build_metric_context(ja, jb, jcorr, _params(jtypes, **kw), False)
    tctx = transac.build_metric_context(ta, tb, tcorr, _params(ttypes, **kw), False)
    assert tctx.cp_denom == pytest.approx(float(jctx.cp_denom), rel=1e-5)
    for name, T in TRANSFORMS.items():
        jm, ji, jr, jmask, js = jransac._evaluate_one(jctx, jnp.asarray(T))
        tm, ti, tr, tmask, ts = transac._evaluate_one(tctx, T)
        assert int(ti) == int(ji) and int(ts) == int(js), name
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        assert float(tm) == pytest.approx(float(jm), rel=1e-5, abs=1e-6), name
        assert float(tr) == pytest.approx(float(jr), rel=1e-5), name


def test_sparse_context_draws_from_the_generator(pair):
    """sparse=True: SPARSE_POINTS_FRACTION of the valid source rows, all
    distinct, drawn from the generator given (the same draw for the same
    seed), padded to a power of two with invalid samples; the denominator
    scaled by the fraction."""
    ta, tb, tcorr = pair["port"]
    p = _params(ttypes, metric_id="closest_plane")
    ctx = [transac.build_metric_context(ta, tb, tcorr, p, True,
                                        torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    n = int(ta.count())
    s = int(0.01 * n)
    for c in ctx:
        assert int(c.sample_valid.sum()) == s and c.sample_valid.shape[0] == 128
        rows = c.sample_xyz[c.sample_valid]
        assert torch.unique(rows, dim=0).shape[0] == s
        assert c.cp_denom == pytest.approx(0.01 * n)
    assert torch.equal(ctx[0].sample_xyz, ctx[1].sample_xyz)
    assert not torch.equal(ctx[0].sample_xyz, ctx[2].sample_xyz)


@pytest.mark.parametrize("metric", ["combination", "closest_plane", "correspondences"])
def test_ransac_round_on_jax_sample_rows(pair, metric):
    """One round of 128 hypotheses drawn by JAX's own key: the same
    prerejected count, the same best hypothesis and best metric (1e-5), the
    same best support."""
    ja, jb, jcorr = pair["jax"]
    ta, tb, tcorr = pair["port"]
    jctx = jransac.build_metric_context(ja, jb, jcorr, _params(jtypes, metric_id=metric), False)
    tctx = transac.build_metric_context(ta, tb, tcorr, _params(ttypes, metric_id=metric), False)
    key = jax.random.PRNGKey(7)
    n, B, S = 300, 128, 3
    jm, jR, jt, jsup, jok = jransac._ransac_round(jctx, key, jnp.int32(n), B, S, 0.95)
    rows = torch.from_numpy(np.asarray(jax.random.randint(key, (B, S), 0, n)).astype(np.int64))
    R, t, ok = transac.hypotheses_from_samples(tctx.p, tctx.q, rows, 0.95)
    metric_b, support = transac._ransac_round(tctx, R, t, ok)
    assert int(ok.sum()) == int(jok)
    assert int(support) == int(jsup)
    best = int(torch.argmax(metric_b))
    assert float(metric_b[best]) == pytest.approx(float(jm), rel=1e-5, abs=1e-7)
    np.testing.assert_allclose(R[best].numpy(), np.asarray(jR), rtol=0, atol=5e-5)
    np.testing.assert_allclose(t[best].numpy(), np.asarray(jt), rtol=0, atol=5e-5)


def test_combinations_or_max():
    for n, k in ((3, 3), (10, 3), (300, 3), (5000, 4), (10**6, 3)):
        assert transac.combinations_or_max(n, k) == jransac.combinations_or_max(n, k)


@pytest.mark.parametrize("metric", ["combination", "closest_plane", "weighted_closest_plane"])
def test_refits_match_jax(pair, metric):
    """_refit (Kabsch on the correspondence inliers of T_EST) and
    _closest_plane_refit (three rounds of nearest plane + Kabsch from
    T_EST) on the same context: poses within 2e-5 rad and 2e-5."""
    ja, jb, jcorr = pair["jax"]
    ta, tb, tcorr = pair["port"]
    kw = dict(metric_id=metric, weight_id="exp_curvature")
    jctx = jransac.build_metric_context(ja, jb, jcorr, _params(jtypes, **kw), False)
    tctx = transac.build_metric_context(ta, tb, tcorr, _params(ttypes, **kw), False)
    jmask = jransac._evaluate_one(jctx, jnp.asarray(T_EST))[3]
    tmask = transac._evaluate_one(tctx, T_EST)[3]
    assert torch.equal(tmask, torch.from_numpy(np.array(jmask)))
    Tj = np.asarray(jransac._refit(jctx, jmask))
    Tt = transac._refit(tctx, tmask).numpy()
    r, t = _pose_err(Tt, Tj)
    assert r < 2e-5 and t < 2e-5
    Tj = np.asarray(jransac._closest_plane_refit(jctx, jnp.asarray(T_EST)))
    Tt = transac._closest_plane_refit(tctx, torch.from_numpy(T_EST)).numpy()
    r, t = _pose_err(Tt, Tj)
    assert r < 2e-5 and t < 2e-5


@pytest.mark.parametrize("metric,r_tol,t_tol", [("combination", 0.01, 0.015),
                                                 ("weighted_closest_plane", 0.05, 0.05)])
def test_align_ransac_matches_jax(pair, metric, r_tol, t_tol):
    """align_ransac on the whole set: both converge; the port's pose within
    (r_tol rad, t_tol) of the GT and within twice that of JAX's.  The draws
    differ, so the poses do too: measured over the seeds 566, 1 and 2, the
    combination metric (Kabsch on the inliers) 0.0021-0.0066 rad and
    0.0039-0.0061 from the GT in the port, 0.0021-0.0039 rad and
    0.0031-0.0088 in JAX; the weighted metric (the closest-plane refit on
    30 samples) 0.012-0.036 rad and 0.009-0.018 against 0.014-0.035 rad and
    0.011-0.028."""
    ja, jb, jcorr = pair["jax"]
    ta, tb, tcorr = pair["port"]
    kw = dict(metric_id=metric, weight_id="exp_curvature")
    jres = jransac.align_ransac(ja, jb, jcorr, _params(jtypes, **kw))
    dbg = transac.RansacDebug()
    tres = transac.align_ransac(ta, tb, tcorr, _params(ttypes, **kw), debug=dbg)
    assert tres.converged and jres.converged
    assert tres.transformation.dtype == np.float32 and tres.transformation.shape == (4, 4)
    r, t = _pose_err(tres.transformation, T_GT)
    assert r < r_tol and t < t_tol, (r, t)
    r, t = _pose_err(tres.transformation, np.asarray(jres.transformation))
    assert r < 2 * r_tol and t < 2 * t_tol, (r, t)
    assert dbg.iterations == tres.iterations > 0 and dbg.rounds * 128 == dbg.iterations
    assert int(tres.correspondences.count()) == 300


def test_align_ransac_too_few_correspondences(pair):
    ta, tb, tcorr = pair["port"]
    few = ttypes.Correspondences(*(getattr(tcorr, f)[:8].clone() for f in
                                   ("query", "match", "distance", "threshold", "valid")))
    few.valid[2:] = False
    res = transac.align_ransac(ta, tb, few, _params(ttypes))
    assert not res.converged and res.iterations == 0
    np.testing.assert_array_equal(res.transformation, np.eye(4, dtype=np.float32))


def test_align_gror_matches_jax(pair):
    """align_gror over one correspondence set: the same inlier count,
    convergence and rounds, poses within 1e-4."""
    ja, jb, jcorr = pair["jax"]
    ta, tb, tcorr = pair["port"]
    jres = jgror.align_gror(ja, jb, jcorr, _params(jtypes))
    tres = tgror.align_gror(ta, tb, tcorr, _params(ttypes))
    assert tres.converged and jres.converged
    assert tres.metric == jres.metric and tres.iterations == jres.iterations
    r, t = _pose_err(tres.transformation, np.asarray(jres.transformation))
    assert r < 1e-4 and t < 1e-4
    assert _pose_err(tres.transformation, T_GT)[0] < 0.01

"""The PyTorch port's preprocessing, scoring and analysis against the JAX
package's: ops/downsample.voxel_downsample (+ Cloud.compact), the kNN
normals (ops/normals.estimate_normals_knn), cloud_density before and after
preprocessing, build_metric_context + _evaluate_one for the four metrics,
and AlignmentAnalysis.start with its test_results.csv row.

The port's neighbour queries are exact; the JAX package's keep at most
`cell_cap` points a grid cell (32 for the density and the closest-plane
metric, 64 for the normals and the analysis).  The scenes here are spheres
(no boundary, so JAX's first grid covers every row) whose cells stay under
those caps, which each test asserts with a count: there the two must agree.
"""
import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_global_registration_tpu import analysis as janalysis
from lidar_global_registration_tpu import types as jtypes
from lidar_global_registration_tpu.models import pipeline as jpipe
from lidar_global_registration_tpu.models import ransac as jransac
from lidar_global_registration_tpu.ops import grid as jgrid
from lidar_global_registration_tpu.ops.density import _auto_cell_size
from lidar_global_registration_tpu.ops.density import cloud_density as jdensity
from lidar_global_registration_tpu.ops.downsample import voxel_downsample as jvoxel
from lidar_global_registration_tpu.ops.normals import estimate_normals_knn as jnormals
from lidar_global_registration_tpu_torch import analysis as tanalysis
from lidar_global_registration_tpu_torch import types as ttypes
from lidar_global_registration_tpu_torch.models import pipeline as tpipe
from lidar_global_registration_tpu_torch.models import ransac as transac
from lidar_global_registration_tpu_torch.ops.density import cloud_density as tdensity
from lidar_global_registration_tpu_torch.ops.downsample import voxel_downsample as tvoxel
from lidar_global_registration_tpu_torch.ops.normals import estimate_normals_knn as tnormals

torch.set_num_threads(2)

N = 3000
RADIUS = 5.0


def _rot(ax, ang):
    c, s = np.cos(ang), np.sin(ang)
    i, j = [(1, 2), (2, 0), (0, 1)][ax]
    R = np.eye(3)
    R[i, i] = R[j, j] = c
    R[i, j], R[j, i] = -s, s
    return R


def sphere(seed: int, n: int = N, noise: float = 0.01):
    """A Fibonacci sphere of radius RADIUS, turned by a seeded rotation,
    with radial noise: (xyz f32[n, 3], unit normals f32[n, 3])."""
    rng = np.random.default_rng(seed)
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    u = np.stack([np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)], 1)
    u = u @ (_rot(0, rng.uniform(0, 3)) @ _rot(2, rng.uniform(0, 3))).T
    r = RADIUS + noise * rng.normal(size=(n, 1))
    return (u * r).astype(np.float32), u.astype(np.float32)


def max_bucket(xyz: np.ndarray, cell: float) -> int:
    """The most points in one bucket of the JAX package's hash grid
    (grid.build_grid: origin at the min - cell / 2, 2^18 hashed buckets)."""
    origin = xyz.min(0) - 0.5 * np.float32(cell)
    c = np.floor((xyz - origin) * (1.0 / np.float32(cell))).astype(np.int32)
    with np.errstate(over="ignore"):
        h = (c[:, 0] * np.int32(73856093)) ^ (c[:, 1] * np.int32(19349663)) ^ (
            c[:, 2] * np.int32(83492791))
    return int(np.bincount(h & ((1 << 18) - 1)).max())


def both(xyz, normal=None, weight=None):
    return (jtypes.Cloud.from_numpy(xyz, normal, weight),
            ttypes.Cloud.from_numpy(xyz, normal, weight))


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------
def test_voxel_downsample_matches_jax():
    """The same voxels in the same (z-major lexsort) order and count; equal
    summed weights; xyz within 4e-6 absolute (coordinates up to 5: JAX sums
    x * w in float32, the port residuals against the voxel corner in
    float64, measured 9.5e-7 here); normals within 1e-6."""
    xyz, nrm = sphere(1)
    w = np.random.default_rng(2).integers(1, 4, size=N).astype(np.float32)
    jc, tc = both(xyz, nrm, w)
    for voxel in (0.35, 0.8):
        jd, td = jvoxel(jc, voxel), tvoxel(tc, voxel)
        n = int(jd.count())
        assert int(td.count()) == n and 100 < n < N and td.capacity == jd.capacity
        np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
        np.testing.assert_array_equal(td.weight.numpy(), np.asarray(jd.weight))
        np.testing.assert_allclose(td.xyz.numpy()[:n], np.asarray(jd.xyz)[:n], rtol=0, atol=4e-6)
        np.testing.assert_allclose(td.normal.numpy(), np.asarray(jd.normal), rtol=0, atol=1e-6)
        assert (td.xyz.numpy()[n:] == ttypes.Cloud.PAD_COORD).all()
        jk, tk = jd.compact(), td.compact()
        assert tk.capacity == jk.capacity == ttypes.round_up(n)
        np.testing.assert_allclose(tk.xyz.numpy(), np.asarray(jk.xyz), rtol=0, atol=4e-6)
        np.testing.assert_array_equal(tk.weight.numpy(), np.asarray(jk.weight))
    # a voxel holding normals that cancel keeps the unnormalised mean
    x = np.zeros((2, 3), np.float32)
    n2 = np.array([[0, 0, 1], [0, 0, -1]], np.float32)
    jd, td = jvoxel(jtypes.Cloud.from_numpy(x, n2), 1.0), tvoxel(ttypes.Cloud.from_numpy(x, n2), 1.0)
    np.testing.assert_array_equal(td.normal.numpy(), np.asarray(jd.normal))


@pytest.fixture(scope="module")
def normals_run():
    xyz, _ = sphere(3)
    jc, tc = both(xyz)
    vp = np.array([0.5, -0.5, 0.25], np.float32)
    # JAX's grid loop (normals.estimate_normals_knn) ends at the first cell:
    # every row has its 30th neighbour within it, and no bucket overflows
    cell = _auto_cell_size(jc, 30)
    g = jgrid.build_grid(jc.xyz, jc.valid, cell, cell_cap=64)
    _i, dist, mask = jgrid.knn(g, jc.xyz, jc.valid, 30, cap=64)
    covered = int(np.sum(np.asarray(mask[:, 29]) & (np.asarray(dist[:, 29]) <= cell)))
    return dict(xyz=xyz, cell=cell, covered=covered, jax=jnormals(jc, k=30, viewpoint=vp),
                port=tnormals(tc, k=30, viewpoint=vp), **_port_eigs(tc))


def _port_eigs(tc):
    """The port's covariance eigenvalues, and the rows whose 30th and 31st
    neighbours lie at one float32 distance (either may be taken)."""
    from lidar_global_registration_tpu_torch.ops.eigen3 import eigvals_sym3
    from lidar_global_registration_tpu_torch.ops.grid import knn
    from lidar_global_registration_tpu_torch.ops.normals import covariance_from_neighbors

    idx, dist, mask = knn(tc.xyz, tc.valid, 31)
    eig = eigvals_sym3(covariance_from_neighbors(tc.xyz, idx[:, :30], mask[:, :30])[0])
    return dict(port_eig=eig.numpy(), tie=(dist[:, 29] == dist[:, 30]).numpy())


def test_normals_scene_is_under_the_cap(normals_run):
    assert normals_run["covered"] == N
    assert max_bucket(normals_run["xyz"], normals_run["cell"]) <= 64


def test_estimate_normals_knn_matches_jax(normals_run):
    """|dot| >= 1 - 1e-5 and the same sign where l1 - l0 >= 1e-2 l2 (the
    orientation is by the viewpoint); curvature within 2e-5 (the bound
    measured on the port's PCA in the first slice).  Rows whose 30th
    neighbour ties with the 31st in float32 (one row of this scene) may take
    the other point, and are left out."""
    j, t = normals_run["jax"], normals_run["port"]
    tie = normals_run["tie"][:N]
    assert tie.sum() <= 2
    nj, nt = np.asarray(j.normal)[:N][~tie], t.normal.numpy()[:N][~tie]
    dot = (nj * nt).sum(1)
    eig = normals_run["port_eig"][:N][~tie]
    well = eig[:, 1] - eig[:, 0] >= 1e-2 * eig[:, 2]
    assert well.mean() > 0.99
    assert np.abs(dot).min() >= 1 - 1e-5
    assert (dot[well] > 0).all()
    np.testing.assert_allclose(t.curvature.numpy()[:N][~tie], np.asarray(j.curvature)[:N][~tie],
                               rtol=0, atol=2e-5)
    assert np.abs(np.linalg.norm(nt, axis=1) - 1).max() < 1e-5
    np.testing.assert_array_equal(t.normal.numpy()[N:], 0.0)


def test_postprocess_with_file_normals_matches_jax():
    """File normals replace failed estimates and flip the estimates that
    disagree with them."""
    from lidar_global_registration_tpu.ops.normals import postprocess_normals as jpost
    from lidar_global_registration_tpu_torch.ops.normals import postprocess_normals as tpost

    rng = np.random.default_rng(9)
    nrm = rng.normal(size=(64, 3)).astype(np.float32)
    fn = rng.normal(size=(64, 3)).astype(np.float32)
    fn[::7] = 0.0
    ok = rng.uniform(size=64) < 0.7
    nrm[~ok] = 0.0
    curv = rng.uniform(size=64).astype(np.float32)
    for avail in (True, False):
        j = jpost(jnp.asarray(nrm), jnp.asarray(curv), jnp.asarray(ok), jnp.asarray(fn), avail)
        t = tpost(torch.from_numpy(nrm), torch.from_numpy(curv), torch.from_numpy(ok),
                  torch.from_numpy(fn), avail)
        np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=0, atol=1e-7)
        np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    # two points: no estimate (fewer than 3 neighbours), the file's normals
    xyz, nrm = sphere(4, n=2)
    t = tnormals(ttypes.Cloud.from_numpy(xyz, nrm), normals_available=True)
    np.testing.assert_allclose(t.normal.numpy()[:2], nrm, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(t.normal.numpy()[2:], 0.0)


@pytest.fixture(scope="module")
def preprocessed():
    """Both packages' preprocess_cloud on one sphere: the density, the fine
    voxel downsample at twice it and the kNN normals."""
    xyz, _ = sphere(5)
    jc, tc = both(xyz)
    vp = np.zeros(3, np.float32)
    return dict(xyz=xyz, jax=jpipe.preprocess_cloud(jc, vp),
                port=tpipe.preprocess_cloud(tc, vp), raw=(jdensity(jc), tdensity(tc.xyz, tc.valid)))


def test_cloud_density_matches_jax(preprocessed):
    """Within 1e-6 relative on the raw cloud and on the preprocessed one
    (the JAX package's rows given to both: the two downsamples differ in
    the last bits of xyz)."""
    jraw, traw = preprocessed["raw"]
    assert abs(traw - jraw) <= 1e-6 * jraw
    # JAX's density grid (k = 7 non-self, cap 32) stays under its cap
    jp = preprocessed["jax"]
    x = np.asarray(jp.xyz)[np.asarray(jp.valid)]
    assert max_bucket(preprocessed["xyz"], 2.0 * jraw) <= 32
    assert max_bucket(x, 2.0 * jraw) <= 32
    jd = jdensity(jp)
    td = tdensity(torch.from_numpy(x))
    assert abs(td - jd) <= 1e-6 * jd and jd > 1.5 * jraw


def test_preprocess_cloud_matches_jax(preprocessed):
    """The same rows in the same order (xyz within 4e-6), the same weights,
    normals |dot| >= 1 - 1e-4 (30 neighbours of the 2x-density cloud; the
    same set as JAX's) and of the same orientation on 99 % of the rows."""
    j, t = preprocessed["jax"], preprocessed["port"]
    n = int(j.count())
    assert int(t.count()) == n and t.capacity == j.capacity == ttypes.round_up(n)
    np.testing.assert_allclose(t.xyz.numpy(), np.asarray(j.xyz), rtol=0, atol=4e-6)
    np.testing.assert_array_equal(t.weight.numpy(), np.asarray(j.weight))
    dot = (t.normal.numpy()[:n] * np.asarray(j.normal)[:n]).sum(1)
    assert np.abs(dot).min() >= 1 - 1e-4 and (dot > 0).mean() >= 0.99


# ---------------------------------------------------------------------------
# scoring and analysis
# ---------------------------------------------------------------------------
def _transform(R, t):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, t
    return T


T_GT = _transform(_rot(2, 0.3) @ _rot(0, 0.1), [0.4, -0.3, 0.2])
T_EST = _transform(_rot(2, 0.302) @ _rot(0, 0.1), [0.41, -0.3, 0.19])


@pytest.fixture(scope="module")
def pair():
    """Source: a sphere; target: another sampling of it moved by T_GT and
    cut to z > -2 (a partial overlap); analytic normals; 300
    correspondences (250 true nearest pairs under T_GT, 50 random) with
    thresholds between 0.15 and 0.45."""
    a, na = sphere(11)
    b, nb = sphere(12)
    keep = b[:, 2] > -2.0
    b = (b[keep] @ T_GT[:3, :3].T + T_GT[:3, 3]).astype(np.float32)
    nb = (nb[keep] @ T_GT[:3, :3].T).astype(np.float32)
    rng = np.random.default_rng(13)
    q = rng.choice(N, 300, replace=False)
    moved = a[q] @ T_GT[:3, :3].T + T_GT[:3, 3]
    m = np.argmin(((moved[:, None, :] - b[None, :, :]) ** 2).sum(-1), 1)
    m[250:] = rng.integers(0, len(b), 50)
    thr = rng.uniform(0.15, 0.45, 300).astype(np.float32)
    cap = 384
    cq, cm = np.zeros(cap, np.int64), np.zeros(cap, np.int64)
    ct, cv = np.ones(cap, np.float32), np.zeros(cap, bool)
    cq[:300], cm[:300], ct[:300], cv[:300] = q, m, thr, True
    cd = np.zeros(cap, np.float32)
    jcorr = jtypes.Correspondences(*(jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
                                     for v in (cq, cm, cd, ct, cv)))
    tcorr = ttypes.Correspondences(*(torch.from_numpy(v) for v in (cq, cm, cd, ct, cv)))
    ja, ta = both(a, na)
    jb, tb = both(b, nb)
    return dict(a=a, b=b, jax=(ja, jb, jcorr), port=(ta, tb, tcorr))


METRICS = ["correspondences", "uniformity", "closest_plane", "combination"]
TRANSFORMS = {"gt": T_GT, "estimate": T_EST, "identity": np.eye(4, dtype=np.float32)}


@pytest.mark.parametrize("metric,score", [(m, "mse") for m in METRICS]
                         + [("correspondences", s) for s in ("constant", "mae", "exp")])
def test_evaluate_one_matches_jax(pair, metric, score):
    """Counts and masks exact, metric and rmse within 1e-5, over three
    transforms."""
    ja, jb, jcorr = pair["jax"]
    ta, tb, tcorr = pair["port"]
    jp = jtypes.AlignmentParameters(metric_id=metric, score_id=score)
    tp = ttypes.AlignmentParameters(metric_id=metric, score_id=score)
    jctx = jransac.build_metric_context(ja, jb, jcorr, jp, False)
    tctx = transac.build_metric_context(ta, tb, tcorr, tp, False)
    if metric in ("closest_plane", "combination"):
        assert tctx.cp_threshold == pytest.approx(float(jctx.cp_threshold), rel=1e-6)
        assert max_bucket(pair["b"], 2.0 * tctx.cp_threshold) <= 32
    for name, T in TRANSFORMS.items():
        jm, ji, jr, jmask, js = jransac._evaluate_one(jctx, jnp.asarray(T))
        tm, ti, tr, tmask, ts = transac._evaluate_one(tctx, T)
        assert int(ti) == int(ji) and int(ts) == int(js), name
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        assert float(tm) == pytest.approx(float(jm), rel=1e-5, abs=1e-6), name
        assert float(tr) == pytest.approx(float(jr), rel=1e-5), name
        if name == "gt":
            assert int(ti) > 100


def test_weighted_metric_raises(pair):
    """The weighted closest-plane metric builds its context (it raises no
    NotImplementedError) and scores as JAX's: each sample weighed by the
    source's exp_curvature weights, over their sum.  The weights' kNN (30,
    cap 64) holds every point of this sphere; counts and masks exact,
    metric within 1e-5."""
    ja, jb, jcorr = pair["jax"]
    ta, tb, tcorr = pair["port"]
    kw = dict(metric_id="weighted_closest_plane", weight_id="exp_curvature")
    jctx = jransac.build_metric_context(ja, jb, jcorr, jtypes.AlignmentParameters(**kw), False)
    tctx = transac.build_metric_context(ta, tb, tcorr, ttypes.AlignmentParameters(**kw), False)
    n = int(ta.count())
    np.testing.assert_allclose(tctx.cp_weights.numpy()[:n], np.asarray(jctx.cp_weights)[:n],
                               rtol=1e-5, atol=1e-7)
    assert tctx.cp_denom == pytest.approx(float(jctx.cp_denom), rel=1e-5)
    for name, T in TRANSFORMS.items():
        jm, ji, jr, _jmask, js = jransac._evaluate_one(jctx, jnp.asarray(T))
        tm, ti, tr, _tmask, ts = transac._evaluate_one(tctx, T)
        assert int(ti) == int(ji) and int(ts) == int(js), name
        assert float(tm) == pytest.approx(float(jm), rel=1e-5, abs=1e-6), name
        assert float(tr) == pytest.approx(float(jr), rel=1e-5), name


@pytest.fixture(scope="module")
def analyses(pair, tmp_path_factory):
    out = {}
    for name, types, mod, T in (("jax", jtypes, janalysis, T_EST),
                                ("port", ttypes, tanalysis, T_EST)):
        src, tgt, corrs = pair[name]
        d = tmp_path_factory.mktemp(name)
        params = types.AlignmentParameters(
            distance_thr=0.3, descriptor_id="fpfh", keypoint_id="any", matching_id="lr",
            metric_id="correspondences", feature_radius=1.5, iss_radius_src=0.6,
            iss_radius_tgt=0.7, dir_path=str(d), testname="sphere_pair")
        res = types.AlignmentResult(src=src, tgt=tgt, transformation=T, correspondences=corrs,
                                    iterations=321, converged=True, time_te=0.5, time_cs=0.0,
                                    metric=0.1)
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            a = mod.AlignmentAnalysis(res, params).start(T_GT, "sphere_pair")
        out[name] = dict(a=a, log=log.getvalue(), csv=(d / "test_results.csv").read_text())
    return out


INT_FIELDS = ("n_inliers", "n_correct_inliers", "n_correspondences", "n_correct_correspondences")
FLOAT_FIELDS = {"metric": 1e-6, "rmse": 1e-6, "r_error": 1e-6, "t_error": 1e-6,
                "pcd_error": 1e-6, "overlap_error": 1e-5, "normal_diff": 1e-5,
                "corr_uniformity": 1e-6, "overlap": 0.0, "overlap_area": 1e-5}


def test_analysis_scene_is_under_the_cap(pair):
    """JAX's analysis grids (cells of 2 x 0.3 and 0.3, cap 64) and its
    density grid (cap 32) hold every point."""
    for x in (pair["a"] @ T_GT[:3, :3].T + T_GT[:3, 3], pair["b"]):
        assert max_bucket(x.astype(np.float32), 0.6) <= 64
        assert max_bucket(x.astype(np.float32), 0.3) <= 64


def test_alignment_analysis_matches_jax(analyses):
    """Every field: the integers exact, the floats within the absolute
    bounds of FLOAT_FIELDS (float32 sums in another order; the median angle
    goes through acos near 1)."""
    j, t = analyses["jax"]["a"], analyses["port"]["a"]
    for f in INT_FIELDS:
        assert getattr(t, f) == getattr(j, f), f
    assert j.n_correct_correspondences >= 150 and j.n_inliers > 150
    for f, tol in FLOAT_FIELDS.items():
        assert getattr(t, f) == pytest.approx(getattr(j, f), rel=0, abs=tol), f
    assert 0.5 < t.overlap < 1.0 and t.overlap_area > 0.2
    assert t.running_time() == j.running_time() == 0.5


def test_report_and_csv_match_jax(analyses):
    """The same report lines (labels; integers exact) and the same
    test_results.csv header and non-float columns; float columns within
    the bounds above, once formatted with %g."""
    jl = analyses["jax"]["log"].splitlines()
    tl = analyses["port"]["log"].splitlines()
    assert len(tl) == len(jl) > 15
    for a, b in zip(tl, jl):
        assert a.split(":")[0] == b.split(":")[0]
        if a.startswith(("converged", "correct ")):
            assert a == b
    (jh, jr), (th, tr) = (analyses[k]["csv"].splitlines() for k in ("jax", "port"))
    assert th == jh == janalysis.AlignmentAnalysis.HEADER.strip()
    assert len(th.split(",")) == 38
    floats = {"metric", "rmse", "r_err", "t_err", "pcd_err", "normal_diff", "corr_uniformity",
              "overlap_rmse", "overlap", "overlap_area"}
    for col, a, b in zip(th.split(","), tr.split(","), jr.split(",")):
        if col in floats:
            assert float(a) == pytest.approx(float(b), rel=1e-5, abs=1e-5), col
        else:
            assert a == b, col

"""Parity: GROR's own preprocessing (models/gror.gror_preparation) and the
multi-hypothesis pool (models/hypotheses.py) of the PyTorch port against
the JAX package's.

The pair is the ISS fixture of tests/test_torch_e2e_iss.py at 4,096 points
a side, prepared at resolution 0.2: voxel downsample, kNN-30 normals, ISS
at 0.4 (no cell of 0.4 holds more than 8 points, no point more than 17
neighbours: under the JAX fallback's caps of 32 and 64), FPFH at 1.6 (at
most 62 points a cell and 184 neighbours: under 128 and 384).  On the CPU
the port runs K2-K5's and K7's plain versions.
"""
import contextlib
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_global_registration_tpu import types as jtypes
from lidar_global_registration_tpu.models import gror as jgror
from lidar_global_registration_tpu.models import hypotheses as jhyp
from lidar_global_registration_tpu_torch import types as ttypes
from lidar_global_registration_tpu_torch.models import gror as tgror
from lidar_global_registration_tpu_torch.models import hypotheses as thyp
from lidar_global_registration_tpu_torch.ops.iss import detect_keypoints
from test_torch_e2e_iss import _errors, pair_inputs

torch.set_num_threads(2)

RES = 0.2


def _gt():
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.3), np.sin(0.3)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[:3, 3] = [1.5, -0.8, 0.2]
    return T


def _turn(T, angle, shift):
    c, s = np.cos(angle), np.sin(angle)
    D = np.eye(4, dtype=np.float32)
    D[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    D[:3, 3] = shift
    return (D @ T).astype(np.float32)


@pytest.fixture(scope="module")
def prep():
    a, b, _vp_a, _vp_b = pair_inputs()
    jout = jgror.gror_preparation(jtypes.Cloud.from_numpy(a), jtypes.Cloud.from_numpy(b), RES)
    tout = tgror.gror_preparation(ttypes.Cloud.from_numpy(a), ttypes.Cloud.from_numpy(b), RES)
    return dict(jax=jout, port=tout)


def _pairs(c):
    v = np.asarray(c.valid)
    return set(zip(np.asarray(c.query)[v].tolist(), np.asarray(c.match)[v].tolist()))


def _pca_normals(x: np.ndarray, k: int = 30) -> np.ndarray:
    """Brute-force float64 kNN-k PCA normals, turned towards the origin."""
    x = x.astype(np.float64)
    nb = np.argsort(((x[None] - x[:, None]) ** 2).sum(-1), 1)[:, :k]
    out = np.empty_like(x)
    for i in range(len(x)):
        p = x[nb[i]]
        n = np.linalg.eigh(np.cov((p - p.mean(0)).T, bias=True))[1][:, 0]
        out[i] = -n if n @ -x[i] < 0 else n
    return out


def test_downsampled_clouds_and_normals_match_jax(prep):
    """The same voxel centroids (the port sums in float64: within 1e-6);
    the port's kNN-30 normals are the brute-force ones on both sides (|dot|
    within 1e-4 of 1), and the JAX package's equal the port's on the source.
    On the target its grid kNN misses true neighbours (the logged deviation
    of its capped queries): measured 247 of 2,123 normals off the brute
    force there, the port's none."""
    for side, (jc, tc) in enumerate(zip(prep["jax"][:2], prep["port"][:2])):
        jv, tv = np.asarray(jc.valid), tc.valid.numpy()
        np.testing.assert_array_equal(tv, jv)
        x = tc.xyz.numpy()[tv]
        np.testing.assert_allclose(x, np.asarray(jc.xyz)[jv], rtol=0, atol=1e-6)
        tn = tc.normal.numpy()[tv]
        assert ((tn * _pca_normals(x)).sum(1) > 1 - 1e-4).all()
        if side == 0:
            assert ((tn * np.asarray(jc.normal)[jv]).sum(1) > 1 - 1e-5).all()


def test_keypoints_and_correspondences_match_jax(prep):
    """The ISS keypoints at 2 x resolution are equal (measured 141 of 141 on
    the source), and the mutual 1-NN pairs mostly shared: the JAX package's
    FPFH combine gathers the neighbours' SPFH in bfloat16 (up to 0.081 of
    100, tests/test_torch_host_ops.py), which moves near-tied 1-NN matches (measured 38
    of 46 pairs shared).  Every pair's threshold is 2 x resolution, its
    rows are keypoints of the downsampled clouds."""
    (js, _jt, jc), (ts, tt, tc) = prep["jax"], prep["port"]
    kp = detect_keypoints(ts, "iss", 2 * RES).numpy()
    from lidar_global_registration_tpu.ops.iss import detect_keypoints as jdetect
    np.testing.assert_array_equal(kp, np.asarray(jdetect(js, "iss", 2 * RES)))
    jp, tp = _pairs(jc), _pairs(tc)
    assert len(tp) > 30 and abs(len(tp) - len(jp)) <= 0.2 * len(jp)
    assert len(jp & tp) >= 0.75 * len(jp), (len(jp), len(tp), len(jp & tp))
    v = tc.valid.numpy()
    assert tc.capacity == ttypes.round_up(int(v.sum()))
    np.testing.assert_array_equal(tc.threshold.numpy(), np.float32(2 * RES))
    assert set(tc.query.numpy()[v]) <= set(kp)
    assert (tc.distance.numpy()[v] >= 0).all()


def test_gror_on_the_prepared_sets_matches_jax(prep):
    """align_gror over each package's prepared set, resolution = distance_thr
    = 2 x RES: both converge to the truth within 0.05 rad and 0.3, and to
    each other."""
    out = {}
    for name, mod, types in (("jax", jgror, jtypes), ("port", tgror, ttypes)):
        src, tgt, corrs = prep[name]
        params = types.AlignmentParameters(distance_thr=2 * RES)
        out[name] = mod.align_gror(src, tgt, corrs, params)
    for res in out.values():
        r, t = _errors(np.asarray(res.transformation), _gt())
        assert res.converged and r < 0.05 and t < 0.3, (r, t)
    r, t = _errors(out["port"].transformation, np.asarray(out["jax"].transformation))
    assert r < 0.05 and t < 0.3, (r, t)


def test_update_hypotheses_matches_jax():
    """The pool after the same sequence of hypotheses: a similar better one
    replaces, a similar worse one is dropped, a new best prunes those under
    0.1 x its metric; equal transforms and metrics in both packages."""
    T = _gt()
    seq = [(T, 0.5), (_turn(T, 0.05, [0.1, 0, 0]), 0.6), (_turn(T, 0.05, [0.0, 0.1, 0]), 0.4),
           (_turn(T, 1.0, [5, 0, 0]), 0.3), (_turn(T, -1.2, [0, 9, 0]), 0.03),
           (_turn(T, 2.0, [0, 0, 9]), 7.0), (_turn(T, -2.5, [9, 9, 0]), 0.9)]
    pools = {}
    for name, mod, types in (("jax", jhyp, jtypes), ("port", thyp, ttypes)):
        tns, metrics = [], []
        params = types.AlignmentParameters(distance_thr=0.5)
        for Tn, m in seq:
            mod.update_hypotheses(tns, metrics, Tn, m, params)
        pools[name] = (tns, metrics)
    (jt, jm), (tt, tm) = pools["jax"], pools["port"]
    assert tm == jm == [7.0, 0.9]
    for a, b in zip(tt, jt):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_choose_best_hypothesis_matches_jax(prep, tmp_path, monkeypatch):
    """A pool of the truth and two turned poses over the port's prepared
    correspondences: the truth wins in both packages (the most uniform
    inliers), and the two test_hypotheses.csv files hold the same rows
    (the gt row first): ids, errors and inlier counts equal, the metric and
    uniformity within 1e-5, areas and overlap counts within 2 % (the JAX
    package's density and overlap queries keep 32 and 64 points a cell, the
    port's are exact)."""
    monkeypatch.chdir(tmp_path)
    T = _gt()
    pool = [_turn(T, 0.08, [0.3, 0, 0]), T, _turn(T, -0.1, [0, 0.4, 0])]
    src, tgt, corrs = prep["port"]
    jsrc, jtgt = (jtypes.Cloud.from_numpy(c.xyz.numpy(), c.normal.numpy()) for c in (src, tgt))
    jsrc = jsrc.__class__(**{**jsrc.__dict__, "valid": jnp.asarray(src.valid.numpy())})
    jtgt = jtgt.__class__(**{**jtgt.__dict__, "valid": jnp.asarray(tgt.valid.numpy())})
    jcorrs = jtypes.Correspondences(**{k: jnp.asarray(getattr(corrs, k).numpy().astype(
        np.int32) if k in ("query", "match") else getattr(corrs, k).numpy())
        for k in ("query", "match", "distance", "threshold", "valid")})
    rows = {}
    for name, mod, types, args in (("jax", jhyp, jtypes, (jsrc, jtgt, jcorrs)),
                                   ("port", thyp, ttypes, (src, tgt, corrs))):
        params = types.AlignmentParameters(distance_thr=2 * RES, ground_truth=T,
                                           testname="pair")
        best = mod.choose_best_hypothesis(*args, params, pool)
        np.testing.assert_array_equal(np.asarray(best), T)
        path = os.path.join("data", "debug", "test_hypotheses.csv")
        rows[name] = open(path).read().strip().splitlines()
        os.rename(path, path + "." + name)
    assert rows["port"][0] == rows["jax"][0] == thyp.CSV_HEADER.strip()
    assert len(rows["port"]) == len(rows["jax"]) == 5
    for tl, jl in zip(rows["port"][1:], rows["jax"][1:]):
        t, j = tl.split(","), jl.split(",")
        assert t[:2] == j[:2] and t[4] == j[4], (t, j)
        for c in (2, 3, 5, 7):
            assert abs(float(t[c]) - float(j[c])) <= 1e-5 * max(1.0, abs(float(j[c]))), (c, t, j)
        for c in (6, 8, 9):
            assert abs(float(t[c]) - float(j[c])) <= 0.02 * abs(float(j[c])) + 1e-6, (c, t, j)
    assert [ln.split(",")[1] for ln in rows["port"][1:]] == ["gt", "1", "2", "3"]
    assert thyp.choose_best_hypothesis(src, tgt, corrs, ttypes.AlignmentParameters(), [],
                                       save_csv=False).tolist() == np.eye(4).tolist()

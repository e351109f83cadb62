"""Parity: the ops of the PyTorch port's host path against the JAX
package's: ISS keypoints (ops/iss.py), the kNN of positions on another
cloud with the surface= form of the normals, FPFH at keypoints
(ops/fpfh.py) and the seven weight functions (ops/weights.py).

On the CPU the port runs the plain versions of its CUDA kernels (K2-K4 for
ISS, K5 for the surface SPFH).  The port's neighbour sets are exact; the
JAX package's XLA fallbacks keep a capped number of points a grid cell
(ISS 32, FPFH 128, the weights' and normals' kNN 64) and of neighbours a
point (ISS 64, FPFH 384).  Each scene here keeps under those caps, which
the tests assert with counts: there the two must agree.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_global_registration_tpu import types as jtypes
from lidar_global_registration_tpu.ops import fpfh as jfpfh
from lidar_global_registration_tpu.ops import grid as jgrid
from lidar_global_registration_tpu.ops import iss as jiss
from lidar_global_registration_tpu.ops import weights as jweights
from lidar_global_registration_tpu.ops.density import _auto_cell_size
from lidar_global_registration_tpu.ops.normals import estimate_normals_knn as jnormals
from lidar_global_registration_tpu.ops.pallas import cellgrid as jcg
from lidar_global_registration_tpu_torch import types as ttypes
from lidar_global_registration_tpu_torch.ops import cellgrid as tcg
from lidar_global_registration_tpu_torch.ops import fpfh as tfpfh
from lidar_global_registration_tpu_torch.ops import iss as tiss
from lidar_global_registration_tpu_torch.ops import weights as tweights
from lidar_global_registration_tpu_torch.ops.grid import knn as tknn
from lidar_global_registration_tpu_torch.ops.normals import estimate_normals_knn as tnormals
from test_cell_iss import _boxy_cloud
from test_torch_analysis import max_bucket, sphere

torch.set_num_threads(2)

ISS_RADIUS = 0.35


@pytest.fixture(scope="module")
def box():
    """The ground + box scene of tests/test_cell_iss.py, thinned so that no
    cell and no neighbourhood reaches the JAX fallback's caps."""
    pts = _boxy_cloud(np.random.default_rng(566), n_ground=2000, n_box=600)
    n = len(pts)
    pad = 1 << (n - 1).bit_length()
    xyz = np.zeros((pad, 3), np.float32)
    xyz[:n] = pts
    valid = np.arange(pad) < n
    tc = ttypes.Cloud.from_numpy(pts)
    plan = tcg.plan_grid(tc.xyz, tc.valid, ISS_RADIUS)
    count = tcg.iss_count_plain(plan, tcg._f32_square(ISS_RADIUS))[0]
    return dict(pts=pts, xyz=xyz, valid=valid, port=tc, count=count.numpy(),
                kp=tiss.detect_keypoints(tc, "iss", ISS_RADIUS).numpy())


def test_iss_keypoints_match_the_cell_kernels(box):
    """The keypoints of ops/iss.detect_keypoints are the JAX package's
    accelerator route (iss_cells, Pallas in interpret mode, planned as its
    host path plans it): the same rows, ascending."""
    jkp, _ = jcg.iss_cells(jnp.asarray(box["xyz"]), jnp.asarray(box["valid"]), ISS_RADIUS,
                           interpret=True)
    want = np.nonzero(np.asarray(jkp) & box["valid"])[0]
    assert len(want) > 50
    np.testing.assert_array_equal(box["kp"], want)


def test_iss_keypoints_match_the_capped_fallback_under_its_caps(box):
    """Against the JAX package's XLA fallback (32 points a cell, 64
    neighbours), which its CPU host path runs: on this scene no cell and no
    neighbourhood reaches a cap, and the keypoints are the same."""
    assert max_bucket(box["pts"], ISS_RADIUS) <= 32
    assert box["count"].max() - 1 <= 64  # K2 counts the point itself
    is_kp, _sal = jiss.iss_keypoints(jtypes.Cloud.from_numpy(box["pts"]), ISS_RADIUS)
    want = np.nonzero(np.asarray(is_kp))[0]
    np.testing.assert_array_equal(box["kp"], want)
    assert np.array_equal(tiss.detect_keypoints(box["port"], "any", ISS_RADIUS).numpy(),
                          np.arange(len(box["pts"])))


def test_knn_of_positions_equals_brute_force():
    """grid.knn with queries: the k nearest cloud points of positions off
    the cloud (and of the cloud's own points, found at distance 0), as a
    brute-force kNN finds them, through the cell passes and the finish of
    far queries."""
    rng = np.random.default_rng(3)
    surf = rng.uniform(0, 10, size=(3000, 3)).astype(np.float32)
    surf[:, 2] *= 0.05
    q = np.concatenate([rng.uniform(0, 10, size=(400, 3)), surf[:50],
                        rng.uniform(-300, 300, size=(10, 3))]).astype(np.float32)
    valid = np.ones(len(surf), bool)
    valid[::7] = False
    qvalid = np.ones(len(q), bool)
    qvalid[5] = False
    k = 9
    idx, dist, mask = tknn(torch.from_numpy(surf), torch.from_numpy(valid), k,
                           queries=torch.from_numpy(q), qvalid=torch.from_numpy(qvalid))
    rows = np.nonzero(valid)[0]
    d = surf[rows][None, :, :] - q[:, None, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    want = np.sqrt(np.sort(d2, 1)[:, :k])
    assert not mask[5].any() and mask[qvalid].all()
    np.testing.assert_allclose(dist.numpy()[qvalid], want[qvalid], rtol=1e-6, atol=1e-6)
    first = rows[np.argsort(d2, 1, kind="stable")[:, 0]]
    untied = np.diff(np.sort(d2, 1)[:, :2], axis=1)[:, 0] > 1e-6
    sel = qvalid & untied
    np.testing.assert_array_equal(idx.numpy()[sel, 0], first[sel])
    assert (dist.numpy()[400:450][valid[:50], 0] == 0).all()


def test_normals_on_another_surface_match_jax():
    """estimate_normals_knn(cloud, surface=...) (the pyramid's keypoint
    normals on a level surface): 200 points of one sampling of a sphere,
    with normals of either sign as their own, against 3,000 points of
    another; 30 neighbours on the surface, oriented by the points' own
    normals.  |dot| >= 1 - 1e-5, the same orientation, curvature within
    2e-5 (as the self form's test); JAX's surface grid holds every point."""
    surf, _ = sphere(21)
    q, nq = sphere(22, n=200)
    nq = nq * np.where(np.random.default_rng(1).uniform(size=(200, 1)) < 0.5, -1, 1)
    js = jtypes.Cloud.from_numpy(surf)
    cell = _auto_cell_size(js, 30)
    assert max_bucket(surf, cell) <= 64
    vp = np.zeros(3, np.float32)
    j = jnormals(jtypes.Cloud.from_numpy(q, nq), surface=js, k=30, viewpoint=vp,
                 normals_available=True)
    t = tnormals(ttypes.Cloud.from_numpy(q, nq), surface=ttypes.Cloud.from_numpy(surf), k=30,
                 viewpoint=vp, normals_available=True)
    nj, nt = np.asarray(j.normal)[:200], t.normal.numpy()[:200]
    dot = (nj * nt).sum(1)
    assert dot.min() >= 1 - 1e-5
    assert ((nt * nq).sum(1) >= 0).all()
    np.testing.assert_allclose(t.curvature.numpy()[:200], np.asarray(j.curvature)[:200],
                               rtol=0, atol=2e-5)


FPFH_RADIUS = 1.5


@pytest.fixture(scope="module")
def fpfh_run():
    """FPFH of 150 keypoints (points of another sampling of the sphere) over
    a 3,000-point sphere with analytic normals, both packages."""
    surf, ns = sphere(31)
    kp, nk = sphere(32, n=150)
    tk = tfpfh.fpfh(torch.from_numpy(kp), torch.ones(150, dtype=torch.bool),
                    torch.from_numpy(surf), torch.from_numpy(ns),
                    torch.ones(len(surf), dtype=torch.bool), FPFH_RADIUS,
                    kp_normal=torch.from_numpy(nk))
    jk = jfpfh.fpfh(jnp.asarray(kp), jnp.ones(150, bool), jnp.asarray(surf), jnp.asarray(ns),
                    jnp.ones(len(surf), bool), FPFH_RADIUS, kp_normal=jnp.asarray(nk),
                    approx=False)
    return dict(surf=surf, kp=kp, port=[v.numpy() for v in tk], jax=[np.asarray(v) for v in jk])


def test_fpfh_scene_is_under_the_caps(fpfh_run):
    surf, kp = fpfh_run["surf"], fpfh_run["kp"]
    assert max_bucket(surf, FPFH_RADIUS) <= 128
    d2 = ((surf[None, :, :] - surf[:, None, :]) ** 2).sum(-1)
    assert (d2 <= FPFH_RADIUS ** 2).sum(1).max() - 1 <= 384
    d2k = ((surf[None, :, :] - kp[:, None, :]) ** 2).sum(-1)
    assert (d2k <= FPFH_RADIUS ** 2).sum(1).min() > 20


def test_fpfh_matches_jax(fpfh_run):
    """The same valid rows; histograms (100 a block) within 0.15, 0.005 on
    average.  The JAX package gathers the neighbours' SPFH in bfloat16 and
    sums at bfloat16 input (8 mantissa bits: up to 0.4 % of a bin), the
    port in float32; its surface SPFH is K5's arithmetic (centred
    coordinates, atan2f) where JAX's is the XLA pair features, which can
    move a pair on a bin edge.  Measured here: 0.081 at most, 0.0018 on
    average."""
    (tf, tv), (jf, jv) = fpfh_run["port"], fpfh_run["jax"]
    np.testing.assert_array_equal(tv, jv)
    assert tv.all()
    diff = np.abs(tf - jf)
    assert diff.max() < 0.15 and diff.mean() < 0.005, (diff.max(), diff.mean())
    np.testing.assert_allclose(tf.reshape(-1, 3, 11).sum(-1), 100.0, rtol=1e-5)


def test_fpfh_pieces_match_jax():
    """pair_features and the SPFH of neighbour lists (query rows given) as
    the JAX functions, on random pairs: equal bins, features within
    1e-5."""
    rng = np.random.default_rng(5)
    p1, p2 = rng.normal(size=(2, 500, 3)).astype(np.float32)
    n1, n2 = rng.normal(size=(2, 500, 3)).astype(np.float32)
    n1 /= np.linalg.norm(n1, axis=1, keepdims=True)
    n2 /= np.linalg.norm(n2, axis=1, keepdims=True)
    tf = [v.numpy() for v in tfpfh.pair_features(*(torch.from_numpy(x) for x in (p1, n1, p2, n2)))]
    jf = [np.asarray(v) for v in jfpfh.pair_features(*(jnp.asarray(x) for x in (p1, n1, p2, n2)))]
    np.testing.assert_array_equal(tf[3], jf[3])
    for a, b in zip(tf[:3], jf[:3]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    xyz = rng.normal(size=(300, 3)).astype(np.float32)
    idx = rng.integers(0, 300, size=(40, 24))
    mask = rng.uniform(size=(40, 24)) < 0.8
    q, qn = xyz[:40] + 0.01, n1[:40]
    nrm = n2[:300]
    ts = tfpfh.spfh(torch.from_numpy(xyz), torch.from_numpy(nrm), torch.from_numpy(idx),
                    torch.from_numpy(mask), torch.from_numpy(q), torch.from_numpy(qn)).numpy()
    js = np.asarray(jfpfh.spfh(jnp.asarray(xyz), jnp.asarray(nrm), jnp.asarray(idx),
                               jnp.asarray(mask), jnp.asarray(q), jnp.asarray(qn)))
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def weight_cloud():
    """A bumpy closed surface of 2,500 points (the sphere with a radial
    wave: no boundary, so every row has its neighbours around it, and its
    curvature varies), with the JAX package's kNN normals given to both
    packages."""
    u, _ = sphere(41, n=2500)
    u = u / np.linalg.norm(u, axis=1, keepdims=True)
    r = 5.0 + 0.6 * np.sin(3.0 * u[:, 0]) * np.cos(2.0 * u[:, 1])
    xyz = (u * r[:, None]).astype(np.float32)
    jc = jnormals(jtypes.Cloud.from_numpy(xyz), k=30, viewpoint=np.zeros(3))
    nrm, curv = np.array(jc.normal)[:2500], np.array(jc.curvature)[:2500]
    tc = ttypes.Cloud.from_numpy(xyz, nrm)
    tc.curvature[:2500] = torch.from_numpy(curv)
    return dict(xyz=xyz, jax=jc, port=tc)


@pytest.mark.parametrize("weight_id,rtol,atol", [
    ("constant", 0, 0), ("exp_curvature", 1e-6, 1e-7), ("curvedness", 0, 5e-7),
    ("harris", 0, 1e-7), ("tomasi", 0, 5e-5), ("curvature", 0, 0), ("nss", 0, 0)])
def test_weight_function_matches_jax(weight_cloud, weight_id, rtol, atol):
    """Every weight id over one kNN of 30 (JAX's cell list holds every
    point: its first cell covers every row, no bucket over 64).  The
    covariances are summed elementwise in the port and by a HIGHEST
    precision einsum in JAX, then go through the same float32 closed-form
    eigenvalues.  Measured: exp_curvature 1.4e-7 relative, curvedness and
    harris 1.2e-7 and 3e-8 absolute; tomasi (the smallest eigenvalue of
    the normals' covariance, up to 0.024 here) 3.3e-5 absolute, where its
    two smaller eigenvalues nearly coincide and the closed form's acos
    magnifies the last bits of the sums."""
    jc, tc = weight_cloud["jax"], weight_cloud["port"]
    cell = _auto_cell_size(jc, 30)
    g = jgrid.build_grid(jc.xyz, jc.valid, cell, cell_cap=64)
    _i, dist, mask = jgrid.knn(g, jc.xyz, jc.valid, 30, cap=64)
    assert int(np.sum(np.asarray(mask[:, 29]) & (np.asarray(dist[:, 29]) <= cell))) == 2500
    assert max_bucket(weight_cloud["xyz"], cell) <= 64
    want = np.asarray(jweights.weight_function(weight_id, 30, jc))
    got = tweights.weight_function(weight_id, 30, tc).numpy()
    assert got.shape == want.shape and not got[2500:].any()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    if weight_id not in ("constant", "nss"):
        assert np.ptp(got[:2500]) > 0


def test_unknown_weight_warns_and_is_constant(weight_cloud):
    with pytest.warns(UserWarning, match="isn't supported"):
        w = tweights.weight_function("bogus", 30, weight_cloud["port"])
    np.testing.assert_array_equal(w.numpy(), weight_cloud["port"].valid.numpy().astype(np.float32))


def test_quantile_matches_jax():
    rng = np.random.default_rng(2)
    for n in (0, 1, 2, 7, 100):
        v = rng.uniform(size=n)
        a, b = tweights._quantile(v, 0.8), jweights._quantile(v, 0.8)
        assert (np.isnan(a) and np.isnan(b)) or a == b

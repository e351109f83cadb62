"""Parity: the PyTorch port's SHOT stage (ops/eigen3.py, ops/lrf.py, the
position radius query of ops/grid.py, ops/shot.py) against the JAX
package's XLA functions on the CPU, and SHOT against the numpy oracle of
tests/test_shot_oracle.py.

None of these is a Pallas kernel in the JAX package, so the port's are
plain PyTorch on every device.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_global_registration_tpu.ops import eigen3 as jeig
from lidar_global_registration_tpu.ops import grid as jgrid
from lidar_global_registration_tpu.ops import lrf as jlrf
from lidar_global_registration_tpu.ops import shot as jshot
from lidar_global_registration_tpu_torch.ops import cellgrid as cg
from lidar_global_registration_tpu_torch.ops import eigen3, grid, lrf, shot
from test_shot_oracle import _random_frame, shot_oracle_one
from test_torch_cellgrid import _bump_cloud

torch.set_num_threads(2)

T = torch.from_numpy
RADIUS = 1.0


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def support():
    """Bump terrain (2,048 points + 40 padding rows) with unit normals, and
    queries: 160 surface points, 60 points lifted off the surface and 4
    positions off the grid (one cell out, or far away)."""
    rng = np.random.default_rng(31)
    xyz, valid = _bump_cloud(2048, 40, rng)
    normal = _unit(rng.normal(size=xyz.shape) + np.array([0.0, 0.0, 2.0]))
    pick = rng.choice(2048, 220, replace=False)
    q = xyz[pick].copy()
    q[160:] += rng.normal(scale=0.2, size=(60, 3)).astype(np.float32)
    # off the grid: 0.7 left of the leftmost point (the cell before the
    # first), a corner, above the scene, far away
    edge = xyz[np.argmin(np.where(valid, xyz[:, 0], np.inf))] - np.array([0.7, 0.0, 0.0])
    far = np.array([edge, [12.5, 12.5, 0.2], [6.0, 6.0, 3.0], [40.0, -3.0, 1.0]], np.float32)
    q = np.concatenate([q, far]).astype(np.float32)
    qv = np.ones(len(q), bool)
    qv[5] = False
    return dict(xyz=xyz, valid=valid, normal=normal, q=q, qv=qv)


def _jax_neighbors(sup, k):
    """JAX's exact radius query with a cell cap that truncates nothing."""
    cap = 1024
    g = jgrid.build_grid(jnp.asarray(sup["xyz"]), jnp.asarray(sup["valid"]), RADIUS, cell_cap=cap)
    # every point kept (the last row is the spill row of the invalid ones)
    assert (np.asarray(g.cell_x)[:-cap] < 1e18).sum() == sup["valid"].sum()
    idx, dist, mask = (np.asarray(v) for v in jgrid.radius_neighbors(
        g, jnp.asarray(sup["q"]), jnp.asarray(sup["qv"]), RADIUS, k=k, cap=cap, approx=False))
    return idx, dist, mask


def test_eigh_sym3_matches_jax(rng):
    A = rng.normal(size=(400, 3, 3)).astype(np.float32)
    A = A @ np.swapaxes(A, 1, 2)
    A[:20] = np.diag([2.0, 2.0, 2.0])  # isotropic
    A[20:40] = np.diag([1.0, 3.0, 3.0]).astype(np.float32)  # a double eigenvalue
    A[40:50] = 0.0
    v = rng.normal(size=(10, 3)).astype(np.float32)
    A[50:60] = v[:, :, None] * v[:, None, :]  # rank 1
    je, jV = (np.asarray(x) for x in jeig.eigh_sym3(jnp.asarray(A)))
    te, tV = (x.numpy() for x in eigen3.eigh_sym3(T(A)))
    # the same closed form; acos and cos round apart in the last bits
    # (measured up to 2.4e-7 of the largest eigenvalue)
    scale = np.abs(A).max((1, 2), keepdims=True)[:, :, 0]
    np.testing.assert_allclose(te, je, rtol=0, atol=1e-6 * np.maximum(scale, 1e-30).max())
    np.testing.assert_array_equal(te[:60], je[:60])
    # eigenvectors: the same vectors, signs included, where the eigenvalues
    # are apart (measured 7.5e-7 at most); the isotropic, double and zero
    # rows take the same fallback axes exactly
    gap = np.minimum(np.diff(je, axis=1).min(1), 1.0) / np.maximum(scale[:, 0], 1e-30)
    sep = gap > 1e-3
    assert sep.sum() > 300
    np.testing.assert_allclose(tV[sep], jV[sep], rtol=0, atol=2e-5)
    np.testing.assert_array_equal(tV[:50], jV[:50])
    # rank 1: the same v2; v0 and v1 span the null space, where the cross
    # products of (near) parallel rows are rounding noise in either package
    np.testing.assert_allclose(tV[50:60, :, 2], jV[50:60, :, 2], rtol=0, atol=1e-6)
    eye = np.einsum("nji,njk->nik", tV[50:60], tV[50:60])
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape), atol=1e-5)


def test_gravity_lrf_matches_jax(rng):
    n = _unit(rng.normal(size=(500, 3)))
    n[:100] = _unit(np.column_stack([rng.normal(scale=0.03, size=(100, 2)), np.ones(100)]))
    n[100:110] = np.array([0.0, 0.0, 1.0], np.float32)  # exactly along gravity
    n[110:115] = 0.0  # rows without a normal
    jf, jfb = (np.asarray(x) for x in jlrf.gravity_lrf(jnp.asarray(n)))
    tf, tfb = (x.numpy() for x in lrf.gravity_lrf(T(n)))
    np.testing.assert_array_equal(tfb, jfb)
    assert 10 < tfb.sum() < 100
    # normalised cross products of the same inputs: ulps apart
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-6)


def test_shot_lrf_matches_jax(support):
    idx, _dist, mask = _jax_neighbors(support, 256)
    q = support["q"]
    jf, jok = (np.asarray(x) for x in jlrf.shot_lrf(
        jnp.asarray(q), jnp.float32(RADIUS), jnp.asarray(support["xyz"]), jnp.asarray(idx),
        jnp.asarray(mask)))
    tf, tok = (x.numpy() for x in lrf.shot_lrf(
        T(q), torch.tensor(RADIUS), T(support["xyz"]), T(idx).long(), T(mask)))
    np.testing.assert_array_equal(tok, jok)
    assert tok.sum() > 200
    # the axes, signs included, at the rows SHOT can use (>= 5 neighbours):
    # the sign rule counts neighbours on either side, which only a neighbour
    # within rounding of the axis' plane could move.  Measured: within
    # 2.0e-6 (the weighted covariance sums up to 300 terms in another
    # order).  With one neighbour the covariance has rank 1 and x, z are
    # rounding noise in its null space in either package
    used = tok & (mask.sum(1) >= shot.MIN_NEIGHBORS)
    assert used.sum() > 200
    np.testing.assert_allclose(tf[used], jf[used], rtol=0, atol=2e-5)


def test_radius_neighbors_match_jax(support):
    k = 256
    jidx, jdist, jmask = _jax_neighbors(support, k)
    plan = cg.plan_grid(T(support["xyz"]), T(support["valid"]), RADIUS)
    tidx, tdist, tmask = (x.numpy() for x in grid.radius_neighbors(
        plan, T(support["q"]), T(support["qv"]), RADIUS, k))
    assert jmask.sum(1).max() < k  # nothing was truncated by k
    np.testing.assert_array_equal(tmask.sum(1), jmask.sum(1))
    for row in range(len(jidx)):
        assert set(tidx[row][tmask[row]]) == set(jidx[row][jmask[row]]), row
    # sorted by distance, the same distances up to XLA's FMA contraction of
    # the d2 sum: measured 1 ulp apart at most
    np.testing.assert_allclose(tdist[tmask], jdist[jmask], rtol=2.5e-7, atol=0)
    assert not tmask[5].any() and not tmask[-1].any()  # invalid, far away
    assert tmask[-4].any()  # one cell outside the grid, still in reach


@pytest.mark.parametrize("mode", ["lrf", "gravity"])
def test_shot_matches_jax(support, mode):
    q, qv = support["q"], support["qv"]
    frames = fb = None
    jkw = {}
    if mode == "gravity":
        kp_normal = support["normal"][:len(q)]
        kp_normal[:40] = np.array([0.0, 0.0, 1.0], np.float32)  # the fallback rows
        jf, jfb = jlrf.gravity_lrf(jnp.asarray(kp_normal))
        jkw = dict(frames=jf, fallback_mask=jfb)
        frames, fb = lrf.gravity_lrf(T(kp_normal))
    jd, jok = (np.asarray(x) for x in jshot.shot(
        jnp.asarray(q), jnp.asarray(qv), jnp.asarray(support["xyz"]),
        jnp.asarray(support["normal"]), jnp.asarray(support["valid"]), RADIUS, k_neighbors=512,
        cap=1024, approx=False, use_scatter=True, **jkw))
    td, tok = (x.numpy() for x in shot.shot(
        T(q), T(qv), T(support["xyz"]), T(support["normal"]), T(support["valid"]), RADIUS,
        frames=frames, k_neighbors=512, fallback_mask=fb))
    np.testing.assert_array_equal(tok, jok)
    assert tok.sum() > 200
    # unit-norm 352-vectors from the same votes; the frames (closed-form
    # eigenvectors in the SHOT LRF) and the votes' acos / atan2 round apart
    # in the last bits.  Measured: 2.4e-6 at most
    np.testing.assert_allclose(td, jd, rtol=0, atol=2e-5)


def test_shot_from_neighbors_matches_numpy_oracle(rng):
    """The port's histogram against the double-precision oracle of the
    reference's interpolation (shot_debug.cpp:29-194), as
    tests/test_shot_oracle.py holds the JAX package's."""
    M, K = 12, 48
    centers = rng.uniform(-3, 3, size=(M, 3)).astype(np.float32)
    frames = np.stack([_random_frame(rng) for _ in range(M)])
    dirs = rng.normal(size=(M, K, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    radii = RADIUS * rng.uniform(0.05, 0.999, size=(M, K, 1)) ** (1 / 3)
    nbr = (centers[:, None, :] + dirs * radii).astype(np.float32)
    nrm = _unit(rng.normal(size=(M, K, 3)))
    idx = np.arange(M * K).reshape(M, K)
    mask = np.ones((M, K), bool)
    mask[:, -3:] = rng.uniform(size=(M, 3)) > 0.5
    desc, ok = shot.shot_from_neighbors(T(centers), T(frames), T(nbr.reshape(-1, 3)),
                                        T(nrm.reshape(-1, 3)), T(idx), T(mask), RADIUS)
    assert ok.all()
    for m in range(M):
        ref = shot_oracle_one(centers[m].astype(np.float64), frames[m].astype(np.float64),
                              nbr[m][mask[m]].astype(np.float64),
                              nrm[m][mask[m]].astype(np.float64), RADIUS)
        # float32 against float64: the tolerance test_shot_oracle.py holds
        # the JAX package to
        np.testing.assert_allclose(desc[m].numpy(), ref, atol=2e-4, err_msg=f"kp {m}")
    # fewer than 5 neighbours: invalid and zero
    desc4, ok4 = shot.shot_from_neighbors(T(centers[:1]), T(frames[:1]), T(nbr[0]), T(nrm[0]),
                                          T(idx[:1, :4]), T(mask[:1, :4] | True), RADIUS)
    assert not ok4[0] and not desc4.any()

"""Parity: the PyTorch port's sub-voxel keypoint refinement (ops/quadric.py,
ops/iss.subvoxel_iss_keypoints) against the JAX package's.

The fit is a float32 6 x 6 normal-equations solve of the saliencies of a
keypoint's 6 nearest neighbours over their absolute coordinates in the
normal-aligned frame, as in the reference.  Its conditioning decides how
far two float32 solvers (XLA's and torch.linalg.solve) may part: measured
here, the refined positions of the two packages differ by at most
8.7e-9 * cond(AtA) (cond in float64), so the tests allow 2e-8 * cond, and
the accept flags differ only where cond(AtA) >= 8.7e6 (the solve then
keeps less than a tenth of a float32 digit), so they must agree below 1e6.
On real scenes (absolute coordinates of metres) cond(AtA) is 3e6-2e17: the
refinement there is float32 noise in both packages (each up to ~0.4 off a
float64 solve on the box scene), which the scene test states with counts.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_global_registration_tpu import types as jtypes
from lidar_global_registration_tpu.ops import iss as jiss
from lidar_global_registration_tpu.ops import quadric as jq
from lidar_global_registration_tpu_torch import types as ttypes
from lidar_global_registration_tpu_torch.ops import cellgrid as tcg
from lidar_global_registration_tpu_torch.ops import iss as tiss
from lidar_global_registration_tpu_torch.ops import quadric as tq
from test_cell_iss import _boxy_cloud
from test_torch_analysis import max_bucket

torch.set_num_threads(2)

ISS_RADIUS = 0.35
ROUNDOFF_PER_COND = 2e-8  # refined positions: |port - JAX| <= this * cond(AtA)
OK_COND = 1e6  # below it the accept flags agree


def _jax(fn, *args):
    out = fn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) else np.asarray(out)


def _port(fn, *args):
    out = fn(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args))
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()


def _cond_ata(normals: np.ndarray, nb_xyz: np.ndarray) -> np.ndarray:
    """cond(AtA) of each keypoint's fit in float64 (the rotation in float32,
    as both packages take it)."""
    R = tq.rotation_to_align_z(torch.from_numpy(normals)).double()
    rot = torch.einsum("mij,mkj->mki", R, torch.from_numpy(nb_xyz).double())
    xs, ys = rot[..., 0], rot[..., 1]
    A = torch.stack([xs * xs, xs * ys, ys * ys, xs, ys, torch.ones_like(xs)], -1)
    return torch.linalg.cond(A.transpose(1, 2) @ A).numpy()


def test_rotation_matches_jax_on_both_sides_of_min_angle():
    """Rodrigues rotations within 5e-7 of JAX's (measured 2.1e-7), the
    identity below MIN_ANGLE in both (normals at 0.039 rad and 0.041 rad
    from z, away from the float32 rounding of the branch), and +z maps onto
    the normal."""
    rng = np.random.default_rng(0)
    n = rng.normal(size=(300, 3)).astype(np.float32)
    for i, ang in enumerate((0.0, 0.02, 0.039, 0.041, 0.06, np.pi / 2, np.pi - 0.3)):
        n[i] = [np.sin(ang), 0.0, np.cos(ang)]
    Rj, Rt = _jax(jq.rotation_to_align_z, n), _port(tq.rotation_to_align_z, n)
    np.testing.assert_allclose(Rt, Rj, atol=5e-7)
    eye = np.eye(3, dtype=np.float32)
    for i in range(3):
        assert np.array_equal(Rt[i], eye) and np.array_equal(Rj[i], eye)
    assert not np.allclose(Rt[3], eye, atol=1e-4)
    unit = n / np.linalg.norm(n, axis=1, keepdims=True)
    far = np.arccos(np.clip(unit[:, 2], -1, 1)) >= tq.MIN_ANGLE
    np.testing.assert_allclose(Rt[far][:, :, 2], unit[far], atol=1e-6)


def test_fit_and_maximum_on_exact_paraboloids():
    """z = a (x - x0)^2 + b (x - x0)(y - y0) + c (y - y0)^2 + f sampled at 16
    points of [-1, 1]^2 (cond(AtA) <= 510 here): both packages recover the
    six coefficients within 2e-5 (measured 5.7e-6) and the maximum (x0, y0)
    within 1e-4 (measured 1.6e-6); a degenerate fit (b^2 = 4ac) has no
    maximum in either."""
    rng = np.random.default_rng(1)
    M, K = 64, 16
    a = -rng.uniform(0.5, 2.0, M)
    c = -rng.uniform(0.5, 2.0, M)
    b = rng.uniform(-0.5, 0.5, M)
    x0, y0, f = (rng.uniform(-0.5, 0.5, M) for _ in range(3))
    # the same paraboloid in the fit's monomials
    coefs = np.stack([a, b, c, -2 * a * x0 - b * y0, -2 * c * y0 - b * x0,
                      a * x0 ** 2 + b * x0 * y0 + c * y0 ** 2 + f], 1)
    xs, ys = rng.uniform(-1, 1, (2, M, K))
    z = (a[:, None] * (xs - x0[:, None]) ** 2 + b[:, None] * (xs - x0[:, None]) * (
        ys - y0[:, None]) + c[:, None] * (ys - y0[:, None]) ** 2 + f[:, None])
    args = [v.astype(np.float32) for v in (xs, ys, z)] + [np.ones((M, K), bool)]
    cj, ct = _jax(jq.fit_quadric_2d, *args), _port(tq.fit_quadric_2d, *args)
    np.testing.assert_allclose(ct, coefs, atol=2e-5)
    np.testing.assert_allclose(cj, coefs, atol=2e-5)
    for got, ok in (_jax(jq.quadric_maximum, ct), _port(tq.quadric_maximum, ct)):
        assert ok.all()
        np.testing.assert_allclose(got, np.stack([x0, y0], 1), atol=1e-4)
    flat = np.array([[-1.0, 2.0, -1.0, 0.3, 0.1, 0.0]], np.float32)  # b^2 = 4ac
    for _xy, ok in (_jax(jq.quadric_maximum, flat), _port(tq.quadric_maximum, flat)):
        assert not ok.any()


def _synthetic_neighbourhoods(M=600, K=6, seed=3):
    """Keypoints near the origin, their K neighbours in the tangent plane
    (spread 1, 1 cm of noise along the normal), saliencies of a downward
    paraboloid about a point near the keypoint."""
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(M, 3))
    nrm[:, 2] = np.abs(nrm[:, 2]) + 1.0
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    kp = rng.uniform(-0.2, 0.2, (M, 3))
    t1 = np.cross(nrm, [1.0, 0.0, 0.0])
    t1 /= np.linalg.norm(t1, axis=1, keepdims=True)
    t2 = np.cross(nrm, t1)
    uv = rng.uniform(-0.5, 0.5, (M, K, 2))
    uv[:, 0] = 0.0  # the keypoint itself comes first
    nb = (kp[:, None] + uv[..., :1] * t1[:, None] + uv[..., 1:] * t2[:, None]
          + rng.normal(scale=0.01, size=(M, K, 1)) * nrm[:, None])
    cx = rng.uniform(0.5, 2.0, (M, 1))
    x0 = rng.uniform(-0.2, 0.2, (M, 2))
    sal = 1.0 - cx * ((uv[..., 0] - x0[:, :1]) ** 2 + (uv[..., 1] - x0[:, 1:]) ** 2)
    f32 = lambda v: v.astype(np.float32)  # noqa: E731
    return f32(kp), f32(nrm), f32(nb), f32(sal), np.ones((M, K), bool)


def test_subvoxel_keypoints_matches_jax_within_its_conditioning():
    """600 six-neighbour fits spanning cond(AtA) 8e2-5e13: the refined
    positions within 2e-8 * cond of JAX's where both accept (measured at
    most 8.7e-9 * cond: 1.1e-5 below cond 1e4, 1.2e-4 below 1e5), the
    accept flags equal below cond 1e6 (measured: the 7 rows that differ
    have cond >= 1.2e8), a masked-out neighbour changes nothing, and every
    accepted point lies within the salient radius of its keypoint."""
    kp, nrm, nb, sal, mask = _synthetic_neighbourhoods()
    R = 0.8
    jr, jo = _jax(jq.subvoxel_keypoints, kp, nrm, nb, sal, mask, R)
    tr, to = _port(tq.subvoxel_keypoints, kp, nrm, nb, sal, mask, R)
    cond = _cond_ata(nrm, nb)
    assert cond.min() < 1e3 and cond.max() > 1e12
    both = jo & to
    assert both.sum() > 400
    diff = np.abs(jr - tr).max(1)
    assert (diff[both] <= ROUNDOFF_PER_COND * cond[both]).all()
    well = cond < OK_COND
    assert well.sum() > 250 and np.array_equal(jo[well], to[well])
    for r, o in ((jr, jo), (tr, to)):
        assert (np.linalg.norm(r[o] - kp[o], axis=1) < R).all()
        assert np.array_equal(r[~o], kp[~o])
    # a seventh neighbour that is masked out is not read
    far = np.concatenate([nb, nb[:, :1] + 100.0], 1)
    m7 = np.concatenate([mask, np.zeros_like(mask[:, :1])], 1)
    s7 = np.concatenate([sal, np.full_like(sal[:, :1], 9.0)], 1)
    r7, o7 = _port(tq.subvoxel_keypoints, kp, nrm, far, s7, m7, R)
    np.testing.assert_allclose(r7[well & to], tr[well & to], atol=1e-4)


@pytest.fixture(scope="module")
def box_refined():
    """The ground + box scene of tests/test_cell_iss.py (thinned as in
    tests/test_torch_host_ops.py) through both subvoxel_iss_keypoints, every
    ISS keypoint refined."""
    pts = _boxy_cloud(np.random.default_rng(566), n_ground=2000, n_box=600)
    tc = ttypes.Cloud.from_numpy(pts)
    plan = tcg.plan_grid(tc.xyz, tc.valid, ISS_RADIUS)
    count = tcg.iss_count_plain(plan, tcg._f32_square(ISS_RADIUS))[0].numpy()
    jout = jiss.subvoxel_iss_keypoints(jtypes.Cloud.from_numpy(pts), ISS_RADIUS,
                                       max_keypoints=1000)
    tout = tiss.subvoxel_iss_keypoints(tc, ISS_RADIUS, max_keypoints=1000)
    return dict(pts=pts, port=tc, count=count, jax=[np.asarray(v) for v in jout],
                torch=[v.numpy() for v in tout])


def test_subvoxel_iss_keypoints_matches_jax(box_refined):
    """Under the JAX grid's caps (32 points a cell, 64 ISS neighbours, which
    no cell and no neighbourhood here reaches) the same keypoint rows,
    ascending; each package's accepted points within the ISS radius of their
    keypoint, the others the keypoint itself; refined positions within 2e-8
    * cond(AtA) of JAX's where both accept (measured 9.5e-10 * cond); accept
    flags equal below cond 1e6.  On this scene cond(AtA) is 3e6-2e17
    (measured): 56 of the 134 flags differ (each at cond >= 8.7e6) and the
    39 rows both accept differ by up to 0.36, so no keypoint here is
    refined to better than float32 noise in
    either package, as in the reference's fit over absolute coordinates."""
    pts, b = box_refined["pts"], box_refined
    assert max_bucket(pts, ISS_RADIUS) <= 32 and b["count"].max() - 1 <= 64
    (jr, ji, jo), (tr, ti, to) = b["jax"], b["torch"]
    assert len(ti) > 100
    np.testing.assert_array_equal(ti, ji)
    for r, o in ((jr, jo), (tr, to)):
        assert np.isfinite(r).all()
        assert (np.linalg.norm(r[o] - pts[ti][o], axis=1) < ISS_RADIUS).all()
        assert np.array_equal(r[~o], pts[ti][~o])
    # the fit's inputs as the port builds them: the 6 nearest points and
    # their PCA normal (held to JAX's in tests/test_torch_host_ops.py)
    from lidar_global_registration_tpu_torch.ops.grid import knn
    from lidar_global_registration_tpu_torch.ops.normals import normals_from_neighbors

    tc = b["port"]
    kp = tc.xyz[torch.from_numpy(ti)]
    nidx, _d, nmask = knn(tc.xyz, tc.valid, 6, queries=kp)
    normal = normals_from_neighbors(kp, tc.xyz, nidx, nmask)[0].numpy()
    cond = _cond_ata(normal, tc.xyz[nidx].numpy())
    both = jo & to
    assert both.sum() > 30  # 39 measured
    assert (np.abs(jr - tr).max(1)[both] <= ROUNDOFF_PER_COND * cond[both]).all()
    assert np.array_equal(jo[cond < OK_COND], to[cond < OK_COND])
    assert cond.min() > 1e6  # every row beyond float32's resolution here


def test_subvoxel_iss_keypoints_takes_the_first_ten(box_refined):
    """The reference refines the first 10 sorted keypoints: the same rows
    and the same fits as the first 10 of the full run; a cloud without
    keypoints gives empty outputs."""
    tc = box_refined["port"]
    r10, i10, o10 = (v.numpy() for v in tiss.subvoxel_iss_keypoints(tc, ISS_RADIUS))
    tr, ti, to = box_refined["torch"]
    np.testing.assert_array_equal(i10, ti[:10])
    np.testing.assert_array_equal(r10, tr[:10])
    np.testing.assert_array_equal(o10, to[:10])
    few = ttypes.Cloud.from_numpy(np.random.default_rng(0).uniform(0, 0.1, (3, 3)))  # < min_nb
    r, i, o = tiss.subvoxel_iss_keypoints(few, ISS_RADIUS)
    assert r.shape == (0, 3) and i.shape == (0,) and o.shape == (0,)

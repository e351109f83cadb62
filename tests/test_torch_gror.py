"""Parity: the PyTorch port's GROR solver (models/gror.py) against the JAX
package's, function by function and as a whole, on inputs made with numpy
from a seed.  GROR draws nothing, so on one correspondence set the two
packages must agree far more tightly than the RANSAC stages can.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_global_registration_tpu.models import gror as jg
from lidar_global_registration_tpu_torch.models import gror as tg
from lidar_global_registration_tpu_torch.ops import transform as tt

torch.set_num_threads(2)

RES = 0.05
ANG = 0.7
R_TRUE = np.array([[np.cos(ANG), 0, np.sin(ANG)], [0, 1, 0], [-np.sin(ANG), 0, np.cos(ANG)]],
                  np.float32)
T_TRUE = np.array([0.5, -1.0, 2.0], np.float32)


def _problem(seed=566, n=120, n_out=36, noise=0.0):
    """The 120-pair, 30 %-outlier problem of tests/test_staged_gror.py."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 5.0, (n, 3)).astype(np.float32)
    q = (p @ R_TRUE.T + T_TRUE).astype(np.float32)
    if noise:
        q = (q + rng.normal(scale=noise, size=q.shape)).astype(np.float32)
    q[:n_out] = rng.uniform(0, 5.0, (n_out, 3)).astype(np.float32)
    return p, q


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _edges(p, q, seed=3, E=48):
    """Seeded candidate edges over the problem's rows, inliers and outliers
    mixed, with each package's own two-point alignment."""
    rng = np.random.default_rng(seed)
    i1 = rng.integers(0, len(p), E)
    i2 = (i1 + rng.integers(1, len(p), E)) % len(p)
    return i1, i2


@pytest.mark.parametrize("chunk", [1024, 50])
def test_degrees_only_equals_jax(chunk):
    """Integers: equal.  The chunked pass (a chunk that does not divide n
    too) equals the full adjacency's row sums in both packages."""
    p, q = _problem(noise=0.01)
    valid = np.ones(len(p), bool)
    valid[5::17] = False
    want = np.asarray(jg._degrees_only(*_j(p, q, valid), RES, chunk=chunk))
    got = tg._degrees_only(*_t(p, q, valid), RES, chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), want)
    deg, adj = tg._node_degrees(*_t(p, q, valid), RES)
    jdeg, jadj = jg._node_degrees(*_j(p, q, valid), RES)
    np.testing.assert_array_equal(deg.numpy(), np.asarray(jdeg))
    np.testing.assert_array_equal(adj.numpy(), np.asarray(jadj))
    np.testing.assert_array_equal(deg.numpy(), want)
    assert want.max() >= 60 and (want[~valid] == 0).all()


def test_two_point_align_matches_jax():
    """atol 1e-5 on the rotations and axes (Rodrigues from float32 unit
    vectors; XLA and PyTorch round the normalisations and the 3 x 3 sums in
    other orders), plus rtol 1e-5 for the translations and origins, whose
    entries reach a few units (measured 1.3e-5 at 1.02 x ... 6.8: 1.9e-6
    relatively).  Includes an antipodal edge (c = -1) and one along x, where
    the perpendicular comes from the y axis."""
    p, q = _problem()
    i1, i2 = _edges(p, q)
    p1, q1, p2, q2 = p[i1], q[i1], p[i2], q[i2]
    p1[0], p2[0], q1[0], q2[0] = [1, 2, 3], [2, 2, 3], [0, 0, 0], [-1, 0, 0]  # antipodal, along x
    p1[1], p2[1], q1[1], q2[1] = [0, 0, 0], [0, 1, 1], [1, 1, 1], [1, 0, 0]  # antipodal
    want = jg._two_point_align(*_j(p1, q1, p2, q2))
    got = tg._two_point_align(*_t(p1, q1, p2, q2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
    R = got[0].numpy()
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-5)


def _aligned(p, q, valid=None):
    i1, i2 = _edges(p, q)
    jal = jg._two_point_align(*_j(p[i1], q[i1], p[i2], q[i2]))
    valid = np.ones(len(p), bool) if valid is None else valid
    # both packages get the JAX alignment: any difference below is the
    # function's own
    return jal, tuple(torch.from_numpy(np.array(a)) for a in jal), valid


def test_rcfs_counts_equal_jax():
    p, q = _problem(noise=0.01)
    valid = np.ones(len(p), bool)
    valid[3::11] = False
    jal, tal, valid = _aligned(p, q, valid)
    want = np.asarray(jg._rcfs_counts(*jal, *_j(p, q, valid), RES))
    got = tg._rcfs_counts(*tal, *_t(p, q, valid), RES)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() >= 60


@pytest.mark.parametrize("noise", [0.0, 0.01])
def test_tcfs_stab_matches_jax(noise):
    """Counts equal; angles atol 1e-5 (atan2 / acos of XLA and of PyTorch
    differ in the last bits, and the angle is a midpoint of two event
    locations).  TCFS counts never exceed the RCFS bound of the same edge."""
    p, q = _problem(noise=noise)
    jal, tal, valid = _aligned(p, q)
    ja, jc = jg._tcfs_stab(*jal, *_j(p, q, valid), RES)
    ta, tc = tg._tcfs_stab(*tal, *_t(p, q, valid), RES)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    rc = tg._rcfs_counts(*tal, *_t(p, q, valid), RES)
    assert bool((tc <= rc).all()) and int(tc.max()) >= 60


def _ring(az_s, az_t):
    """Correspondences on the unit circle at height 0, source azimuths az_s
    and target azimuths az_t, for an edge whose axis is z and origin 0: the
    azimuth arcs can then be placed by hand (centre az_t - az_s)."""
    az_s, az_t = np.asarray(az_s, np.float32), np.asarray(az_t, np.float32)
    zero = np.zeros(len(az_s), np.float32)
    p = np.stack([np.cos(az_s), np.sin(az_s), zero], 1).astype(np.float32)
    q = np.stack([np.cos(az_t), np.sin(az_t), zero], 1).astype(np.float32)
    return p, q


def _z_edges(E):
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (E, 3, 3)).copy()
    axis = np.tile(np.array([0, 0, 1], np.float32), (E, 1))
    return R, np.zeros((E, 3), np.float32), axis, np.zeros((E, 3), np.float32)


def test_tcfs_stab_exact_ties_and_wrapped_arc():
    """Events at exactly one location.  Three identical pairs (their three
    starts tie bit for bit, and their three ends), an arc that wraps through
    0 (split into [beg, 2 pi] and [0, end]), a source point on the axis (a
    full arc [0, 2 pi], whose start ties with the wrapped arc's second piece
    at exactly 0 and whose end ties with its first piece at exactly 2 pi),
    and a pair out of reach in z (infeasible).  The second edge looks down
    the axis (the antipodal frame).  Counts equal, angles atol 1e-5."""
    p, q = _ring([0.3, 0.3, 0.3, 0.1, 1.0, 0.0], [0.8, 0.8, 0.8, 6.2, 2.0, 0.0])
    q[4, 2] = 1.0  # infeasible: dz beyond 2 res
    p[5], q[5] = 0.0, [0.05, 0.0, 0.0]  # a source point on the axis: every rotation fits
    R, t, axis, origin = _z_edges(2)
    axis[1] = [0, 0, -1]
    valid = np.ones(len(p), bool)
    res = 0.1
    ja, jc = jg._tcfs_stab(*_j(R, t, axis, origin, p, q, valid), res)
    ta, tc = tg._tcfs_stab(*_t(R, t, axis, origin, p, q, valid), res)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    assert tc.tolist()[0] == 4  # the three identical arcs around 0.5 and the full arc
    assert abs(float(ta[0]) - 0.5) < 0.25
    # the sort key: at one location an end sorts before a start, and both
    # before the next float32 location
    def key(x, is_start):
        return (int(np.float32(x).view(np.int32)) << 1) | is_start
    assert key(1.25, 0) < key(1.25, 1) < key(np.nextafter(np.float32(1.25), np.float32(2)), 0)
    assert key(1e9, 1) < 2**32  # the largest location, shifted, fits the JAX package's uint32


def test_tcfs_stab_takes_the_first_of_equal_maxima():
    """Two groups of two identical pairs, far apart: both stabs count 2, and
    both packages return the first maximal start in sorted order (argmax
    takes the first maximum in XLA and in PyTorch), the arc about 0.8."""
    p, q = _ring([0.2, 0.2, 0.2, 0.2], [1.0, 1.0, 3.0, 3.0])
    R, t, axis, origin = _z_edges(1)
    valid = np.ones(4, bool)
    ja, jc = jg._tcfs_stab(*_j(R, t, axis, origin, p, q, valid), 0.1)
    ta, tc = tg._tcfs_stab(*_t(R, t, axis, origin, p, q, valid), 0.1)
    assert tc.tolist() == np.asarray(jc).tolist() == [2]
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    assert abs(float(ta[0]) - 0.8) < 0.25


def _same_result(got, want, atol=1e-4):
    """gror_solve in both packages on one correspondence set: the integer
    and boolean fields equal; the transformation atol 1e-4 (Umeyama through
    a 4 x 4 eigh, XLA and PyTorch up to 5e-5 apart in rotation entries at
    unit scale; translations of a few units)."""
    for k in ("inliers", "iterations", "converged", "n_correspondences"):
        assert got[k] == want[k], (k, got[k], want[k])
    assert float(got["metric"]) == float(want["metric"])
    np.testing.assert_allclose(got["transformation"].numpy(),
                               np.asarray(want["transformation"]), atol=atol)


@pytest.mark.parametrize("pad", [0, 64])
@pytest.mark.parametrize("noise", [0.0, 0.01])
def test_gror_solve_matches_jax(pad, noise):
    p, q = _problem(noise=noise)
    n, n_out = len(p), 36
    valid = np.ones(n, bool)
    if pad:
        p = np.concatenate([p, np.full((pad, 3), 1e6, np.float32)])
        q = np.concatenate([q, np.full((pad, 3), -1e6, np.float32)])
        valid = np.concatenate([valid, np.zeros(pad, bool)])
    want = jg.gror_solve(*_j(p, q, valid), RES)
    got = tg.gror_solve(*_t(p, q, valid), RES)
    _same_result(got, want)
    assert got["converged"] and got["inliers"] >= n - n_out - (3 if noise else 0)
    T = got["transformation"].numpy()
    dR = T[:3, :3] @ R_TRUE.T
    assert np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)) < 2e-3
    assert np.linalg.norm(T[:3, 3] - T_TRUE) < 1e-2


def test_gror_solve_padding_invariant():
    """The padded call gives the exact call's result in the port too."""
    p, q = _problem()
    exact = tg.gror_solve(*_t(p, q, np.ones(len(p), bool)), RES)
    pp = np.concatenate([p, np.full((64, 3), 1e6, np.float32)])
    qp = np.concatenate([q, np.full((64, 3), -1e6, np.float32)])
    vp = np.concatenate([np.ones(len(p), bool), np.zeros(64, bool)])
    padded = tg.gror_solve(*_t(pp, qp, vp), RES)
    assert exact["inliers"] == padded["inliers"] == 84
    assert exact["iterations"] == padded["iterations"]
    torch.testing.assert_close(padded["transformation"], exact["transformation"], atol=1e-5,
                               rtol=0)


def test_gror_solve_duplicate_targets_matches_jax():
    """tests/test_gror_repetitive.py's duplicate-target case: source pairs
    0.4 apart sharing one target point; the edge-length floor keeps them
    out of the alignment edges in both packages."""
    rng = np.random.default_rng(566)
    ang = 0.7
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                 np.float32)
    t = np.array([1.2, -0.7, 0.4], np.float32)
    p_true = rng.uniform(-5, 5, size=(60, 3)).astype(np.float32)
    q_true = (p_true @ R.T + t + rng.normal(scale=0.01, size=(60, 3))).astype(np.float32)
    p_dup, q_dup = [], []
    for _ in range(20):
        base = rng.uniform(-5, 5, size=3).astype(np.float32)
        tgt = rng.uniform(-5, 5, size=3).astype(np.float32)
        p_dup += [base, base + np.array([0.4, 0, 0], np.float32)]
        q_dup += [tgt, tgt]
    p = np.concatenate([p_true, np.asarray(p_dup)])
    q = np.concatenate([q_true, np.asarray(q_dup)])
    valid = np.ones(len(p), bool)
    want = jg.gror_solve(*_j(p, q, valid), RES)
    got = tg.gror_solve(*_t(p, q, valid), RES)
    _same_result(got, want)
    assert got["converged"] and got["inliers"] >= 55
    T = got["transformation"].numpy()
    assert np.linalg.norm(T[:3, 3] - t) < 2 * RES


@pytest.mark.parametrize("case", ["one row", "no valid row", "no consistent pair",
                                  "no qualifying edge"])
def test_gror_solve_fail_dict_matches_jax(case):
    """n < 2, fewer than two nodes of positive degree, and no edge with 10
    consistent partners all return the `fail` dict: identity, not
    converged, 0 inliers, 0 iterations."""
    p, q = _problem()
    valid = np.ones(len(p), bool)
    if case == "one row":
        valid[1:] = False
    elif case == "no valid row":
        valid[:] = False
    elif case == "no consistent pair":
        rng = np.random.default_rng(1)
        p, q, valid = p[:6], (rng.uniform(0, 50, (6, 3))).astype(np.float32), valid[:6]
    else:  # 8 inliers: every adjacency is below MIN_EDGE_ADJACENCY
        p, q, valid = p[28:44], q[28:44], valid[28:44]
    want = jg.gror_solve(*_j(p, q, valid), RES)
    got = tg.gror_solve(*_t(p, q, valid), RES)
    _same_result(got, want, atol=0.0)
    assert not got["converged"] and got["inliers"] == 0 and got["iterations"] == 0
    assert torch.equal(got["transformation"], torch.eye(4))


def test_umeyama_is_kabsch():
    p, q = _problem()
    w = torch.ones(len(p))
    w[:36] = 0.0
    R, t = tt.umeyama(*_t(p[None], q[None]), w[None])
    Rk, tk = tt.kabsch(*_t(p[None], q[None]), w[None])
    assert torch.equal(R, Rk) and torch.equal(t, tk)
    np.testing.assert_allclose(R[0].numpy(), R_TRUE, atol=1e-5)


def test_tcfs_does_not_depend_on_tf32_setting():
    """The solver's 3 x 3 products are elementwise sums: the result is the
    same whatever the caller left in the matmul precision switches."""
    p, q = _problem(noise=0.01)
    valid = np.ones(len(p), bool)
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        a = tg.gror_solve(*_t(p, q, valid), RES)
        torch.backends.cuda.matmul.allow_tf32 = False
        b = tg.gror_solve(*_t(p, q, valid), RES)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert a["inliers"] == b["inliers"] and torch.equal(a["transformation"], b["transformation"])

"""Parity: the PyTorch port's matcher variants against the JAX package's
(ops/matchers.py): the bf16 matcher (match_bf(bf16=True): norms of the
float32 rows, dot products of the bfloat16-rounded rows) for k = 1 (K7's
plain version here) and k > 1, and the guess-guided local matcher
(match_local).

Descriptors are random FPFH-like rows (non-negative, 33 wide) and
SHOT-like rows (352 wide, unit length), made with numpy from a seed; the
keypoint clouds of match_local are sparse enough that no cell of the JAX
package's grid reaches its cap of 32 points.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_global_registration_tpu.ops import matchers as jm
from lidar_global_registration_tpu_torch.ops import matchers as tm
from lidar_global_registration_tpu_torch.ops import nn_l2 as tnn
from test_torch_analysis import max_bucket

torch.set_num_threads(2)


def _rows(rng, n, d):
    x = rng.gamma(0.6, size=(n, d)).astype(np.float32)
    if d == 352:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    else:
        x *= 100.0 / x.reshape(n, 3, -1).sum(-1).repeat(d // 3, 1)
    return x.astype(np.float32)


def _both(q, t, qv, tv, **kw):
    ti, td, tmk = tm.match_bf(torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(qv),
                              torch.from_numpy(tv), **kw)
    ji, jd, jmk = jm.match_bf(jnp.asarray(q), jnp.asarray(t), jnp.asarray(qv), jnp.asarray(tv),
                              **kw)
    return (ti.numpy(), td.numpy(), tmk.numpy()), (np.asarray(ji), np.asarray(jd),
                                                   np.asarray(jmk))


@pytest.mark.parametrize("d", [33, 352])
def test_bf16_1nn_matches_jax(d):
    """k = 1: the same mask; the same index wherever the best two
    distances are more than 1e-5 apart (measured: every index equal); d2
    within 2e-6 of |q|^2 + |t|^2, a few float32 roundings of the expansion
    whose sums run in another order (measured 3.7e-7)."""
    rng = np.random.default_rng(d)
    q, t = _rows(rng, 700, d), _rows(rng, 900, d)
    t[::7] = q[: len(t[::7])] + 1e-3  # near-duplicates: bf16 rounding matters here
    qv, tv = rng.uniform(size=700) < 0.95, rng.uniform(size=900) < 0.9
    (ti, td, tmk), (ji, jd, jmk) = _both(q, t, qv, tv, k=1, bf16=True)
    np.testing.assert_array_equal(tmk, jmk)
    d2 = ((q[:, None, :].astype(np.float64) - t[None].astype(np.float64)) ** 2).sum(-1)
    d2 = np.where(tv[None], d2, np.inf)
    two = np.sort(d2, 1)[:, :2]
    clear = tmk[:, 0] & (two[:, 1] - two[:, 0] > 1e-5 * two[:, 1])
    np.testing.assert_array_equal(ti[clear], ji[clear])
    m = tmk[:, 0]
    norms = (q[m] ** 2).sum(1) + (t[ti[m, 0]] ** 2).sum(1)
    assert (np.abs(td[m, 0] ** 2 - jd[m, 0] ** 2) <= 2e-6 * norms).all()
    # the plain 1-NN's d2 is the float32 rows' norms minus twice the dot of
    # the rounded rows (float64 reference)
    d2p, ip = tnn.nn_l2_plain(torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(tv),
                              bf16=True)
    j = ip.long()
    qb, tb = (tnn.bf16_round(torch.from_numpy(x)).double() for x in (q, t))
    q64, t64 = torch.from_numpy(q).double(), torch.from_numpy(t).double()
    ref = (q64 ** 2).sum(1) + (t64[j] ** 2).sum(1) - 2.0 * (qb * tb[j]).sum(1)
    bound = 2e-6 * ((q64 ** 2).sum(1) + (t64[j] ** 2).sum(1))
    assert bool(((d2p.double() - ref).abs() <= bound).all())


def test_bf16_topk_matches_jax():
    """k = 5 (the host pyramid's randomness > 1): the same mask and the
    same candidate sets wherever no tie is within 1e-5; distances within
    1e-5 relative."""
    rng = np.random.default_rng(9)
    q, t = _rows(rng, 400, 33), _rows(rng, 500, 33)
    qv, tv = np.ones(400, bool), rng.uniform(size=500) < 0.9
    (ti, td, tmk), (ji, jd, jmk) = _both(q, t, qv, tv, k=5, bf16=True)
    np.testing.assert_array_equal(tmk, jmk)
    np.testing.assert_allclose(np.sort(td, 1), np.sort(jd, 1), rtol=1e-5, atol=1e-4)
    same = np.array([set(a) == set(b) for a, b in zip(ti, ji)])
    assert same.mean() > 0.98, same.mean()


def test_bf16_differs_from_fp32():
    """The bf16 matcher is not the float32 one: its distances move by the
    rounding of the rows (8 mantissa bits) on these descriptors."""
    rng = np.random.default_rng(4)
    q, t = _rows(rng, 300, 33), _rows(rng, 300, 33)
    v = np.ones(300, bool)
    _i1, d1, _m1 = tm.match_bf(*(torch.from_numpy(x) for x in (q, t, v, v)), k=1)
    _i2, d2, _m2 = tm.match_bf(*(torch.from_numpy(x) for x in (q, t, v, v)), k=1, bf16=True)
    assert not torch.equal(d1, d2)
    assert float((d1 - d2).abs().max()) < 0.05 * float(d1.max())


def _local_scene(seed=11, n=600):
    rng = np.random.default_rng(seed)
    train = rng.uniform(0, 20, size=(n, 3)).astype(np.float32)
    train[:, 2] *= 0.2
    c, s = np.cos(0.2), np.sin(0.2)
    T = np.array([[c, -s, 0, 1.0], [s, c, 0, -0.5], [0, 0, 1, 0.2], [0, 0, 0, 1]], np.float32)
    # queries: the train points moved by inv(T), jittered; the guess is T
    qx = ((train - T[:3, 3]) @ T[:3, :3]).astype(np.float32)
    qx += rng.normal(scale=0.05, size=qx.shape).astype(np.float32)
    tf = _rows(rng, n, 33)
    qf = (tf + rng.normal(scale=0.5, size=tf.shape)).astype(np.float32)
    qv, tv = rng.uniform(size=n) < 0.95, rng.uniform(size=n) < 0.95
    return qx, qv, qf, train, tv, tf, T


@pytest.mark.parametrize("k", [1, 3])
def test_match_local_matches_jax(k):
    """Candidates within 1.5 of the moved query (up to 64 of them), ranked
    by descriptor L2: the same indices (a tie goes to the candidate nearer
    in 3D in both) and mask, distances within 1e-5."""
    qx, qv, qf, train, tv, tf, T = _local_scene()
    assert max_bucket(train, 1.5) <= 32
    args = (qx, qv, qf, train, tv, tf, T)
    ti, td, tmk = tm.match_local(*(torch.from_numpy(a) for a in args), 1.5, k=k)
    ji, jd, jmk = jm.match_local(*(jnp.asarray(a) for a in args), 1.5, k=k)
    np.testing.assert_array_equal(tmk.numpy(), np.asarray(jmk))
    assert tmk.shape == (600, k) and 0.5 < float(tmk[:, 0].float().mean()) < 1.0
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    ok = tmk.numpy()
    np.testing.assert_allclose(td.numpy()[ok], np.asarray(jd)[ok], rtol=1e-5)


def test_match_local_identity_guess_with_a_large_radius_is_match_bf():
    """With the identity as guess and a radius that holds every train
    point, the local matcher is the brute-force one: equal indices and
    masks; distances within 1e-3 relative, because match_bf takes them from
    the expansion |q|^2 + |t|^2 - 2 q.t, whose float32 cancellation moves a
    distance of these rows (blocks of 100) by up to 2.4e-4 relatively
    (measured), and match_local sums the squared differences."""
    qx, qv, qf, train, tv, tf, _T = _local_scene(n=60)
    t = [torch.from_numpy(a) for a in (qx, qv, qf, train, tv, tf)]
    li, ld, lm = tm.match_local(*t, torch.eye(4), 100.0, k=1)
    bi, bd, bm = tm.match_bf(t[2], t[5], t[1], t[4], k=1)
    assert torch.equal(lm, bm) and torch.equal(li, bi)
    torch.testing.assert_close(ld[lm], bd[bm], rtol=1e-3, atol=1e-4)


def test_match_local_zero_radius_finds_only_coincident_points():
    """match_search_radius 0 (the parameter's default): only a train point
    at the moved query's exact position is a candidate."""
    train = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [5.0, 5.0, 5.0]])
    q = torch.tensor([[1.0, 0.0, 0.0], [0.5, 0.0, 0.0]])
    f = torch.rand(3, 33)
    i, _d, m = tm.match_local(q, torch.ones(2, dtype=torch.bool), f[:2], train,
                              torch.ones(3, dtype=torch.bool), f, torch.eye(4), 0.0)
    assert m[:, 0].tolist() == [True, False] and int(i[0, 0]) == 1

"""Parity: the PyTorch port's descriptor 1-NN (K7) against the JAX
package's Pallas kernel nn_l2_pallas in interpret mode.

On the CPU the port runs the plain PyTorch version of its CUDA kernel.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_global_registration_tpu.ops.pallas.topk_l2 import nn_l2_pallas
from lidar_global_registration_tpu_torch.ops import nn_l2 as k7
from lidar_global_registration_tpu_torch.ops.matchers import match_bf
from lidar_global_registration_tpu_torch.ops.nn_l2 import nn_l2

torch.set_num_threads(2)


def _both(q, t, qv, tv):
    ji, jd, jm = (np.asarray(v) for v in nn_l2_pallas(
        jnp.asarray(q), jnp.asarray(t), jnp.asarray(qv), jnp.asarray(tv),
        tile_q=64, tile_t=128, interpret=True))
    ti, td, tm = (v.numpy() for v in nn_l2(
        torch.from_numpy(q), torch.from_numpy(t), torch.from_numpy(qv), torch.from_numpy(tv)))
    return (ti, td, tm), (ji, jd, jm)


@pytest.mark.parametrize("D", [33, 352])
def test_nn_matches_pallas(rng, D):
    Nq, Nt = 300, 333
    q = rng.normal(size=(Nq, D)).astype(np.float32)
    t = rng.normal(size=(Nt, D)).astype(np.float32)
    qv = np.ones(Nq, bool)
    qv[7] = False
    tv = np.ones(Nt, bool)
    tv[17] = False
    (ti, td, tm), (ji, jd, jm) = _both(q, t, qv, tv)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(td, jd, rtol=1e-5)
    same = np.abs(td - jd) <= 1e-6  # where the distances agree, so do the indices
    np.testing.assert_array_equal(ti[same], ji[same])
    assert not tm[7] and ti[7] == 0


def test_nn_ties_go_to_the_lowest_index(rng):
    t = rng.normal(size=(200, 33)).astype(np.float32)
    t[150] = t[20]
    t[199] = t[20]
    q = t[[20, 150, 199, 5]].copy()
    (ti, td, tm), (ji, _jd, _jm) = _both(q, t, np.ones(4, bool), np.ones(200, bool))
    assert ti.tolist() == [20, 20, 20, 5]
    assert ti.tolist() == ji.tolist()
    assert tm.all()


@pytest.mark.parametrize("D", [33, 352])
def test_nn_ties_far_apart_and_at_the_ends(rng, D):
    """Exact copies of a row at both ends of the train set, far apart, and
    on both sides of each cut of K7's split train range: the lowest index
    wins, in JAX's Pallas kernel, in the plain version and in each split."""
    nt = 1000
    S, per = k7.split_plan(3, nt, 132)
    assert S > 1
    cuts = [k * per * k7.TILE for k in range(1, S)]
    t = rng.normal(size=(nt, D)).astype(np.float32)
    pairs = [(0, nt - 1), (3, 997), (1, 500)] + [(c - 1, c) for c in cuts]
    q = rng.normal(size=(len(pairs) + 2, D)).astype(np.float32)
    for k, (lo, hi) in enumerate(pairs):
        t[hi] = t[lo]
        q[k] = t[lo]
    (ti, _td, tm), (ji, _jd, jm) = _both(q, t, np.ones(len(q), bool), np.ones(nt, bool))
    want = [lo for lo, _ in pairs]
    assert ti[:len(pairs)].tolist() == want
    assert ji[:len(pairs)].tolist() == want
    np.testing.assert_array_equal(ti, ji)
    assert tm.all() and jm.all()
    # the split: each range's argmin, merged lowest range first with a strict <
    d2, idx = _split_merge(torch.from_numpy(q), torch.from_numpy(t), torch.ones(nt, dtype=bool),
                           S, per)
    full_d2, full_idx = k7.nn_l2_plain(torch.from_numpy(q), torch.from_numpy(t),
                                       torch.ones(nt, dtype=bool))
    assert idx[:len(pairs)].tolist() == want
    assert torch.equal(idx, full_idx) and torch.equal(d2, full_d2)


def _split_merge(q, t, tv, S, per):
    """K7's split rule on the plain version: S train ranges of `per` tiles,
    each a lowest-index argmin, merged in range order with a strict <."""
    best_d = torch.full((q.shape[0],), k7.BIG)
    best_i = torch.zeros((q.shape[0],), dtype=torch.int32)
    for s in range(S):
        lo, hi = s * per * k7.TILE, min((s + 1) * per * k7.TILE, t.shape[0])
        d, i = k7.nn_l2_plain(q, t[lo:hi], tv[lo:hi])
        take = d < best_d
        best_d = torch.where(take, d, best_d)
        best_i = torch.where(take, i + lo, best_i)
    return best_d, best_i


@pytest.mark.parametrize("nq, nt, slots, want", [
    (22203, 22623, 264, (3, 59)),  # SHOT keypoints: 174 query tiles fill 264 slots once
    (65536, 65536, 264, (1, 512)),  # 512 query tiles: ~2 waves already
    (262144, 262144, 264, (1, 2048)),
    (129, 4099, 264, (11, 3)),  # 33 train tiles: at most 16 ranges, none empty
    (5, 0, 264, (1, 1)),  # no train row: one padded tile
])
def test_split_plan(nq, nt, slots, want):
    S, per = k7.split_plan(nq, nt, slots)
    assert (S, per) == want
    tiles = max(-(-nt // k7.TILE), 1)
    assert (S - 1) * per < tiles <= S * per  # every tile in one range, no range empty


def test_dim_major_copies_pad_with_zeros(rng):
    x = torch.from_numpy(rng.normal(size=(5, 33)).astype(np.float32))
    out = k7._dim_major(x, 128, 48)
    assert out.shape == (48, 128)
    assert torch.equal(out[:33, :5], x.T) and not bool(out[33:].any()) and not bool(out[:, 5:].any())
    tn = k7._padded(torch.arange(3.0), 128, k7.BIG)
    assert tn[:3].tolist() == [0.0, 1.0, 2.0] and bool((tn[3:] == np.float32(k7.BIG)).all())


def test_nn_invalid_train_rows_never_win(rng):
    t = rng.normal(size=(200, 33)).astype(np.float32)
    q = t[[3, 40, 41]].copy()
    tv = np.ones(200, bool)
    tv[[3, 40]] = False
    (ti, _td, tm), (ji, _jd, jm) = _both(q, t, np.ones(3, bool), tv)
    assert 3 not in ti[:1] and 40 not in ti[1:2] and ti[2] == 41
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tm, jm)
    # no valid train row at all: masked, index 0
    (ti, td, tm), (ji, _jd, jm) = _both(q, t, np.ones(3, bool), np.zeros(200, bool))
    assert not tm.any() and not jm.any() and (ti == 0).all()


def test_match_bf_k1_shapes_and_refusals(rng):
    q = torch.from_numpy(rng.normal(size=(50, 33)).astype(np.float32))
    v = torch.ones(50, dtype=torch.bool)
    idx, dist, mask = match_bf(q, q, v, v, k=1)
    assert idx.shape == dist.shape == mask.shape == (50, 1)
    # self-matches; the expansion leaves float32 noise of |q|^2 ~ 33 in d2
    assert idx[:, 0].tolist() == list(range(50)) and float(dist.max()) < 0.1
    # k > 1 is the exact top-k: the 40 nearest of a brute force, in order
    i40, d40, m40 = match_bf(q, q, v, v, k=40)
    assert i40.shape == d40.shape == m40.shape == (50, 40) and bool(m40.all())
    qn = q.numpy().astype(np.float64)
    want = np.argsort(((qn[:, None, :] - qn[None, :, :]) ** 2).sum(-1), axis=1)[:, :40]
    np.testing.assert_array_equal(i40.numpy(), want)
    # the bf16 matcher (norms of the float32 rows, dot products of the rows
    # rounded to bfloat16) against the JAX package's: the same self-matches;
    # the residual d2 is the rounding's, so both stay under 0.5 here; d2
    # within 2e-6 of 2 |q|^2 (float32 sums in another order)
    from lidar_global_registration_tpu.ops.matchers import match_bf as jmatch_bf

    bi, bd, bm = match_bf(q, q, v, v, k=1, bf16=True)
    ji, jd, jm = (np.asarray(a) for a in jmatch_bf(jnp.asarray(q.numpy()), jnp.asarray(q.numpy()),
                                                  jnp.asarray(v.numpy()), jnp.asarray(v.numpy()),
                                                  k=1, bf16=True))
    np.testing.assert_array_equal(bi.numpy(), ji)
    np.testing.assert_array_equal(bm.numpy(), jm)
    assert bi[:, 0].tolist() == list(range(50)) and float(bd.max()) < 0.5
    n2 = 2.0 * (q.numpy() ** 2).sum(1)
    assert (np.abs(bd.numpy()[:, 0] ** 2 - jd[:, 0] ** 2) <= 2e-6 * n2).all()

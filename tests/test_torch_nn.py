"""Parity: the PyTorch port's descriptor 1-NN (K7) against the JAX
package's Pallas kernel nn_l2_pallas in interpret mode.

On the CPU the port runs the plain PyTorch version of its CUDA kernel.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_global_registration_tpu.ops.pallas.topk_l2 import nn_l2_pallas
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        match_bf(q, q, v, v, k=1, bf16=True)

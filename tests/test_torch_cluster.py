"""Parity: the PyTorch port's cluster matching pieces against the JAX
package: the exact same-set top-k (match_bf(k=40, exclude_diag=True)),
pyramid._cluster_distances, flagship._consensus_keep and
_kp_density_nearest, each fed the JAX package's own inputs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_global_registration_tpu.models import flagship as jfl
from lidar_global_registration_tpu.models.pyramid import _cluster_distances as jax_cd
from lidar_global_registration_tpu.ops.matchers import match_bf as jax_match_bf
from lidar_global_registration_tpu_torch.models import flagship as tfl
from lidar_global_registration_tpu_torch.models.pyramid import _cluster_distances
from lidar_global_registration_tpu_torch.ops.matchers import match_bf

torch.set_num_threads(2)

T = torch.from_numpy
KC = 40


def _keypoints(rng, M=1500, n_valid=1400):
    """Keypoint-like positions on a 40 m x 40 m terrain, centred, with a
    padded tail."""
    xy = rng.uniform(-20, 20, size=(M, 2))
    z = 0.5 * np.sin(0.3 * xy[:, 0]) + 0.2 * rng.normal(size=M)
    p = np.column_stack([xy, z]).astype(np.float32)
    return p, np.arange(M) < n_valid


@pytest.fixture(scope="module")
def knn():
    rng = np.random.default_rng(566)
    out = {}
    for side in ("q", "t"):
        p, v = _keypoints(rng)
        j = tuple(np.asarray(a) for a in jax_match_bf(
            jnp.asarray(p), jnp.asarray(p), jnp.asarray(v), jnp.asarray(v), k=KC,
            tile=512, approx=False, exclude_diag=True))
        t = tuple(a.numpy() for a in match_bf(T(p), T(p), T(v), T(v), k=KC, tile=512,
                                               exclude_diag=True))
        out[side] = (p, v, j, t)
    return out


def test_topk_exclude_diag_matches_jax(knn):
    for p, v, (ji, jd, jm), (ti, td, tm) in knn.values():
        np.testing.assert_array_equal(tm, jm)
        assert not tm[~v].any() and tm[v].all()
        # no row holds itself
        assert not (ti == np.arange(len(v))[:, None])[tm].any()
        # Gram-trick distances: float32 |q|^2 + |t|^2 - 2 q.t, the matmul
        # summing in another order; |q|^2 up to ~800 m^2 (ulp 6e-5) leaves a
        # few 1e-4 absolute in d2, whatever the distance
        np.testing.assert_allclose(td[tm] ** 2, jd[jm] ** 2, rtol=0, atol=5e-4)
        # neighbour sets are equal except at distance ties inside that
        # rounding: compare the rows whose last two kept distances are
        # apart (measured: 30 and 24 of the 1,400 rows per side have them
        # within 1e-3; all 1,400 sets are equal all the same)
        last, nxt = jd[:, KC - 2], jd[:, KC - 1]
        clear = v & (nxt - last > 1e-3)
        same = [set(ti[r]) == set(ji[r]) for r in np.nonzero(clear)[0]]
        assert all(same) and clear.sum() > 0.9 * v.sum()


def test_cluster_distances_and_consensus_keep_match_jax(knn):
    rng = np.random.default_rng(7)
    (pq, vq, jq, _tq), (pt, vt, jt, _tt) = knn["q"], knn["t"]
    Mq, Mt = len(vq), len(vt)
    # matches: half the rows map to their true counterpart's neighbourhood
    i_st = rng.integers(0, Mt, Mq).astype(np.int32)
    i_st[:700] = np.arange(700)
    m_st = vq & (rng.random(Mq) < 0.95)
    i_ts = rng.integers(0, Mq, Mt).astype(np.int32)
    i_ts[:700] = np.arange(700)
    m_ts = vt & (rng.random(Mt) < 0.95)
    jd_i = np.asarray(jax_cd(jnp.asarray(i_st), jnp.asarray(m_st), *(jnp.asarray(a) for a in
                                                                   (jq[0], jq[2], jt[0], jt[2]))))
    td_i = _cluster_distances(T(i_st.astype(np.int64)), T(m_st),
                              *(T(np.array(a, np.int64) if a.dtype == np.int32 else np.array(a))
                                for a in (jq[0], jq[2], jt[0], jt[2]))).numpy()
    np.testing.assert_array_equal(td_i, jd_i)
    assert 0 < (td_i < 0.95).sum() < Mq
    for K in (1024, 60):
        jcfg = jfl.FlagshipConfig(max_correspondences=K)
        jkeep = np.asarray(jfl._consensus_keep(
            *(jnp.asarray(a) for a in (i_st, m_st, i_ts, m_ts)),
            tuple(jnp.asarray(a) for a in jq), tuple(jnp.asarray(a) for a in jt), jcfg))
        tkeep = tfl._consensus_keep(
            T(i_st.astype(np.int64)), T(m_st), T(i_ts.astype(np.int64)), T(m_ts),
            tuple(T(np.array(a, np.int64 if a.dtype == np.int32 else a.dtype)) for a in jq),
            tuple(T(np.array(a, np.int64 if a.dtype == np.int32 else a.dtype)) for a in jt),
            tfl.config_from_jax(dataclasses.asdict(jcfg))).numpy()
        np.testing.assert_array_equal(tkeep, jkeep)
        # 1024 keeps every survivor of the 0.95 gates; 60 bites, and keeps
        # every row at or below the 60th score (ties may exceed 60)
        assert (tkeep.sum() > 60) if K == 1024 else (60 <= tkeep.sum() < 100)


def test_kp_density_nearest_matches_jax(knn):
    for _p, _v, (ji, jd, jm), _t in knn.values():
        j = np.asarray(jfl._kp_density_nearest(jnp.asarray(ji[:, :1]), jnp.asarray(jd[:, :1]),
                                               jnp.asarray(jm[:, :1])))
        t = tfl._kp_density_nearest(T(ji[:, :1].astype(np.int64)), T(np.array(jd[:, :1])),
                                    T(np.array(jm[:, :1]))).numpy()
        np.testing.assert_array_equal(t, j)
        assert (t > 0).sum() > 1000


def test_compact_mutual_stage_equals_full_rows(rng):
    """Without cluster matching (the keypoint-any route with at most half
    the rows carrying descriptors) the compacted stage gives the mutual
    correspondences and thresholds of the full-row stage."""
    N, D = 3000, 33
    fq = rng.random((N, D)).astype(np.float32)
    ft = (fq + rng.normal(scale=0.05, size=(N, D))).astype(np.float32)
    fq_v = rng.random(N) < 0.4
    ft_v = rng.random(N) < 0.45
    dens_s = rng.uniform(0, 0.5, N).astype(np.float32)
    dens_t = rng.uniform(0, 0.5, N).astype(np.float32)
    fq_v_t, ft_v_t = T(fq_v), T(ft_v)
    i_st, _d, m_st = match_bf(T(fq), T(ft), fq_v_t, ft_v_t)
    i_ts, _d, m_ts = match_bf(T(ft), T(fq), ft_v_t, fq_v_t)
    j, keep, thr = tfl._correspondence_stage(i_st, m_st, i_ts, m_ts, T(dens_s), T(dens_t), 0.3)
    n_q, n_t = int(fq_v.sum()), int(ft_v.sum())
    mq, mt = tfl._pad_quantum(n_q), tfl._pad_quantum(n_t)
    sqj, stj = tfl._compact_rows(fq_v_t, n_q, mq), tfl._compact_rows(ft_v_t, n_t, mt)
    sq_g, st_g = sqj.clamp_max(N - 1), stj.clamp_max(N - 1)
    xyz = torch.zeros((N, 3))
    cfg = tfl.FlagshipConfig(use_iss=False)
    cj, ckeep, cthr = tfl._compact_match_corr_stage(
        T(fq)[sq_g], T(ft)[st_g], torch.arange(mq) < n_q, torch.arange(mt) < n_t, sqj, stj,
        sq_g, st_g, xyz, xyz, T(dens_s), T(dens_t), 0.3, cfg, kc=2)
    assert 0 < int(keep.sum()) < n_q
    assert torch.equal(ckeep, keep)
    assert torch.equal(cj[keep], j[keep]) and torch.equal(cthr[keep], thr[keep])

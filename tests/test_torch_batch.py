"""The PyTorch port's batched-pairs API (parallel/batch.make_register_batch)
against its own single-pair step and against the JAX package's mesh step.

On one device the batch is a loop of models/flagship.register_pair_step
over the pairs, so each pair's outputs must be torch.equal to the step's on
the same pair and seed.  The JAX package's make_register_batch shards the
pairs over dp and each pair's rows over tp (here 2 pairs on a dp = 2,
tp = 2 mesh of its virtual CPU devices), a re-tiling of its own step
(tests/test_tp_feature_sharding.py).  RANSAC draws differ between the
packages, so the two batches are compared at the pose level: each finds
every pair's known pose.  The pairs are the 1,024-point pair and the
FlagshipConfig of JAX's test_tp2_matches_single_device (ISS keypoints),
the second pair's target turned and moved by a known transform.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_pair
from lidar_global_registration_tpu.models import flagship as jfl
from lidar_global_registration_tpu.parallel.batch import make_register_batch as jbatch
from lidar_global_registration_tpu.parallel.mesh import make_mesh, pair_sharding
from lidar_global_registration_tpu_torch.models import flagship as tfl
from lidar_global_registration_tpu_torch.ops.transform import rotation_translation_error
from lidar_global_registration_tpu_torch.parallel.batch import make_register_batch

torch.set_num_threads(2)

N = 1024
CFG = dict(rounds=4, hypothesis_batch=256, use_iss=True)  # test_tp2_matches_single_device
SEEDS = (566, 567)
R_MAX = 0.05  # rad; with the translation under distance_thr, bench.py:327's rule


def _turn(deg: float, shift) -> np.ndarray:
    a = np.deg2rad(deg)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
    T[:3, 3] = shift
    return T


@pytest.fixture(scope="module")
def batch():
    """Two pairs: the synthetic pair (target = R^T (source - t), R a turn
    of 0.4 rad about z, t = (2, -1, 0.5)) and the same with its target
    under M = a 25 degree turn and a shift; the per-pair scalars of
    tests/test_flagship_parallel._args in float32; viewpoints at the
    origin (zeros)."""
    a, b = _synthetic_pair(N, seed=566)
    R = np.array([[np.cos(0.4), -np.sin(0.4), 0], [np.sin(0.4), np.cos(0.4), 0], [0, 0, 1]])
    T0 = np.eye(4)
    T0[:3, :3], T0[:3, 3] = R.T, -R.T @ np.array([2.0, -1.0, 0.5])
    M = _turn(25.0, [3.0, 1.0, -0.5]).astype(np.float64)
    b1 = (b @ M[:3, :3].T + M[:3, 3]).astype(np.float32)
    spacing = 30.0 / np.sqrt(N)
    row = np.float32([spacing * 4, spacing * 2, spacing * 2, spacing * 3, spacing * 3,
                      spacing * 8, spacing * 4])
    return dict(src=np.stack([a, a]), tgt=np.stack([b, b1]), valid=np.ones((2, N), bool),
                scalars=np.stack([row, row]), vps=np.zeros((2, 2, 3), np.float32),
                T_gt=np.stack([T0, M @ T0]))


@pytest.fixture(scope="module")
def port_batch(batch):
    t = {k: torch.from_numpy(batch[k].copy()) for k in ("src", "tgt", "valid", "scalars", "vps")}
    cfg = tfl.config_from_jax(jfl.FlagshipConfig(**CFG).__dict__)
    out = make_register_batch(cfg)(t["src"], t["valid"], t["tgt"], t["valid"], SEEDS,
                                   t["scalars"], t["vps"])
    return t, cfg, out


def test_each_pair_equals_the_single_pair_step(port_batch):
    """The batch's T [2, 4, 4], inliers [2] and n_correspondences [2] are
    torch.equal to register_pair_step on each pair with its seed, and a
    torch.Generator in place of a seed gives the same."""
    t, cfg, (T, inl, nc) = port_batch
    assert T.shape == (2, 4, 4) and inl.shape == nc.shape == (2,)
    for i, seed in enumerate(SEEDS):
        o = tfl.register_pair_step(t["src"][i], t["valid"][i], t["tgt"][i], t["valid"][i],
                                   torch.Generator().manual_seed(seed),
                                   *t["scalars"][i].tolist(), vp_src=t["vps"][i, 0],
                                   vp_tgt=t["vps"][i, 1], cfg=cfg)
        assert torch.equal(T[i], o["transformation"])
        assert torch.equal(inl[i], o["inliers"]) and torch.equal(nc[i], o["n_correspondences"])
    gens = [torch.Generator().manual_seed(s) for s in SEEDS]
    T2, inl2, nc2 = make_register_batch(cfg)(t["src"][:1], t["valid"][:1], t["tgt"][:1],
                                             t["valid"][:1], gens[:1], t["scalars"][:1],
                                             t["vps"][:1])
    assert torch.equal(T2[0], T[0]) and torch.equal(inl2[0], inl[0])
    with pytest.raises(ValueError, match="one seed"):
        make_register_batch(cfg)(t["src"], t["valid"], t["tgt"], t["valid"], SEEDS[:1],
                                 t["scalars"], t["vps"])


def test_port_and_jax_batches_find_every_pose(batch, port_batch):
    """JAX's mesh step (dp = 2, tp = 2) and the port's batch each register
    both pairs under bench.py:327's rule: within 0.05 rad and distance_thr
    (3.75) of the known pose, with at least 10 inliers (measured: JAX 0.019 /
    0.025 rad, 0.46 / 0.40, 14 / 14 inliers; the port 0.010 / 0.033 rad,
    0.22 / 0.45, 16 / 15)."""
    mesh = make_mesh(4, tp=2)
    put = lambda x: jax.device_put(jnp.asarray(x), pair_sharding(mesh))  # noqa: E731
    keys = jnp.stack([jax.random.PRNGKey(s) for s in SEEDS])
    jT, jinl, _jnc = jbatch(mesh, jfl.FlagshipConfig(**CFG))(
        put(batch["src"]), put(batch["valid"]), put(batch["tgt"]), put(batch["valid"]),
        put(keys), put(batch["scalars"]), put(batch["vps"]))
    _t, _cfg, (T, inl, _nc) = port_batch
    for name, Ts, inls in (("jax", np.array(jT), np.asarray(jinl)),
                           ("port", T.numpy(), inl.numpy())):
        for i in range(2):
            r, tr = rotation_translation_error(torch.from_numpy(Ts[i]).double(),
                                               torch.from_numpy(batch["T_gt"][i]))
            thr = float(batch["scalars"][i, 6])
            assert float(r) < R_MAX and float(tr) < thr, (name, i, float(r), float(tr))
            assert int(inls[i]) >= 10, (name, i, int(inls[i]))

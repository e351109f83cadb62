"""Parity: the PyTorch port's ISS keypoints (K2 count, K3 saliency, K4
NMS) against the JAX package's Pallas ISS cells in interpret mode, on the
box fixture of tests/test_cell_iss.py.

On the CPU the port runs the plain PyTorch versions of its CUDA kernels
(csrc/iss.cu); the wrappers of the kernels refuse CPU tensors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_global_registration_tpu.ops.pallas import cellgrid as jcg
from lidar_global_registration_tpu_torch.ops import cellgrid as cg
from test_cell_iss import _boxy_cloud

torch.set_num_threads(2)

RADIUS = 0.35


@pytest.fixture(scope="module")
def box():
    pts = _boxy_cloud(np.random.default_rng(566))
    N = len(pts)
    pad = 1 << (N - 1).bit_length()
    xyz = np.zeros((pad, 3), np.float32)
    xyz[:N] = pts
    valid = np.arange(pad) < N
    jplan = jcg.plan_grid(jnp.asarray(xyz), jnp.zeros((pad, 3), jnp.float32),
                          jnp.asarray(valid), RADIUS, exact=True)
    jkp, jsal = (np.asarray(v) for v in jcg.iss_pass(jplan, RADIUS, interpret=True))
    plan = cg.plan_grid(torch.from_numpy(xyz), torch.from_numpy(valid), RADIUS)
    tkp, tsal = (v.numpy() for v in cg.iss_pass(plan, RADIUS))
    return dict(xyz=xyz, valid=valid, plan=plan, jkp=jkp, jsal=jsal, tkp=tkp, tsal=tsal)


def test_iss_pass_matches_jax(box):
    jkp, jsal, tkp, tsal = box["jkp"], box["jsal"], box["tkp"], box["tsal"]
    assert not tkp[~box["valid"]].any() and np.all(tsal[~box["valid"]] == 0.0)
    # saliency (the smallest eigenvalue of the weighted scatter) where both
    # passed the gamma gates: the TPU kernel shifts block-centred moments,
    # the port sums query-centred ones.  l3 of a noisy plane (~3e-5) is a
    # float32 cancellation residue of a trace ~1e-2: measured up to 2.4e-7
    # apart (1.3e-2 relatively above 1e-5), inside the bounds
    # tests/test_cell_iss.py sets for the TPU kernel
    on = (jsal > 0) & (tsal > 0)
    np.testing.assert_allclose(tsal[on], jsal[on], rtol=2e-3, atol=3e-7)
    # the gamma decision may flip where a ratio sits within rounding of
    # 0.975 (test_cell_iss.py: < 5e-3 flips, > 0.995 keypoint agreement);
    # measured here: 0 flips, the same 148 keypoints
    flip = (jsal > 0) != (tsal > 0)
    assert flip.mean() < 5e-3, flip.mean()
    assert (jkp == tkp).mean() > 0.995
    assert jkp.sum() > 10
    assert (jkp & tkp).sum() >= 0.9 * max(jkp.sum(), tkp.sum())


def test_iss_count_equals_brute_force(box):
    """K2's plain version: points within r, self included, exactly."""
    plan = box["plan"]
    r2 = cg._f32_square(RADIUS)
    count = cg.iss_count_plain(plan, r2).numpy()
    p = box["xyz"][box["valid"]]
    d = p[None, :, :] - p[:, None, :]
    want = ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])
            <= np.float32(r2)).sum(1)
    rows = np.nonzero(box["valid"])[0]
    got = np.zeros(len(box["valid"]), np.int64)
    got[plan.order[:plan.n_valid].numpy()] = count
    np.testing.assert_array_equal(got[rows], want)


def test_iss_nms_is_a_strict_local_maximum(box):
    """K4's plain version on a given saliency: a keypoint passed K3, has
    >= 4 neighbours within r (self excluded) and a saliency strictly above
    each of theirs."""
    plan = box["plan"]
    r2 = cg._f32_square(RADIUS)
    n = plan.n_valid
    rng = np.random.default_rng(3)
    sal = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
    sal[::7] = sal[1::7][: sal[::7].shape[0]]  # exact ties must not survive
    okq = torch.from_numpy(rng.random(n) < 0.8)
    kp = cg.iss_nms_plain(plan, r2, sal, okq, 4).numpy()
    p = plan.pts[:n, :3].numpy()
    d = p[None, :, :] - p[:, None, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    nb = (d2 <= np.float32(r2)) & (d2 > 0)
    s = sal.numpy()
    nb_max = np.where(nb, s[None, :], -np.inf).max(1)
    want = okq.numpy() & (nb.sum(1) >= 4) & (s > nb_max)
    np.testing.assert_array_equal(kp, want)
    assert want.sum() > 10


def test_iss_kernels_refuse_cpu_tensors(box):
    plan = box["plan"]
    r2 = cg._f32_square(RADIUS)
    count = cg.iss_count_plain(plan, r2)
    sal, okq, _nnb = cg.iss_saliency_plain(plan, r2, count, 0.975, 0.975)
    for call in (lambda: cg.iss_count_cuda(plan, r2),
                 lambda: cg.iss_saliency_cuda(plan, r2, count, 0.975, 0.975),
                 lambda: cg.iss_nms_cuda(plan, r2, sal, okq, 4)):
        with pytest.raises(ValueError, match="CUDA"):
            call()

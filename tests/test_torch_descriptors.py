"""Parity: the PyTorch port's RoPS-135 (ops/rops.py), USC-1960
(ops/usc.py), ground-truth frames (ops/lrf.gt_lrf) and the r / 5 counts
behind both descriptors' weights against the JAX package's.

The scene is a noisy Fibonacci sphere squashed to an ellipsoid (axes 1,
0.55, 0.3 of radius 5), so that most SHOT LRFs are well defined (on a
sphere the two tangent eigenvalues tie and the x axis is a coin flip in
either package), with 150 keypoints from another sampling of it.  At the
radius 1.2 no grid cell holds more than the JAX package's cap of 128
points, so the two neighbour sets are the same (the port's are exact).  On
the CPU the port counts the r / 5 neighbours with K2's plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_global_registration_tpu.ops import grid as jgrid
from lidar_global_registration_tpu.ops import lrf as jlrf
from lidar_global_registration_tpu.ops import rops as jrops
from lidar_global_registration_tpu.ops import usc as jusc
from lidar_global_registration_tpu_torch.ops import lrf as tlrf
from lidar_global_registration_tpu_torch.ops import rops as trops
from lidar_global_registration_tpu_torch.ops import usc as tusc
from test_torch_analysis import max_bucket, sphere

torch.set_num_threads(2)

RADIUS = 1.2
SQUASH = np.array([1.0, 0.55, 0.3], np.float32)
M = 150


def _gt(angle: float = 0.3) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(angle), np.sin(angle)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[:3, 3] = [1.0, -2.0, 0.5]
    return T


@pytest.fixture(scope="module")
def scene():
    surf = sphere(31)[0] * SQUASH
    kp = sphere(32, n=M)[0] * SQUASH
    return surf, kp


def _run(scene, name, frames):
    surf, kp = scene
    jfn, tfn = {"rops": (jrops.rops, trops.rops), "usc": (jusc.usc, tusc.usc)}[name]
    kw_j, kw_t = {}, {}
    if frames:
        kw_j["frames"] = jlrf.gt_lrf(M, jnp.asarray(_gt()))
        kw_t["frames"] = tlrf.gt_lrf(M, _gt(), "cpu")
    jd, jv = jfn(jnp.asarray(kp), jnp.ones(M, bool), jnp.asarray(surf), jnp.ones(len(surf), bool),
                 RADIUS, approx=False, **kw_j)
    td, tv = tfn(torch.from_numpy(kp), torch.ones(M, dtype=torch.bool), torch.from_numpy(surf),
                 torch.ones(len(surf), dtype=torch.bool), RADIUS, **kw_t)
    return np.asarray(jd), np.asarray(jv), td.numpy(), tv.numpy()


def test_scene_is_under_the_caps(scene):
    surf, kp = scene
    assert max_bucket(surf, RADIUS) <= 128 and max_bucket(surf, RADIUS / 5) <= 128
    d2 = ((surf[None] - kp[:, None]) ** 2).sum(-1)
    n_nb = (d2 <= RADIUS ** 2).sum(1)
    assert n_nb.min() >= 5 and n_nb.max() <= 384


def test_gt_lrf_matches_jax():
    """The constant frame: the rows of inv(R_gt)^T, repeated, equal to the
    JAX function's within a float32 rounding of the inverse (both invert in
    float32: measured 6e-8), and the identity for the identity."""
    want = np.asarray(jlrf.gt_lrf(7, jnp.asarray(_gt())))
    got = tlrf.gt_lrf(7, _gt(), "cpu")
    assert got.shape == (7, 3, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert torch.equal(tlrf.gt_lrf(3, np.eye(4), "cpu"), torch.eye(3).expand(3, 3, 3))


@pytest.mark.parametrize("name", ["rops", "usc"])
def test_descriptor_with_given_frames_matches_jax(scene, name):
    """With the gt frames every neighbour's bin is the same: the same valid
    rows, values within 1e-5 of the largest (float32 sums in another order;
    measured 4.5e-6 of 5.3 for RoPS, 5.7e-6 of 26 for USC)."""
    jd, jv, td, tv = _run(scene, name, frames=True)
    np.testing.assert_array_equal(tv, jv)
    assert tv.all() and td.shape == (M, {"rops": 135, "usc": 1960}[name])
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-5 * np.abs(jd).max())


@pytest.mark.parametrize("name,max_rows", [("rops", 3), ("usc", 3)])
def test_descriptor_with_default_frames_matches_jax(scene, name, max_rows):
    """Each package's own SHOT LRF over the same neighbours: the same valid
    rows, and all but a few keypoints within 1e-5 of the largest value.
    The rest have frames that float32 rounding decides (near-equal
    eigenvalues, a sign on a balanced count) or a neighbour on a bin edge
    (USC's arccos and log): measured 2 of 150 RoPS and 1 of 150 USC rows."""
    jd, jv, td, tv = _run(scene, name, frames=False)
    np.testing.assert_array_equal(tv, jv)
    off = (np.abs(td - jd) > 1e-5 * np.abs(jd).max()).any(1)
    assert off.sum() <= max_rows, off.sum()


def test_usc_layout_and_weights():
    """bin_index is PCL's azimuth-major v_index; one neighbour on the frame's
    x axis at 0.5 r adds 1 / (density x cbrt(volume)) to (radius shell 6,
    elevation 7, azimuth 0)."""
    assert tusc.bin_index(1, 2, 3) == jusc.bin_index(1, 2, 3) == (3 * 14 + 2) * 10 + 1
    kp = torch.zeros((1, 3))
    surf = torch.tensor([[0.5, 0.0, 0.0]] + [[9.0, 9.0, 9.0]] * 4)
    frames = torch.eye(3)[None]
    idx = torch.tensor([[0, 1, 2, 3, 4]])
    mask = torch.tensor([[True, False, False, False, False]])
    dens = torch.full((1, 5), 2.0)
    t = tusc.usc_from_neighbors(kp, frames, surf, idx, mask, dens, 1.0)
    j = np.asarray(jusc.usc_from_neighbors(jnp.asarray(kp.numpy()), jnp.asarray(frames.numpy()),
                                           jnp.asarray(surf.numpy()), jnp.asarray(idx.numpy()),
                                           jnp.asarray(mask.numpy()), jnp.asarray(dens.numpy()),
                                           1.0))
    nz = np.nonzero(t[0].numpy())[0]
    assert list(nz) == list(np.nonzero(j[0])[0]) == [tusc.bin_index(6, 7, 0)]
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-6)


def test_r5_counts_equal_jax():
    """The r / 5 counts: K2's self-inclusive count clamped at density_k + 1
    (ops/rops.density_weights, the plain version here) against the JAX
    package's self-excluded density_k-nearest count plus one, on a cloud
    with a dense blob where the clamp binds (up to 80 points within r / 5)
    and isolated points (a count of 1).  Equal row for row."""
    rng = np.random.default_rng(3)
    r5 = RADIUS / 5
    pts = np.concatenate([rng.uniform(-3, 3, size=(1500, 3)) * [1, 1, 0.1],
                          rng.normal(scale=0.05, size=(80, 3)) + [0.3, 0.3, 0.0],
                          [[50.0, 50.0, 50.0]]]).astype(np.float32)
    valid = np.ones(len(pts), bool)
    assert max_bucket(pts, r5) <= 128
    g5 = jgrid.build_grid(jnp.asarray(pts), jnp.asarray(valid), r5, cell_cap=128)
    _i, _d, m5 = jgrid.radius_neighbors(g5, jnp.asarray(pts), jnp.asarray(valid), r5, k=48,
                                        cap=128, include_self=False,
                                        query_index=jnp.arange(len(pts), dtype=jnp.int32))
    want = np.asarray(m5).sum(1) + 1.0
    got = trops.density_weights(torch.from_numpy(pts), torch.from_numpy(valid), RADIUS, 48)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() == 49 and want.min() == 1

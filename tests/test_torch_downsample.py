"""Parity: the PyTorch port's voxel-centroid downsampling and the
loader-equivalent pre-downsample against the JAX package: the voxel
partition, the z-major output order, `row_of`, the counts and the padded
capacities are equal exactly; centroids agree to float32 rounding."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_global_registration_tpu.models import flagship as jfl
from lidar_global_registration_tpu.ops import downsample as jds
from lidar_global_registration_tpu_torch.models import flagship as tfl
from lidar_global_registration_tpu_torch.ops import downsample as tds

torch.set_num_threads(2)


def _cloud(seed, N=4096, pad=128, deep=True):
    """The fixture of test_grid_downsample.py's map-packed test: a box of
    points, one voxel holding 200 of them, a masked pad tail."""
    rng = np.random.default_rng(seed)
    pts = np.column_stack([
        rng.uniform(0, 11, N), rng.uniform(0, 7, N), rng.uniform(0, 2, N)
    ]).astype(np.float32)
    if deep:
        pts[1000:1200] = np.float32([5.2, 3.3, 1.1]) + rng.uniform(
            0, 0.05, (200, 3)).astype(np.float32)
    valid = np.arange(N) < N - pad
    return pts, valid


@pytest.mark.parametrize("voxel", [0.55, 0.23])
def test_voxel_centroids_map_matches_jax(voxel):
    pts, valid = _cloud(11)
    jx, jv, jrow, jn = (np.asarray(v) for v in jds.voxel_centroids_map(
        jnp.asarray(pts), jnp.asarray(valid), voxel))
    aabb = np.asarray(jfl._aabb_pair(jnp.asarray(pts), jnp.asarray(valid),
                                     jnp.asarray(pts), jnp.asarray(valid)))
    bits = jfl._voxel_bits(aabb[0, 0], aabb[0, 1], voxel)
    px, pv, prow, pn = (np.asarray(v) for v in jds.voxel_centroids_map_packed(
        jnp.asarray(pts), jnp.asarray(valid), voxel, bits))
    tx, tv, trow, tn = tds.voxel_centroids_map(torch.from_numpy(pts),
                                               torch.from_numpy(valid), voxel)
    tx, tv, trow = tx.numpy(), tv.numpy(), trow.numpy()
    assert int(tn) == int(jn) == int(pn)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(trow[valid], jrow[valid])
    np.testing.assert_array_equal(trow[valid], prow[valid])
    # JAX's lexsort route averages raw coordinates, its packed route and the
    # port sum residuals against the voxel corner: float32 rounding of a
    # coordinate up to 11 m (ulp 9.5e-7) and of the mean of up to 200 points
    np.testing.assert_allclose(tx[tv], jx[jv], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tx[tv], px[pv], rtol=0, atol=1e-5)
    assert np.all(tx[~tv] == 0.0)


def test_voxel_centroids_packed_matches_jax():
    pts, valid = _cloud(5, deep=False)
    voxel = 0.55
    aabb = np.asarray(jfl._aabb_pair(jnp.asarray(pts), jnp.asarray(valid),
                                     jnp.asarray(pts), jnp.asarray(valid)))
    bits = jfl._voxel_bits(aabb[0, 0], aabb[0, 1], voxel)
    origin = aabb[0, 0] - 0.5 * voxel
    jx, jv, jn = (np.asarray(v) for v in jds.voxel_centroids_packed(
        jnp.asarray(pts), jnp.asarray(valid), voxel, jnp.asarray(origin, jnp.float32), bits))
    tx, tv, tn = tds.voxel_centroids_packed(torch.from_numpy(pts), torch.from_numpy(valid),
                                            voxel, torch.from_numpy(origin.astype(np.float32)))
    assert int(tn) == int(jn)
    # the JAX rows sit at each run's first sorted slot; in key order they
    # are the port's front-compacted rows, row for row
    np.testing.assert_array_equal(tv.numpy(), np.arange(len(valid)) < int(jn))
    np.testing.assert_allclose(tx.numpy()[tv.numpy()], jx[jv], rtol=0, atol=2e-6)


def test_pre_downsample_pair_matches_jax():
    a, va = _cloud(21, N=6000, pad=0, deep=False)
    b, _vb = _cloud(22, N=6000, pad=0, deep=False)
    b = (b * np.float32([1.0, 1.3, 1.0]) + np.float32([40.0, -3.0, 2.0])).astype(np.float32)
    vb = np.arange(6000) < 5500
    vox_s, vox_t = 0.41, 0.47
    aabb = np.asarray(jfl._aabb_pair(jnp.asarray(a), jnp.asarray(va),
                                     jnp.asarray(b), jnp.asarray(vb)))
    jsx, jsv, jtx, jtv = (np.asarray(v) for v in jfl.pre_downsample_pair(
        jnp.asarray(a), jnp.asarray(va), jnp.asarray(b), jnp.asarray(vb), vox_s, vox_t,
        aabb=aabb))
    taabb = tfl._aabb_pair(torch.from_numpy(a), torch.from_numpy(va),
                           torch.from_numpy(b), torch.from_numpy(vb)).numpy()
    np.testing.assert_array_equal(taabb, aabb)
    tsx, tsv, ttx, ttv = (v.numpy() for v in tfl.pre_downsample_pair(
        torch.from_numpy(a), torch.from_numpy(va), torch.from_numpy(b),
        torch.from_numpy(vb), vox_s, vox_t))
    assert tsx.shape == jsx.shape and ttx.shape == jtx.shape  # one padded capacity
    assert tsx.shape[0] < a.shape[0]
    np.testing.assert_array_equal(tsv, jsv)
    np.testing.assert_array_equal(ttv, jtv)
    np.testing.assert_allclose(tsx[tsv], jsx[jsv], rtol=0, atol=1e-5)
    np.testing.assert_allclose(ttx[ttv], jtx[jtv], rtol=0, atol=1e-5)


def test_pad_quantum_and_compact_rows_exact(rng):
    for a in (1, 5, 1023, 1024, 1025, 9000, 147_123, 655_000):
        assert tfl._pad_quantum(a) == jfl._pad_quantum(a)
    v = rng.random(3000) < 0.3
    n = int(v.sum())
    for m in (jfl._pad_quantum(n), 4096):
        np.testing.assert_array_equal(
            tfl._compact_rows(torch.from_numpy(v), n, m).numpy(),
            np.asarray(jfl._compact_rows(jnp.asarray(v), n, m)))


def test_pre_downsample_refuses_unequal_capacities():
    a = torch.zeros((10, 3))
    with pytest.raises(ValueError, match="equal padded capacities"):
        tfl.pre_downsample_pair(a, torch.ones(10, dtype=torch.bool), torch.zeros((12, 3)),
                                torch.ones(12, dtype=torch.bool), 0.1, 0.1)

"""Parity: the PyTorch port's voxel-centroid downsampling and the
loader-equivalent pre-downsample against the JAX package: the voxel
partition, the z-major output order, `row_of`, the counts and the padded
capacities are equal exactly; centroids agree to float32 rounding."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_global_registration_tpu.models import flagship as jfl
from lidar_global_registration_tpu import types as jtypes
from lidar_global_registration_tpu.ops import downsample as jds
from lidar_global_registration_tpu_torch import types as ttypes
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


def _lone_cloud(scale, pad=64):
    """Voxel-centred clusters on a grid of every third voxel, half of them a
    single point (the known lone voxels), the rest 2-6 points within 0.2
    voxel of the centre, so the anchor (the cloud's min - voxel / 2) puts
    each cluster in one voxel of its own; unit normals and a masked pad tail.
    `scale` 0.1: coordinates in [-0.048, 0.037), voxel 0.004, a row of
    clusters centred on 0 on each axis (corners below half of their
    points); 1e3: 1e3 + [0, 3.84), voxel 0.16."""
    rng = np.random.default_rng(31)
    voxel = 0.004 if scale < 1 else 0.16
    offset = -0.054 if scale < 1 else 1e3
    g = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1).reshape(-1, 3)
    g = g[rng.permutation(len(g))]
    k = np.where(np.arange(len(g)) % 2 == 0, 1, rng.integers(2, 7, len(g)))
    centre = np.repeat((g * 3 + 1.5) * voxel, k, axis=0)
    pts = (offset + centre + rng.uniform(-0.2, 0.2, centre.shape) * voxel).astype(np.float32)
    order = rng.permutation(len(pts))
    pts, lone_pt = pts[order], np.repeat(k == 1, k)[order]
    nrm = rng.normal(size=pts.shape)
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    pts = np.concatenate([pts, np.full((pad, 3), 1e18, np.float32)])
    nrm = np.concatenate([nrm, np.zeros((pad, 3), np.float32)])
    valid = np.arange(len(pts)) < len(order)
    return pts, nrm, valid, np.concatenate([lone_pt, np.zeros(pad, bool)]), voxel


LONE_CASES = ([("voxel_downsample", w, s) for w in (1, 2, 3, 5, 7, 10) for s in (0.1, 1e3)]
              + [(f, None, s) for f in ("voxel_centroids_map", "voxel_centroids_packed")
                 for s in (0.1, 1e3)])


@pytest.mark.parametrize("form,weight,scale", LONE_CASES)
def test_lone_voxel_is_the_jax_row(form, weight, scale):
    """A voxel of one point is the row of the JAX route the form mirrors, bit
    for bit: (x * w) / w and (n * w) / w renormalised, weight w, in
    voxel_downsample; corner + (x - corner) in voxel_centroids_map (held
    against voxel_centroids_map_packed, the route JAX's staged path runs for
    its feature-scale maps when it is given the scene's bounds, as from the
    CLI) and in voxel_centroids_packed.  At weights 1 and 2 that is the
    point; at 3 it is not always (the target is JAX's arithmetic, not the
    point); the packed arithmetic moves some points whose corner lies below
    half of them.  Voxels of several points keep their float64 residual
    sums: the residual form's bits (packed=True on every row) and the
    file's tolerances against JAX, in units of the coordinate's ulp (1e-5
    and 2e-6 at coordinates up to 11, ulp 9.5e-7)."""
    pts, nrm, valid, lone_pt, voxel = _lone_cloud(scale)
    N = len(pts)
    tx, tv = torch.from_numpy(pts), torch.from_numpy(valid)
    jxyz, jvalid = jnp.asarray(pts), jnp.asarray(valid)
    if form == "voxel_downsample":
        w = np.where(valid, np.float32(weight), 0).astype(np.float32)
        ref = jds.voxel_downsample(jtypes.Cloud(xyz=jxyz, normal=jnp.asarray(nrm),
                                                weight=jnp.asarray(w), curvature=jnp.zeros(N),
                                                valid=jvalid), voxel)
        jx, jv, jn, jw = (np.asarray(v) for v in (ref.xyz, ref.valid, ref.normal, ref.weight))
        out = tds.voxel_downsample(ttypes.Cloud(xyz=tx, normal=torch.from_numpy(nrm),
                                                weight=torch.from_numpy(w),
                                                curvature=torch.zeros(N), valid=tv), voxel)
        px, pv, pn, pw = (v.numpy() for v in (out.xyz, out.valid, out.normal, out.weight))
        vox = torch.tensor(voxel, dtype=torch.float32)
        origin = tds.masked_min(tx, tv) - 0.5 * vox
        args = (tx, tv, voxel, origin, torch.from_numpy(w), torch.from_numpy(nrm))
        tol = 1e-5
    elif form == "voxel_centroids_map":
        aabb = np.asarray(jfl._aabb_pair(jxyz, jvalid, jxyz, jvalid))
        bits = jfl._voxel_bits(aabb[0, 0], aabb[0, 1], voxel)
        jx, jv, _jrow, _jn = (np.asarray(v) for v in jds.voxel_centroids_map_packed(
            jxyz, jvalid, jnp.float32(voxel), bits))
        px, pv, _prow, _pn = (v.numpy() for v in tds.voxel_centroids_map(tx, tv, voxel))
        vox = torch.tensor(voxel, dtype=torch.float32)
        args = (tx, tv, voxel, tds.masked_min(tx, tv) - 0.5 * vox)
        tol = 2e-6
    else:
        aabb = np.asarray(jfl._aabb_pair(jxyz, jvalid, jxyz, jvalid))
        bits = jfl._voxel_bits(aabb[0, 0], aabb[0, 1], voxel)
        origin = (aabb[0, 0] - 0.5 * voxel).astype(np.float32)
        jx, jv, _jn = (np.asarray(v) for v in jds.voxel_centroids_packed(
            jxyz, jvalid, voxel, jnp.asarray(origin), bits))
        px, pv, _pn = (v.numpy() for v in tds.voxel_centroids_packed(
            tx, tv, voxel, torch.from_numpy(origin)))
        args = (tx, tv, voxel, torch.from_numpy(origin))
        tol = 2e-6
    jx = jx[jv]  # the packed JAX rows sit at their runs' first slots: key order
    assert int(pv.sum()) == len(jx) and np.array_equal(pv, np.arange(N) < len(jx))
    px = px[pv]
    # the known lone voxels are the one-point runs of JAX's partition
    _cx, _cv, jrow, _n = (np.asarray(v) for v in jds.voxel_centroids_map(jxyz, jvalid, voxel))
    runs = np.bincount(jrow[valid], minlength=N)[:len(jx)]
    lone = runs == 1
    assert lone.sum() == lone_pt.sum() and np.array_equal(np.sort(jrow[lone_pt]),
                                                          np.nonzero(lone)[0])
    assert torch.equal(torch.from_numpy(px[lone]), torch.from_numpy(jx[lone]))
    if form == "voxel_downsample":
        for p, j in ((pn[pv], jn[jv]), (pw[pv], jw[jv])):
            assert torch.equal(torch.from_numpy(p[lone]), torch.from_numpy(j[lone]))
    point = np.zeros((N, 3), np.float32)
    point[jrow[lone_pt]] = pts[lone_pt]
    moved = np.any(px[lone] != point[:len(jx)][lone], axis=1)
    if weight is None:
        assert moved.any() == (scale < 1)  # corners below half their point
    elif weight in (None, 1, 2):
        assert not moved.any()
    elif weight == 3:
        assert moved.any()
    # several points: the residual form's bits, and JAX's within float32
    # rounding of the coordinate and the mean
    parent = tds._centroids(*args, packed=True)
    assert torch.equal(torch.from_numpy(px[~lone]), parent[0][:len(jx)][torch.from_numpy(~lone)])
    if form == "voxel_downsample":
        for p, acc in ((pw[pv], parent[4][0]), (pn[pv], parent[4][1])):
            assert torch.equal(torch.from_numpy(p[~lone]), acc[:len(jx)][~lone])
    ulps = float(np.spacing(np.float32(max(abs(pts[valid]).max(), 11.0))) / np.spacing(
        np.float32(11.0)))
    np.testing.assert_allclose(px[~lone], jx[~lone], rtol=0, atol=tol * ulps)


def test_fma32_rounds_once():
    """_fma32 (a lone normal's squared norm as XLA's CPU code forms it) is
    x * y + z rounded once to float32, as exact rational arithmetic rounds
    it (to nearest, ties to even): 3,000 cases, a quarter each random, with
    z cancelling x * y, with ties (products of 12-bit fractions), and where
    a float64 sum rounded to nearest lands on a float32 midpoint the exact
    sum lies just below (z of odd mantissa, x * y half its ulp less 2^-70 of
    it), which a second rounding would send to the even neighbour."""
    from fractions import Fraction

    rng = np.random.default_rng(3)
    n = 3000
    x, y = (rng.normal(size=n).astype(np.float32) for _ in range(2))
    z = (rng.normal(size=n) * 10.0 ** rng.integers(-12, 3, n)).astype(np.float32)
    k = n // 4
    z[:k] = (-(x[:k].astype(np.float64) * y[:k])).astype(np.float32)
    x[k:2 * k] = (rng.integers(1, 1 << 12, k) / 4096).astype(np.float32)
    y[k:2 * k] = x[k:2 * k]
    z[k:2 * k] = (rng.integers(1, 1 << 24, k) * 2.0 ** -24).astype(np.float32)
    e = 2.0 ** rng.integers(-20, 20, k)
    x[2 * k:3 * k] = np.float32(1 - 2.0 ** -23)
    y[2 * k:3 * k] = (2.0 ** -24 * (1 + 2.0 ** -23) * e).astype(np.float32)
    z[2 * k:3 * k] = ((2 ** 23 + 2 * rng.integers(0, 2 ** 22, k) + 1) * 2.0 ** -23 * e
                      ).astype(np.float32)
    got = tds._fma32(*(torch.from_numpy(v) for v in (x, y, z))).numpy()

    def rounded(exact):
        c = np.float32(float(exact))
        near = (c, np.nextafter(c, np.float32(np.inf)), np.nextafter(c, np.float32(-np.inf)))
        return min(near, key=lambda v: (abs(Fraction(float(v)) - exact), int(v.view(np.int32)) & 1))

    want = np.array([rounded(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))
                     for a, b, c in zip(x, y, z)], np.float32)
    np.testing.assert_array_equal(got, want)

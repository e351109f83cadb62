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
    count = cg.iss_count_plain(plan, r2)[0].numpy()
    p = box["xyz"][box["valid"]]
    d = p[None, :, :] - p[:, None, :]
    want = ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])
            <= np.float32(r2)).sum(1)
    rows = np.nonzero(box["valid"])[0]
    got = np.zeros(len(box["valid"]), np.int64)
    got[plan.order[:plan.n_valid].numpy()] = count
    np.testing.assert_array_equal(got[rows], want)


@pytest.mark.parametrize("cell_over_r", [1.0, 1.545, 4.0])
def test_iss_count_returns_the_reciprocal_weight(box, cell_over_r):
    """K2's second output is K3's weight of each point, 1 / max(count, 1),
    the IEEE float32 quotient bit for bit (numpy's float32 division rounds
    the same way), on plans whose cell is 1, 1.545 and 4 radii; K3 fed with
    it equals K3's own formula on the counts."""
    plan = cg.plan_grid(torch.from_numpy(box["xyz"]), torch.from_numpy(box["valid"]),
                        RADIUS * cell_over_r)
    r2 = cg._f32_square(RADIUS)
    count, inv = cg.iss_count_plain(plan, r2)
    assert count.dtype == torch.int32 and inv.dtype == torch.float32
    assert count.shape == inv.shape == (plan.n_valid,)
    assert int(count.min()) >= 1  # every query counts itself
    want = np.float32(1.0) / np.maximum(count.numpy().astype(np.float32), np.float32(1.0))
    assert want.dtype == np.float32
    np.testing.assert_array_equal(inv.numpy().view(np.uint32), want.view(np.uint32))
    # the counts do not depend on the plan's cell
    base, _ = cg.iss_count_plain(box["plan"], r2)
    got = torch.zeros(len(box["valid"]), dtype=torch.int32)
    got[plan.order[:plan.n_valid]] = count
    ref = torch.zeros_like(got)
    ref[box["plan"].order[:box["plan"].n_valid]] = base
    assert torch.equal(got, ref)


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
    _count, inv = cg.iss_count_plain(plan, r2)
    sal, okq, _nnb = cg.iss_saliency_plain(plan, r2, inv, 0.975, 0.975)
    for call in (lambda: cg.iss_count_cuda(plan, r2),
                 lambda: cg.iss_saliency_cuda(plan, r2, inv, 0.975, 0.975),
                 lambda: cg.iss_nms_cuda(plan, r2, sal, okq, 4)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


# ---------------------------------------------------------------------------
# K4's walk leaves out stencil columns beyond the radius (csrc/cellgrid.cuh
# near_columns); cg.near_columns is its plain mirror
# ---------------------------------------------------------------------------
R_EXACT = 0.625  # 5/8: (3/8, 4/8, 0) has float32 d2 == r2 exactly


def _skip_cloud(kind: str, cell: float, rng) -> np.ndarray:
    n = 3000
    if kind == "random":
        return rng.uniform(0, 14, (n, 3)).astype(np.float32) * [1, 1, 0.15]
    if kind == "faces":
        # the plan's faces lie at (k + 1/2) widened cells above the lowest
        # point: every coordinate on one with probability 1/2, so points sit on
        # faces, edges and corners of their cells, up to float32 rounding
        w = cell * (1.0 + cg._CELL_MARGIN)
        k = rng.integers(0, 6, (n, 3))
        x = np.where(rng.random((n, 3)) < 0.5, (k + 0.5) * w, rng.uniform(0, 6 * w, (n, 3)))
        x[0] = 0.0  # the lowest point, which fixes the grid's corner
        return (x * [1, 1, 0.3]).astype(np.float32)
    # pairs at exactly d2 == r2: a on a 1/1024 lattice, b = a + (3/8, 4/8, 0)
    a = rng.integers(0, 12 * 1024, (n // 2, 3)) / 1024.0 * [1, 1, 0.1]
    return np.concatenate([a, a + [0.375, 0.5, 0.0]]).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "faces", "exact"])
@pytest.mark.parametrize("cell_over_r", [1.0, 1.545, 4.0])
def test_near_columns_keep_every_neighbour(kind, cell_over_r):
    """No pair with float32 d2 <= r2, as the kernels compute it, lies in a
    stencil column that the skip rule leaves out."""
    cell = R_EXACT * cell_over_r
    xyz = torch.from_numpy(_skip_cloud(kind, cell, np.random.default_rng(41)))
    plan = cg.plan_grid(xyz, torch.ones(xyz.shape[0], dtype=torch.bool), cell)
    r2 = cg._f32_square(R_EXACT)
    assert r2 == 0.390625
    keep = cg.near_columns(plan, r2)
    assert keep.shape == (plan.n_valid, 9) and bool(keep[:, 4].all())
    corner = torch.tensor([0, 2, 6, 8])
    hits = on_r = 0
    for a, b, sl, ids, ok in cg._sorted_chunks(plan):
        cols = plan.cols[plan.cell_of[sl].long()].long()
        cum = (cols[..., 1] - cols[..., 0]).cumsum(1)
        k = torch.arange(ids.shape[1])[None, :].expand_as(ids).contiguous()
        col = torch.searchsorted(cum, k, right=True).clamp_max(8)
        d2 = cg._pair_d2(plan, sl, ids)[3]
        hit = ok & (d2 <= r2)
        assert bool(keep[a:b].gather(1, col)[hit].all())
        hits += int(hit.sum())
        on_r += int((hit & (d2 == r2) & torch.isin(col, corner)).sum())
    assert hits > 3 * plan.n_valid  # the clouds do hold neighbours
    if kind == "random":  # and the rule does leave columns out
        share = 1.0 - float(keep.float().mean())
        assert share > {1.0: 0.05, 1.545: 0.3, 4.0: 0.6}[cell_over_r], share
    if kind == "exact":  # pairs at exactly r across a cell corner are kept
        assert on_r > 10, on_r


def test_iss_pass_matches_jax_on_a_wider_cell(box):
    """iss_pass on a plan whose cell exceeds the ISS radius, as the classic
    masked route builds it (cell = max(normal_cell, r_iss), ~1.545 r_iss):
    the same bounds as test_iss_pass_matches_jax, and the port's keypoints
    are those of its cell = r plan exactly."""
    xyz, valid = box["xyz"], box["valid"]
    wide = 1.545 * RADIUS
    jplan = jcg.plan_grid(jnp.asarray(xyz), jnp.zeros(xyz.shape, jnp.float32),
                          jnp.asarray(valid), wide, exact=True)
    jkp, jsal = (np.asarray(v) for v in jcg.iss_pass(jplan, RADIUS, interpret=True))
    plan = cg.plan_grid(torch.from_numpy(xyz), torch.from_numpy(valid), wide)
    tkp, tsal = (v.numpy() for v in cg.iss_pass(plan, RADIUS))
    on = (jsal > 0) & (tsal > 0)
    np.testing.assert_allclose(tsal[on], jsal[on], rtol=2e-3, atol=3e-7)
    assert ((jsal > 0) != (tsal > 0)).mean() < 5e-3
    assert (jkp == tkp).mean() > 0.995
    assert (jkp & tkp).sum() >= 0.9 * max(jkp.sum(), tkp.sum()) > 9
    # the walk order changes with the cell, so saliencies move by float32
    # summation order; the keypoints of the box fixture do not
    np.testing.assert_allclose(tsal, box["tsal"], rtol=2e-3, atol=3e-7)
    assert (tkp == box["tkp"]).mean() > 0.995


def _nms_early_out(plan, r2, sal, okq, min_neighbors, order):
    """K4's early-out as a plain function of a visit order: every query
    that passed K3 takes its stencil candidates in the order `order`
    (positions of its padded candidate row), ends at the first neighbour
    within r whose saliency is >= its own, and is a keypoint when it finds
    none and has counted min_neighbors neighbours."""
    n = plan.n_valid
    ids, ok = cg.candidates(plan, 0, n)
    d2 = cg._pair_d2(plan, torch.arange(n), ids)[3]
    nb = ok & (d2 > 0.0) & (d2 <= r2)
    open_ = okq & (sal > -cg.BIG)
    count = torch.zeros(n, dtype=torch.int64)
    for k in order:
        hit = open_ & nb[:, k]
        open_ = open_ & ~(hit & (sal[ids[:, k]] >= sal))
        count += hit & open_
    return open_ & (count >= min_neighbors)


@pytest.mark.parametrize("order", ["walk", "reversed", "shuffled"])
def test_iss_nms_early_out_is_the_strict_maximum(box, order):
    """Ending a query at its first blocking neighbour gives K4's mask in
    any visit order, exact ties included."""
    plan = box["plan"]
    r2 = cg._f32_square(RADIUS)
    n = plan.n_valid
    rng = np.random.default_rng(3)
    sal = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
    sal[::7] = sal[1::7][: sal[::7].shape[0]]
    okq = torch.from_numpy(rng.random(n) < 0.8)
    L = cg.candidates(plan, 0, n)[0].shape[1]
    pos = {"walk": np.arange(L), "reversed": np.arange(L)[::-1],
           "shuffled": rng.permutation(L)}[order]
    for min_nb in (4, 1000):
        got = _nms_early_out(plan, r2, sal, okq, min_nb, pos.tolist())
        assert torch.equal(got, cg.iss_nms_plain(plan, r2, sal, okq, min_nb))
    assert int(cg.iss_nms_plain(plan, r2, sal, okq, 4).sum()) > 10

"""Parity: the PyTorch port's cell-list plan, surface pass (K1) and FPFH
(K5 + K6) against the JAX package's Pallas cell kernels in interpret mode.

On the CPU the port runs the plain PyTorch versions of its CUDA kernels;
they walk the same CSR stencil table the kernels walk.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lidar_global_registration_tpu.ops.pallas import cellgrid as jcg
from lidar_global_registration_tpu_torch.ops import cellgrid as cg

torch.set_num_threads(2)

VIEWPOINT = np.array([6.0, 6.0, 40.0], np.float32)


def _bump_cloud(n, pad, rng):
    """Smooth bump terrain on a 12 x 12 square (the fixture of
    test_cell_fpfh.py) padded with `pad` invalid rows."""
    centers = rng.uniform([0, 0], [12, 12], size=(40, 2))
    widths = rng.uniform(0.3, 2.0, size=40)
    heights = rng.uniform(-1.0, 1.0, size=40)
    xy = rng.uniform([0, 0], [12, 12], size=(n, 2))
    z = np.zeros(n)
    for c, w, h in zip(centers, widths, heights):
        z += h * np.exp(-np.sum((xy - c) ** 2, axis=1) / (2 * w * w))
    xyz = np.zeros((n + pad, 3), np.float32)
    xyz[:n] = np.column_stack([xy, z])
    return xyz, np.arange(n + pad) < n


@pytest.mark.parametrize("radius", [0.45, 1.2])
def test_plan_enumerates_exactly_the_pairs_within_r(rng, radius):
    xyz, valid = _bump_cloud(2048, 40, rng)
    plan = cg.plan_grid(torch.from_numpy(xyz), torch.from_numpy(valid), radius)
    r2 = cg._f32_square(radius)
    assert plan.n_valid == valid.sum()
    ids, ok = cg.candidates(plan, 0, plan.n_valid)
    # every candidate appears once per query
    srt = torch.sort(torch.where(ok, ids, -1 - torch.arange(ids.shape[1])), 1).values
    assert not bool((srt[:, 1:] == srt[:, :-1]).any())
    q = plan.pts[:plan.n_valid, None, :3]
    d = plan.pts[ids, :3] - q
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    hit = ok & (d2 <= r2)
    qi = plan.order[:plan.n_valid, None].expand_as(ids)[hit].numpy()
    cj = plan.order[ids[hit]].numpy()
    got = set(zip(qi.tolist(), cj.tolist()))

    p = xyz[valid]
    rows = np.nonzero(valid)[0]
    dd = p[None, :, :] - p[:, None, :]
    bd2 = dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1] + dd[..., 2] * dd[..., 2]
    a, b = np.nonzero(bd2 <= np.float32(r2))
    want = set(zip(rows[a].tolist(), rows[b].tolist()))
    assert got == want


def test_surface_matches_jax_surface_pass(rng):
    xyz, valid = _bump_cloud(1536, 64, rng)
    radius = 0.5
    jplan = jcg.plan_grid(jnp.asarray(xyz), jnp.zeros_like(jnp.asarray(xyz)),
                          jnp.asarray(valid), radius, exact=True)
    jn, jcurv, jdens, _je, jok = (np.asarray(v) for v in jcg.surface_pass(
        jplan, radius, viewpoint=jnp.asarray(VIEWPOINT), interpret=True))
    plan = cg.plan_grid(torch.from_numpy(xyz), torch.from_numpy(valid), radius)
    tn, tcurv, tdens, te, tok = (v.numpy() for v in cg.surface_pass(
        plan, radius, torch.from_numpy(VIEWPOINT)))

    np.testing.assert_array_equal(tok, jok)
    assert tok.sum() > 0.9 * valid.sum()
    dots = np.sum(tn * jn, axis=1)
    # same orientation after the viewpoint flip everywhere; 1e-5 where the
    # normal is well defined (l1 - l0 >= 1e-2 l2).  Below that gap (here:
    # 5 points with 3 nearly collinear neighbours, gap ~1e-3) the smallest
    # eigenvector swings with float32 rounding in either package.
    well = tok & (te[:, 1] - te[:, 0] >= 1e-2 * te[:, 2])
    assert well.sum() > 0.9 * tok.sum()
    assert dots[well].min() > 1 - 1e-5
    assert dots[tok].min() > 0.99
    assert np.all(tn[~tok] == 0.0)
    # curvature = l0 / trace, where l0 of a flat patch is a float32
    # cancellation residue: against a float64 brute force the TPU kernel is
    # off by up to 4.0e-5 here and the port by up to 1.3e-5 (absolute; the
    # TPU kernel centres on the query block's mean, the port on the query)
    np.testing.assert_allclose(tcurv[valid], jcurv[valid], rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(tdens, jdens, rtol=1e-4)
    assert np.all(tdens[~valid] == 0.0)


def test_surface_matches_float64_brute_force(rng):
    """The port's normals and curvature against float64 PCA of the exact
    float32 radius neighbourhoods."""
    xyz, valid = _bump_cloud(1536, 64, rng)
    radius = 0.5
    plan = cg.plan_grid(torch.from_numpy(xyz), torch.from_numpy(valid), radius)
    tn, tcurv, _td, te, tok = (v.numpy() for v in cg.surface_pass(
        plan, radius, torch.from_numpy(VIEWPOINT)))
    p = xyz[valid]
    d = p[None] - p[:, None]
    inr = (d * d).sum(-1) <= np.float32(radius) ** 2
    rows = np.nonzero(valid)[0]
    for i, row in enumerate(rows):
        nb = p[inr[i]].astype(np.float64)
        w, v = np.linalg.eigh(np.cov(nb.T, bias=True))
        assert abs(tcurv[row] - max(w[0], 0.0) / max(w.sum(), 1e-30)) < 2e-5
        if tok[row] and w[1] - w[0] >= 1e-2 * w[2]:
            assert abs(np.dot(tn[row], v[:, 0])) > 1 - 1e-5
        np.testing.assert_allclose(te[row], w, rtol=1e-3, atol=3e-5 * w[2])


def test_fpfh_matches_jax_fpfh_pass(rng):
    xyz, valid = _bump_cloud(1536, 64, rng)
    radius = 0.9
    # the same normals into both packages
    nplan = cg.plan_grid(torch.from_numpy(xyz), torch.from_numpy(valid), 0.5)
    normal = cg.surface_pass(nplan, 0.5, torch.from_numpy(VIEWPOINT))[0]
    plan = cg.set_normals(cg.plan_grid(torch.from_numpy(xyz), torch.from_numpy(valid), radius),
                          normal)
    feat, fv = (v.numpy() for v in cg.fpfh_pass(plan, radius))

    jxyz = jnp.asarray(xyz)
    jplan = jcg.plan_grid(jxyz, jnp.zeros_like(jxyz), jnp.asarray(valid), radius, exact=True)
    jfeat, jfv = (np.asarray(v) for v in jcg.fpfh_pass(
        jcg.set_normals(jplan, jnp.asarray(normal.numpy())), radius, interpret=True))

    np.testing.assert_array_equal(fv, jfv)
    assert fv.sum() > 0.95 * valid.sum()
    assert np.all(feat[~fv] == 0.0)
    diff = np.abs(feat[fv] - jfeat[fv])
    # bounds of test_cell_fpfh.py: only pairs on a bin edge may flip (the
    # TPU kernel's polynomial atan2 is ~1e-5 rad off)
    assert np.mean(diff > 0.5) < 1e-3
    assert np.median(diff) < 1e-3


def test_masked_fpfh_matches_full_pass_and_jax(rng):
    """The kp / kp_rows forms (K5 over the keypoints' stencil, K6 at
    compacted rows that repeat and end in N sentinels) equal the full pass
    at those rows exactly, and match JAX fpfh_pass(kp=, kp_rows=)."""
    xyz, valid = _bump_cloud(1536, 64, rng)
    N = xyz.shape[0]
    radius = 0.9
    nplan = cg.plan_grid(torch.from_numpy(xyz), torch.from_numpy(valid), 0.5)
    normal = cg.surface_pass(nplan, 0.5, torch.from_numpy(VIEWPOINT))[0]
    plan = cg.set_normals(cg.plan_grid(torch.from_numpy(xyz), torch.from_numpy(valid), radius),
                          normal)
    kp = (rng.random(N) < 0.03) & valid
    rows = np.nonzero(kp)[0]
    kp_rows = np.concatenate([rows, rows[:5], np.full(9, N)]).astype(np.int64)
    full, full_v = (v.numpy() for v in cg.fpfh_pass(plan, radius))
    feat, fv = (v.numpy() for v in cg.fpfh_pass(plan, radius, kp=torch.from_numpy(kp),
                                                  kp_rows=torch.from_numpy(kp_rows)))
    r = np.minimum(kp_rows, N - 1)
    np.testing.assert_array_equal(fv, full_v[r] & (kp_rows < N))
    np.testing.assert_array_equal(feat, np.where(fv[:, None], full[r], 0.0))
    assert fv.sum() == len(rows) + 5
    # the SPFH subset is the keypoints' 27-cell stencil, not every point
    slots = cg.stencil_slots(plan, torch.nonzero(torch.from_numpy(kp)[plan.order[:plan.n_valid]])
                             .squeeze(1))
    assert 0 < slots.numel() < plan.n_valid
    # kp alone: full-size output, exact at keypoint rows, 0 elsewhere
    feat_k, fv_k = (v.numpy() for v in cg.fpfh_pass(plan, radius, kp=torch.from_numpy(kp)))
    np.testing.assert_array_equal(fv_k, full_v & kp)
    np.testing.assert_array_equal(feat_k[kp], full[kp])

    jxyz = jnp.asarray(xyz)
    jplan = jcg.set_normals(jcg.plan_grid(jxyz, jnp.zeros_like(jxyz), jnp.asarray(valid), radius,
                                          exact=True), jnp.asarray(normal.numpy()))
    jfeat, jfv = (np.asarray(v) for v in jcg.fpfh_pass(
        jplan, radius, kp=jnp.asarray(kp), kp_rows=jnp.asarray(kp_rows.astype(np.int32)),
        interpret=True))
    np.testing.assert_array_equal(fv, jfv)
    diff = np.abs(feat[fv] - jfeat[fv])
    # as test_fpfh_matches_jax_fpfh_pass: only pairs on a bin edge may flip
    assert np.mean(diff > 0.5) < 1e-3
    assert np.median(diff) < 1e-3


def test_kp_rows_in_keypoint_order_match_full_pass_and_jax(rng):
    """K6 at kp_rows as a keypoint matcher hands them over: shuffled, with
    repeats and with padding rows (>= N) in between.  Each row equals the
    full pass at its point, padding rows are 0, and JAX fpfh_pass(kp=,
    kp_rows=) agrees."""
    xyz, valid = _bump_cloud(1536, 64, rng)
    N = xyz.shape[0]
    radius = 0.9
    nplan = cg.plan_grid(torch.from_numpy(xyz), torch.from_numpy(valid), 0.5)
    normal = cg.surface_pass(nplan, 0.5, torch.from_numpy(VIEWPOINT))[0]
    plan = cg.set_normals(cg.plan_grid(torch.from_numpy(xyz), torch.from_numpy(valid), radius),
                          normal)
    kp = (rng.random(N) < 0.04) & valid
    rows = np.nonzero(kp)[0]
    kp_rows = np.concatenate([rows, rows[::3], np.full(7, N), np.full(4, N + 5)])
    kp_rows = kp_rows[rng.permutation(kp_rows.size)].astype(np.int64)
    full, full_v = (v.numpy() for v in cg.fpfh_pass(plan, radius))
    feat, fv = (v.numpy() for v in cg.fpfh_pass(plan, radius, kp=torch.from_numpy(kp),
                                                  kp_rows=torch.from_numpy(kp_rows)))
    r = np.minimum(kp_rows, N - 1)
    np.testing.assert_array_equal(fv, full_v[r] & (kp_rows < N))
    np.testing.assert_array_equal(feat, np.where(fv[:, None], full[r], 0.0))
    assert not feat[kp_rows >= N].any()

    jxyz = jnp.asarray(xyz)
    jplan = jcg.set_normals(jcg.plan_grid(jxyz, jnp.zeros_like(jxyz), jnp.asarray(valid), radius,
                                          exact=True), jnp.asarray(normal.numpy()))
    jfeat, jfv = (np.asarray(v) for v in jcg.fpfh_pass(
        jplan, radius, kp=jnp.asarray(kp), kp_rows=jnp.asarray(kp_rows.astype(np.int32)),
        interpret=True))
    np.testing.assert_array_equal(fv, jfv)
    diff = np.abs(feat[fv] - jfeat[fv])
    # as test_fpfh_matches_jax_fpfh_pass: only pairs on a bin edge may flip
    assert np.mean(diff > 0.5) < 1e-3
    assert np.median(diff) < 1e-3


def test_combine_order_sorts_slots_stably_with_a_row_map():
    """K6's launch order of a slot list: ascending slots (padding first),
    repeats in their order, and the output row of each."""
    slots = torch.tensor([7, -1, 3, 7, 0, -1, 3, 9], dtype=torch.int32)
    srt, rows = cg.combine_order(slots)
    assert srt.dtype == rows.dtype == torch.int32
    assert srt.tolist() == [-1, -1, 0, 3, 3, 7, 7, 9]
    assert rows.tolist() == [1, 5, 4, 2, 6, 0, 3, 7]
    assert torch.equal(slots[rows.long()], srt)


def _cells_cloud(rng):
    """Clusters that each fill one cell of a radius-1 grid, of 1, 32, 33,
    200, 64 and 5 points, beside a bump terrain of 1,024 points."""
    sizes = [1, 32, 33, 200, 64, 5]
    parts = [np.array([3.0 * k, 0.0, 0.0]) + rng.uniform(-0.2, 0.2, size=(s, 3))
             for k, s in enumerate(sizes)]
    terrain = _bump_cloud(1024, 0, rng)[0] + np.array([30.0, 0.0, 5.0], np.float32)
    xyz = np.concatenate(parts + [terrain]).astype(np.float32)
    plan = cg.plan_grid(torch.from_numpy(xyz), torch.ones(xyz.shape[0], dtype=torch.bool), 1.0)
    return plan, sizes


def _slot_lists(plan, rng):
    n = plan.n_valid
    kp = torch.from_numpy(rng.choice(n, size=40, replace=False))
    part = torch.nonzero(torch.from_numpy(rng.random(n) < 0.4)).squeeze(1)
    single = torch.sort(torch.from_numpy(rng.choice(n, size=9, replace=False))).values
    return {"full": None, "stencil": cg.stencil_slots(plan, kp), "partial cells": part,
            "single slots": single, "one slot": single[:1],
            "empty": torch.zeros((0,), dtype=torch.int64)}


@pytest.mark.parametrize("form", ["full", "stencil", "partial cells", "single slots", "one slot",
                                  "empty"])
def test_spfh_items_cut_each_cell_into_warps(rng, form):
    """K5's work list: every query position in exactly one item, items in
    position order, none crossing a cell or longer than 32, and a cell's
    queries cut into full items of 32 and one remainder; then padding rows
    (m, 0) up to the bound n_cells + ceil(m / 32)."""
    plan, sizes = _cells_cloud(rng)
    assert torch.bincount(plan.cell_of.long())[:len(sizes)].tolist() == sizes
    slots = _slot_lists(plan, rng)[form]
    cells = plan.cell_of if slots is None else plan.cell_of[slots]
    n_cells = plan.cols.shape[0]
    padded = cg.spfh_items(cells, n_cells)
    m = cells.shape[0]
    assert padded.dtype == torch.int32 and padded.shape[1:] == (2,)
    assert padded.shape[0] == min(m, n_cells + -(-m // cg.SPFH_ITEM))
    real = padded[:, 1] > 0
    n_items = int(real.sum())
    assert bool(real[:n_items].all()) and padded[n_items:].tolist() == [[m, 0]] * (
        padded.shape[0] - n_items)
    items = padded[:n_items]
    first, length = items[:, 0].long(), items[:, 1].long()
    assert bool((length >= 1).all()) and bool((length <= cg.SPFH_ITEM).all())
    # back to back from 0 to m: each position in exactly one item, in order
    ends = torch.cat([first.new_zeros(1), first + length])
    assert torch.equal(ends[:-1], first) and int(ends[-1]) == m
    assert n_items <= padded.shape[0]
    run = torch.repeat_interleave(torch.arange(items.shape[0]), length)
    for it in range(items.shape[0]):
        assert bool((cells[run == it] == cells[first[it]]).all()), "an item crosses a cell"
    # per cell: ceil(count / 32) items, all full but the last
    uniq, counts = torch.unique_consecutive(cells, return_counts=True)
    want = [min(cg.SPFH_ITEM, int(c) - k) for c in counts for k in range(0, int(c), cg.SPFH_ITEM)]
    assert length.tolist() == want
    if form == "full":
        assert want[:5] == [1, 32, 32, 1, 32]

"""Parity: the classic masked route's pieces in the PyTorch port —
point_need, the need-masked surface pass (the K1 slot-list form's plain
version) and surface_iss_masked — against exact sets, the full pass, and
the JAX package's Pallas cells in interpret mode.

On the CPU the port runs the plain PyTorch versions of its CUDA kernels;
the kernels' wrappers refuse CPU tensors.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_global_registration_tpu.ops.pallas import cellgrid as jcg
from lidar_global_registration_tpu_torch.ops import cellgrid as cg

torch.set_num_threads(2)

T = torch.from_numpy
NORMAL_R = 0.35
FEATURE_R = 0.9
VP = np.array([4.0, 4.0, 50.0], np.float32)


def _cloud():
    """The scene of tests/test_cell_masked.py: 4,096 points of sine terrain
    with a box, on 8 x 8, the last 37 rows padding."""
    rng = np.random.default_rng(11)
    n = 4096
    xy = rng.uniform(0, 8.0, (n, 2)).astype(np.float32)
    z = (0.4 * np.sin(xy[:, 0]) + 0.25 * np.cos(1.7 * xy[:, 1])).astype(np.float32)
    box = (np.abs(xy[:, 0] - 3.0) < 0.8) & (np.abs(xy[:, 1] - 5.0) < 0.8)
    z = z + np.where(box, 0.9, 0.0).astype(np.float32)
    # scanner-like noise: on exact sine terrain the normals of the flat box
    # top are float32 coin flips in either package
    z = z + rng.normal(scale=0.004, size=n).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-37:] = False
    return np.column_stack([xy, z]).astype(np.float32), valid


@pytest.fixture(scope="module")
def cloud():
    xyz, valid = _cloud()
    kp = np.zeros(len(xyz), bool)
    kp[np.random.default_rng(7).choice(np.nonzero(valid)[0], 3, replace=False)] = True
    return xyz, valid, kp


@pytest.mark.parametrize("s", [1, 2])
def test_point_need_covers_the_true_distance_set(cloud, s):
    xyz, valid, kp = cloud
    plan = cg.plan_grid(T(xyz), T(valid), FEATURE_R)
    need = cg.point_need(plan, T(kp), s).numpy()
    d = np.sqrt(((xyz[:, None, :] - xyz[kp][None, :, :]) ** 2).sum(-1)).min(1)
    # JAX's guarantee (tests/test_cell_masked.py) with its exact m = 1 grid:
    # every valid point within s cells' distance of a flagged point
    assert need[(d <= s * FEATURE_R) & valid].all()
    assert need[kp].all() and not need[~valid].any()
    # per cell, not the whole cloud: the points beyond s + 1 cells' reach
    # (the stencil's corner) stay out
    assert not need[d > (s + 1) * FEATURE_R * np.sqrt(3)].any()
    assert need.sum() < valid.sum()


def test_masked_surface_equals_the_full_pass_at_needed_rows(cloud):
    """The masked K1 (its plain version over the slot list) gives the full
    pass's values bit for bit at needed rows, and clean zeros / ok=False
    elsewhere."""
    xyz, valid, kp = cloud
    plan_f = cg.plan_grid(T(xyz), T(valid), FEATURE_R)
    need = cg.point_need(plan_f, T(kp), 2)
    plan_n = cg.plan_grid(T(xyz), T(valid), NORMAL_R)
    full = [v.numpy() for v in cg.surface_pass(plan_n, NORMAL_R, T(VP))]
    masked = [v.numpy() for v in cg.surface_pass(plan_n, NORMAL_R, T(VP), need=need)]
    need = need.numpy()
    sel = need & full[4]
    assert 50 < sel.sum() < valid.sum() - 50
    np.testing.assert_array_equal(masked[4], full[4] & need)
    for got, want in zip(masked[:4], full[:4]):
        np.testing.assert_array_equal(got[sel], want[sel])
    np.testing.assert_array_equal(masked[2][need], full[2][need])  # density, every needed row
    off = ~need
    assert not masked[4][off].any() and (masked[0][off] == 0.0).all()


def test_surface_slot_form_computes_only_its_slots(cloud):
    xyz, valid, kp = cloud
    plan = cg.plan_grid(T(xyz), T(valid), NORMAL_R)
    r2 = cg._f32_square(NORMAL_R)
    slots = torch.arange(3, plan.n_valid, 7)
    out_f, d_f, id_f = cg.surface_plain(plan, r2)
    out_s, d_s, id_s = cg.surface_plain(plan, r2, slots)
    assert torch.equal(out_s[slots], out_f[slots]) and torch.equal(d_s[slots], d_f[slots])
    assert torch.equal(id_s[slots], id_f[slots])
    rest = torch.ones(plan.n_valid, dtype=torch.bool)
    rest[slots] = False
    assert not out_s[rest].any() and not d_s[rest].any() and bool((id_s[rest] == -1).all())
    with pytest.raises(ValueError, match="CUDA"):
        cg.surface_at_cuda(plan, r2, slots)


@pytest.mark.parametrize("shot", [False, True])
def test_surface_iss_masked_matches_jax(cloud, shot):
    xyz, valid, _kp = cloud
    iss_r = 0.3
    cell_n = max(NORMAL_R, iss_r)
    zeros = jnp.zeros((len(xyz), 3), jnp.float32)
    jn_plan = jcg.plan_grid(jnp.asarray(xyz), zeros, jnp.asarray(valid), cell_n, exact=True)
    jf_plan = jcg.plan_grid(jnp.asarray(xyz), zeros, jnp.asarray(valid), FEATURE_R, exact=True)
    jn, jkp, jd, jsal = (np.asarray(v) for v in jcg.surface_iss_masked(
        jn_plan, jf_plan, NORMAL_R, iss_r, viewpoint=jnp.asarray(VP), shot=shot,
        interpret=True))
    pn = cg.plan_grid(T(xyz), T(valid), cell_n)
    pf = cg.plan_grid(T(xyz), T(valid), FEATURE_R)
    tn, tkp, td, tsal = (v.numpy() for v in cg.surface_iss_masked(pn, pf, NORMAL_R, iss_r,
                                                                  T(VP), shot=shot))
    # the same keypoints (ISS parity: tests/test_torch_iss.py); measured equal
    assert (tkp == jkp).mean() > 0.995 and tkp.sum() > 20
    # at the rows a later stage reads (within 1 or 2 feature cells of a
    # keypoint) both computed the normal and the density.  Normals as in
    # tests/test_torch_cellgrid.py: 1e-5 where l1 - l0 is not tiny, same
    # orientation; density (a k=2 smoothed nearest-neighbour distance) as
    # there: the TPU kernel's d2 comes from block-centred coordinates,
    # measured up to 1.0e-4 apart relatively
    s = 1 if shot else 2
    need = cg.point_need(pf, T(tkp & jkp), s).numpy()
    both = need & (np.abs(tn).sum(1) > 0) & (np.abs(jn).sum(1) > 0)
    assert both.sum() > 0.9 * (need & (np.abs(jn).sum(1) > 0)).sum()
    dots = (tn[both] * jn[both]).sum(1)
    assert (dots > 1 - 1e-4).mean() > 0.99 and (dots > 0.9).all()
    np.testing.assert_allclose(td[need], jd[need], rtol=2e-4, atol=0)
    # outside the port's own need set its normals are 0
    assert not np.abs(tn[~cg.point_need(pf, T(tkp), s).numpy()]).any()


def test_surface_iss_cells_matches_jax_and_the_masked_stage(cloud):
    """The unmasked side stage (one plan at max(normal radius, ISS radius),
    K1 over every row, K2-K4): against the JAX package's surface_iss_cells
    with the bounds of the masked test above, at every valid row; and
    against the port's own masked stage, exactly: the same keypoints, the
    same normals and densities at every row the masked stage computed."""
    xyz, valid, _kp = cloud
    iss_r = 0.3
    jout = jcg.surface_iss_cells(jnp.asarray(xyz), jnp.asarray(valid), NORMAL_R, iss_r,
                                 viewpoint=jnp.asarray(VP), interpret=True, exact=True)
    pn = cg.plan_grid(T(xyz), T(valid), max(NORMAL_R, iss_r))
    out = cg.surface_iss_cells(pn, NORMAL_R, iss_r, T(VP))
    assert sorted(out) == sorted(["normal", "curv", "density", "eigvals", "ok", "kp", "saliency"])
    jkp, tkp = np.asarray(jout["kp"]), out["kp"].numpy()
    assert (tkp == jkp).mean() > 0.995 and tkp.sum() > 20
    jn, tn = np.asarray(jout["normal"]), out["normal"].numpy()
    both = (np.abs(tn).sum(1) > 0) & (np.abs(jn).sum(1) > 0)
    assert both.sum() > 0.98 * valid.sum()
    dots = (tn[both] * jn[both]).sum(1)
    assert (dots > 1 - 1e-4).mean() > 0.99 and (dots > 0.9).all()
    np.testing.assert_allclose(out["density"].numpy()[valid], np.asarray(jout["density"])[valid],
                               rtol=2e-4, atol=0)
    np.testing.assert_array_equal(out["ok"].numpy(), np.asarray(jout["ok"]))
    # the port's masked stage computes a subset of the same rows with the
    # same per-query arithmetic
    pf = cg.plan_grid(T(xyz), T(valid), FEATURE_R)
    mn, mkp, md, msal = cg.surface_iss_masked(pn, pf, NORMAL_R, iss_r, T(VP))
    assert torch.equal(out["kp"], mkp) and torch.equal(out["saliency"], msal)
    need = cg.point_need(pf, mkp, 2)
    assert torch.equal(out["normal"][need], mn[need])
    assert torch.equal(out["density"][mkp], md[mkp])


@pytest.mark.parametrize("descriptor", ["fpfh", "shot"])
def test_kp_count_gate_and_mutual_fallback(cloud, monkeypatch, capsys, descriptor):
    """Every valid row a keypoint: the feature-scale route's keypoint-count
    gate sends the pair to the classic masked route, whose descriptors then
    cover more than half the rows, so matching falls back to mutual 1-NN
    over full rows (flagship.py:1594-1598, 1917-1949), each with the JAX
    package's notice.  A rotated copy of the cloud registers exactly."""
    from lidar_global_registration_tpu_torch.models import flagship as tfl
    from lidar_global_registration_tpu_torch.ops.transform import rotation_translation_error

    monkeypatch.setattr(cg, "iss_pass", lambda plan, r, *a: (plan.valid.clone(),
                                                             torch.zeros_like(plan.valid,
                                                                              dtype=torch.float32)))
    xyz, valid, _kp = cloud
    ang = 0.2
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                 np.float32)
    t = np.array([0.5, -0.3, 0.1], np.float32)
    tgt = (xyz @ R.T + t).astype(np.float32)
    cfg = tfl.FlagshipConfig(rounds=16, hypothesis_batch=512, descriptor=descriptor,
                             metric="correspondences")
    times = {}
    out = tfl.register_pair_staged(
        T(xyz), T(valid), T(tgt), T(valid), torch.Generator().manual_seed(3),
        0.35, 0.12, 0.12, 0.3, 0.3, 1.2, 0.3, vp_src=T(VP), vp_tgt=T(R @ VP + t), cfg=cfg,
        stage_times=times)
    log = capsys.readouterr().out
    assert "# feature-scale surface -> classic masked path: kp counts" in log
    assert "# cluster matching -> mutual 1-NN fallback" in log
    desc = "shot" if descriptor == "shot" else "fpfh"
    assert list(times)[-6:] == [f"{desc}_src", f"{desc}_tgt", "match_st", "match_ts", "corr",
                                "ransac"]
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3], T_gt[:3, 3] = R, t
    r_err, t_err = rotation_translation_error(out["transformation"], T(T_gt))
    assert bool(out["converged"]) and float(r_err) < 1e-3 and float(t_err) < 1e-2
    assert int(out["n_correspondences"]) > 0.5 * valid.sum()

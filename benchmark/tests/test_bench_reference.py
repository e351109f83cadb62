"""The plain reference against the port's CPU path on a small scene, and
the control (the reference in TF32 in the program's place) not correct."""

import numpy as np
import pytest
import torch

from benchmark import check, control, manifest, traffic
from benchmark.reference import features, neighbours, stages

SPEC = dict(points_per_side=65536, extent_m=30.0, graded=False, layout_seed=566, scene_seed=566,
            pool=1,
            pose={"yaw_rad": [0.0, 6.283185307179586], "offset_xy_m": [-10.0, 10.0],
                  "offset_z_m": [-1.0, 1.0]})


@pytest.fixture(scope="module")
def scene():
    torch.set_num_threads(4)
    return traffic.build(SPEC, 2**31 + 99, torch.device("cpu"))


def test_knn_is_exact():
    g = torch.Generator().manual_seed(3)
    pts = torch.rand((3000, 3), generator=g) * torch.tensor([10.0, 10.0, 0.2])
    dist, idx = neighbours.knn_nonself(pts, 7)
    dd = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    dd.fill_diagonal_(float("inf"))
    want = dd.topk(7, largest=False).values.sqrt()
    assert torch.allclose(dist, want, rtol=1e-5)


def test_radii_and_downsample_agree_with_the_port(scene):
    from lidar_global_registration_tpu_torch.models.flagship import pre_downsample_pair
    from lidar_global_registration_tpu_torch.ops.density import derive_radii

    raw = derive_radii(scene.src, scene.tgt_world)
    ds = stages.cloud_density(scene.src)
    assert abs(raw["density_src"] - ds) <= 1e-6 * ds
    pair = scene.pairs[0]
    n = scene.src.shape[0]
    ones = torch.ones((n,), dtype=torch.bool)
    vs, vt = 2.0 * raw["density_src"], 2.0 * raw["density_tgt"]
    sx, sv, tx, tv = pre_downsample_pair(scene.src, ones, pair.tgt, ones, vs, vt, aabb=pair.aabb)
    ref_s = stages.voxel_centroids(scene.src, vs, pair.aabb[0, 0])
    rows, err = check.row_map(sx[sv], ref_s)
    assert torch.equal(rows, torch.arange(ref_s[0].shape[0])) and err < 1e-5
    prog = derive_radii(sx, tx, sv, tv)
    ref = stages.radii(stages.cloud_density(sx[sv]), stages.cloud_density(tx[tv]))
    assert check.radii_rel(prog, ref, check.RADII_KEYS) < 1e-6


def test_iss_agrees_with_the_port(scene):
    from lidar_global_registration_tpu_torch.ops import cellgrid

    pts = scene.src[:20000]
    valid = torch.ones((pts.shape[0],), dtype=torch.bool)
    r = 0.5
    kp_port = cellgrid.iss_pass(cellgrid.plan_grid(pts, valid, r), r)[0]
    kp_ref = stages.iss_keypoints(pts, r)
    assert kp_port.sum() > 20
    assert (~kp_ref[kp_port]).to(torch.float64).mean() < 0.05
    assert abs(int(kp_ref.sum()) - int(kp_port.sum())) <= 0.05 * int(kp_port.sum())


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, 47.123456], dtype=torch.float32)
    y = stages.tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0 + 2.0**-9
    assert (y.view(torch.int32) & 0x1FFF).eq(0).all()
    assert abs(float(y[2]) - 47.123456) < 47.2 * 2.0**-11


def _fs_port(xyz, kp, feature_radius, vp):
    """The port's feature-scale FPFH at the keypoints kp bool[n] of xyz."""
    from lidar_global_registration_tpu_torch.ops import cellgrid
    from lidar_global_registration_tpu_torch.ops.downsample import voxel_centroids_map

    voxel_f, normal_f = features.scales(feature_radius)
    valid = torch.ones((xyz.shape[0],), dtype=torch.bool)
    sm, smv, row_of, _n = voxel_centroids_map(xyz, valid, voxel_f)
    normal = cellgrid.surface_pass(cellgrid.plan_grid(sm, smv, normal_f), normal_f, vp)[0]
    rows = row_of[torch.nonzero(kp).squeeze(1)]
    small = torch.zeros_like(valid)
    small[rows] = True
    plan = cellgrid.set_normals(cellgrid.plan_grid(sm, smv, feature_radius), normal)
    return cellgrid.fpfh_pass(plan, feature_radius, kp=small, kp_rows=rows)


def test_descriptors_agree_with_the_port(scene):
    pts = scene.src[:30000]
    kp = stages.iss_keypoints(pts, 0.5)
    r = 1.5
    feat, fv = _fs_port(pts, kp, r, scene.vp_src)
    ref = features.describe(pts, kp, r, scene.vp_src)
    assert kp.sum() > 20 and torch.equal(fv, ref.valid)
    gap = (feat - ref.feat).abs().amax(1)
    assert float(gap.median()) < 0.5 and float((gap < 2.0).to(torch.float64).mean()) > 0.95


def test_gate_agrees_with_the_port(tiny_cell):
    from benchmark import run

    res = run.run_cell(tiny_cell(), 2**31 + 7, 1.0, False, torch.device("cpu"))
    assert res["correct"] is True
    assert res["checks"]["corr_extra"][0] <= 0.02 and res["checks"]["corr_missing"][0] <= 0.02


def test_tf32_changes_only_the_products():
    g = torch.Generator().manual_seed(5)
    a = torch.rand((64, 33), generator=g) * 100.0
    exact = stages.matmul(a, a.T, "float32")
    low = stages.matmul(a, a.T, "tf32")
    assert torch.equal(low, stages.tf32(a) @ stages.tf32(a).T)
    assert not torch.equal(low, exact) and torch.allclose(low, exact, rtol=2e-3)


def test_control_is_not_correct(tiny_cell):
    """The control at 393,216 points a side on the 30 m site, under the
    cell's own limits: the TF32 keypoint distances move the gate."""
    cell = tiny_cell(points_per_side=393216)
    nums, _shown = control.control_numbers(cell, 2**31 + 5, torch.device("cpu"))
    assert check.judge(nums, cell.limits)[0] is False


@pytest.mark.card
def test_control_at_the_cells_size_is_not_correct(card):
    for name in [w["name"] for w in manifest.load_manifest()["workloads"]]:
        cell = manifest.load_cell(name)
        for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
            nums, _shown = control.control_numbers(cell, seed, card)
            assert check.judge(nums, cell.limits)[0] is False, (name, seed, nums)
            torch.cuda.empty_cache()


def test_grid_pairs_match_brute_force():
    g = torch.Generator().manual_seed(4)
    pts = torch.rand((2000, 3), generator=g) * 5.0
    r = 0.4
    r2 = float(np.float32(r) * np.float32(r))
    q, j, _ = neighbours.pairs_within(pts, r2, r * (1 + 1e-5))
    got = set(zip(q.tolist(), j.tolist()))
    dd = neighbours.d2(pts, *[t.reshape(-1) for t in torch.meshgrid(
        torch.arange(2000), torch.arange(2000), indexing="ij")])
    qq, jj = torch.nonzero(dd.reshape(2000, 2000) <= r2, as_tuple=True)
    assert got == set(zip(qq.tolist(), jj.tolist()))

"""The traffic repeats exactly for a seed; another seed sends the same pairs
in another order with other RANSAC seeds."""
import numpy as np
import torch

from benchmark import traffic

SPEC = dict(points_per_side=4096, extent_m=30.0, graded=True, layout_seed=566, scene_seed=566,
            pool=8,
            pose={"yaw_rad": [0.0, 6.283185307179586], "offset_xy_m": [-10.0, 10.0],
                  "offset_z_m": [-1.0, 1.0]})
BIG = 2**31 + 12345  # the driver's seeds exceed 32 signed bits


def test_same_seed_same_traffic():
    a = traffic.build(SPEC, BIG, torch.device("cpu"))
    b = traffic.build(SPEC, BIG, torch.device("cpu"))
    assert torch.equal(a.src, b.src) and torch.equal(a.tgt_world, b.tgt_world)
    for p, q in zip(a.pairs, b.pairs):
        assert torch.equal(p.tgt, q.tgt) and np.array_equal(p.T_gt, q.T_gt)
        assert p.ransac_seed == q.ransac_seed and np.array_equal(p.aabb, q.aabb)


def test_other_seed_same_pairs_in_another_order():
    a = traffic.build(SPEC, BIG, torch.device("cpu"))
    b = traffic.build(SPEC, BIG + 1, torch.device("cpu"))
    assert torch.equal(a.src, b.src) and torch.equal(a.tgt_world, b.tgt_world)
    assert sorted(p.pose for p in a.pairs) == sorted(p.pose for p in b.pairs) == list(range(8))
    assert [p.pose for p in a.pairs] != [p.pose for p in b.pairs]
    assert [p.ransac_seed for p in a.pairs] != [p.ransac_seed for p in b.pairs]
    by_pose = {p.pose: p for p in b.pairs}
    for p in a.pairs:
        assert torch.equal(p.tgt, by_pose[p.pose].tgt)


def test_scene_seed_changes_the_scene():
    a = traffic.build(SPEC, BIG, torch.device("cpu"))
    b = traffic.build(dict(SPEC, scene_seed=567), BIG, torch.device("cpu"))
    assert not torch.equal(a.src, b.src)


def test_poses_are_levelled_and_in_range():
    for T in traffic.pose_pool(BIG, SPEC["pose"], 64):
        R = T[:3, :3]
        assert np.allclose(R @ R.T, np.eye(3)) and np.allclose(R[2], [0, 0, 1])
        assert np.all(np.abs(T[:2, 3]) <= 10.0) and abs(T[2, 3]) <= 1.0


def test_target_is_the_posed_second_sampling():
    tr = traffic.build(SPEC, BIG, torch.device("cpu"))
    p = tr.pairs[3]
    back = (p.tgt - torch.as_tensor(p.T_gt[:3, 3], dtype=torch.float32)) @ torch.as_tensor(
        p.T_gt[:3, :3], dtype=torch.float32)
    assert torch.allclose(back, tr.tgt_world, atol=1e-4)
    assert np.allclose(p.aabb[1, 0], p.tgt.amin(0).numpy())


def test_layout_is_fixed_by_the_traffic_file():
    t1 = traffic.scene_tables(566, 60.0)
    t2 = traffic.scene_tables(566, 60.0)
    assert all(np.array_equal(x, y) for x, y in zip(t1, t2))

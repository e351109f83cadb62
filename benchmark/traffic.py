"""The scan pairs a cell sends: one general generator read by every traffic
file under benchmark/traffic/.

A traffic file fixes the site (the box + mound scene's layout seed and
extent), the points a side, the range falloff (`graded`), the pose
distribution and the size of the pool, and `scene_seed`, from which both
samplings of the site and the pool of poses are drawn: every run sends the
same set of pairs.  `--seed` draws the order in which the pool is sent, a
RANSAC generator seed for each pooled pair, and the pairs the reference
checks.  The target of a pooled pair is the second sampling moved by its
pose, so its ground truth is the pose itself.

The scene tables and the sampler are copies of the program's
(`__graft_entry__._scene_tables`, `scene.patch_weights` / `scene._sample`),
kept here so that a change to the program cannot move the yardstick.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

NOISE = 0.008  # scanner-like noise (m)


def scene_tables(seed: int, extent: float):
    """The box + mound scene as flat parameter tables (patch origins and
    edges, mound centres and radii, patch areas); structure counts scale
    with the ground area so larger sites keep the same structure density."""
    rng = np.random.default_rng(seed)
    area_scale = max(1.0, (extent / 30.0) ** 2)
    boxes = []
    for _ in range(int(round(14 * area_scale))):
        o = rng.uniform([2, 2, 0], [extent - 4, extent - 4, 0])
        s = rng.uniform([0.8, 0.8, 0.8], [2.5, 2.5, 2.8])
        boxes.append((o, s))
    patches = [(np.zeros(3), np.array([extent, 0, 0]), np.array([0.0, extent, 0]))]
    mounds = []
    for _ in range(int(round(24 * area_scale))):
        c = rng.uniform([2, 2], [extent - 2, extent - 2])
        mounds.append((c, rng.uniform(0.6, 3.0)))
    for o, s in boxes:
        sx, sy, sz = s
        patches += [
            (o, np.array([sx, 0, 0]), np.array([0, 0, sz])),
            (o + [0, sy, 0], np.array([sx, 0, 0]), np.array([0, 0, sz])),
            (o, np.array([0, sy, 0]), np.array([0, 0, sz])),
            (o + [sx, 0, 0], np.array([0, sy, 0]), np.array([0, 0, sz])),
            (o + [0, 0, sz], np.array([sx, 0, 0]), np.array([0, sy, 0])),
        ]
    origins = np.array([p[0] for p in patches], np.float32)
    eus = np.array([p[1] for p in patches], np.float32)
    evs = np.array([p[2] for p in patches], np.float32)
    m_c = np.array([m[0] for m in mounds], np.float32)
    m_r = np.array([m[1] for m in mounds], np.float32)
    areas = np.concatenate([np.linalg.norm(np.cross(eus, evs), axis=1),
                            2.0 * np.pi * m_r * m_r]).astype(np.float32)
    return origins, eus, evs, m_c, m_r, areas


def patch_weights(tables, graded: bool) -> np.ndarray:
    """Sampling probability of each patch (flat patches, then mounds): its
    share of the area; graded, that share over 1 + (d / 15)^2 for the
    distance d of the patch's centre to a scanner at (2, 2)."""
    origins, eus, evs, m_c, _m_r, areas = (np.asarray(a, np.float64) for a in tables)
    weights = areas / areas.sum()
    if graded:
        centres = np.concatenate([origins[:, :2] + 0.5 * (eus[:, :2] + evs[:, :2]), m_c])
        dist = np.linalg.norm(centres - np.array([2.0, 2.0]), axis=1)
        weights = weights / (1.0 + (dist / 15.0) ** 2)
        weights = weights / weights.sum()
    return weights


def sample(tables, weights, m: int, generator: torch.Generator, device) -> torch.Tensor:
    """m points of the scene f32[m, 3], drawn on `device` by `generator`."""
    origins, eus, evs, m_c, m_r, _areas = (torch.as_tensor(np.asarray(a), device=device)
                                           for a in tables)
    n_flat = origins.shape[0]
    cdf = torch.cumsum(torch.as_tensor(weights, dtype=torch.float64, device=device), 0)
    u = torch.rand((m,), generator=generator, device=device, dtype=torch.float64)
    pid = torch.searchsorted(cdf, u, right=True).clamp_max(cdf.shape[0] - 1)
    uv = torch.rand((m, 2), generator=generator, device=device)
    f = pid.clamp_max(n_flat - 1)
    flat = origins[f] + uv[:, :1] * eus[f] + uv[:, 1:] * evs[f]
    mid = (pid - n_flat).clamp(0, m_r.shape[0] - 1)
    rr = m_r[mid]
    cen = m_c[mid]
    z = rr * uv[:, 0]
    rho = (rr * rr - z * z).clamp_min(0.0).sqrt()
    phi = 2.0 * math.pi * uv[:, 1]
    mound = torch.stack([cen[:, 0] + rho * torch.cos(phi), cen[:, 1] + rho * torch.sin(phi), z],
                        1)
    pts = torch.where((pid >= n_flat)[:, None], mound, flat)
    noise = torch.randn((m, 3), generator=generator, device=device)
    return pts + NOISE * noise


def pose_pool(scene_seed: int, pose: dict, pool: int) -> np.ndarray:
    """The pool's ground-truth poses f64[pool, 4, 4] (target = T source),
    drawn from `scene_seed`: a yaw uniform over `yaw_rad`, a horizontal offset
    uniform over `offset_xy_m` per axis, a vertical one over `offset_z_m`;
    no tilt (the scans are levelled)."""
    rng = np.random.default_rng(np.random.SeedSequence([scene_seed, 1]))
    out = np.tile(np.eye(4), (pool, 1, 1))
    for k in range(pool):
        yaw = rng.uniform(*pose["yaw_rad"])
        c, s = math.cos(yaw), math.sin(yaw)
        out[k, :3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
        out[k, :2, 3] = rng.uniform(*pose["offset_xy_m"], size=2)
        out[k, 2, 3] = rng.uniform(*pose["offset_z_m"])
    return out


def sampling_seeds(scene_seed: int) -> tuple[int, int]:
    """The generator seeds of the source's and the target's sampling."""
    a, b = np.random.SeedSequence([scene_seed, 0]).generate_state(2, dtype=np.uint64)
    return int(a) >> 1, int(b) >> 1


def send_order(seed: int, pool: int) -> list[int]:
    """The order in which the run sends the pool."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 4]))
    return [int(v) for v in rng.permutation(pool)]


def ransac_seeds(seed: int, pool: int) -> list[int]:
    """One RANSAC generator seed per pooled pair."""
    return [int(v) >> 1 for v in
            np.random.SeedSequence([seed, 2]).generate_state(pool, dtype=np.uint64)]


def checked_pairs(seed: int, spec: dict) -> list[int]:
    """The pooled pairs (positions in the send order) the reference checks."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 3]))
    pool = int(spec["pool"])
    return sorted(int(v) for v in
                  rng.choice(pool, size=min(int(spec["checked_pairs"]), pool), replace=False))


@dataclass
class Pair:
    """One pooled pair on the device: the target moved by its pose (pose
    `pose` of the traffic file's pool)."""
    tgt: torch.Tensor  # f32[n, 3]
    vp_tgt: torch.Tensor  # f32[3]
    aabb: np.ndarray  # f32[2 sides, (lo, hi), 3]
    T_gt: np.ndarray  # f64[4, 4], target = T_gt source
    ransac_seed: int
    pose: int


@dataclass
class Traffic:
    """A run's inputs: the source scan, its viewpoint and the pool."""
    src: torch.Tensor  # f32[n, 3]
    tgt_world: torch.Tensor  # f32[n, 3], the second sampling before any pose
    vp_src: torch.Tensor  # f32[3]
    pairs: list


def move(xyz: torch.Tensor, T: np.ndarray) -> torch.Tensor:
    """xyz moved by the rigid pose T, in float32 on xyz's device."""
    R = torch.as_tensor(T[:3, :3], dtype=torch.float32, device=xyz.device)
    t = torch.as_tensor(T[:3, 3], dtype=torch.float32, device=xyz.device)
    return xyz @ R.T + t


def bounds(xyz: torch.Tensor) -> torch.Tensor:
    """(lo, hi) f32[2, 3] of a cloud."""
    return torch.stack([xyz.amin(0), xyz.amax(0)])


def build(spec: dict, seed: int, device) -> Traffic:
    """The run's traffic from a traffic file's parameters and `--seed`: the
    pool in the order the run sends it."""
    n = int(spec["points_per_side"])
    extent = float(spec["extent_m"])
    tables = scene_tables(int(spec["layout_seed"]), extent)
    weights = patch_weights(tables, bool(spec["graded"]))
    scene_seed = int(spec["scene_seed"])
    s_src, s_tgt = sampling_seeds(scene_seed)
    src = sample(tables, weights, n, torch.Generator(device=device).manual_seed(s_src), device)
    tgt_world = sample(tables, weights, n, torch.Generator(device=device).manual_seed(s_tgt),
                       device)
    vp_src = torch.tensor([extent / 2, extent / 2, 25.0], dtype=torch.float32, device=device)
    pool = int(spec["pool"])
    src_box = bounds(src)
    poses = pose_pool(scene_seed, spec["pose"], pool)
    pairs = []
    for k, rs in zip(send_order(seed, pool), ransac_seeds(seed, pool)):
        tgt = move(tgt_world, poses[k])
        vp_tgt = move(vp_src[None], poses[k])[0]
        aabb = torch.stack([src_box, bounds(tgt)]).cpu().numpy()
        pairs.append(Pair(tgt, vp_tgt, aabb, poses[k], rs, k))
    return Traffic(src, tgt_world, vp_src, pairs)

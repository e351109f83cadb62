"""What decides `correct`: the numbers compared, each against its limit.
This comparison is the same for every route; the stages that produce what
it compares live in the cell's reference module (see below).

- rule_rot_rad, rule_t_over_thr, rule_unconverged: the success rule
  (bench.py:86, 327) on EVERY pair of the window, against the pose the
  traffic applied: converged, rotation error under 0.05 rad, translation
  error under the pair's distance threshold.  The configuration states
  these limits.
- corr_extra: over the checked pairs, the largest share of a pair's
  correspondences (those the program hands its solver) that the
  reference's set lacks.
- corr_missing: the largest share of the reference's set that the
  program's lacks.

A correspondence is a pair of working rows, one a side.  A program row is
the reference's row of the voxel that holds it only where it lies within
ROW_TOL_VOXELS voxels of that row's centroid; any other row matches no
reference row, so any stage from the pre-downsample to the last gate that
departs from the reference moves these two numbers.

Printed beside them, not compared: ds_err_m, the largest gap from a
program row to the reference centroid of its voxel (a row or voxel without
a partner counts one voxel); radii_rel, the largest relative gap of a
radius the program derived; kp_miss, the share of the program's
correspondence rows that are not reference keypoints; pose_fit_rad and
pose_fit_t_over_thr, the gap from the program's pose to a least-squares
fit (fit) over the reference's correspondences that lie within the
distance threshold under the true pose.

The checked pairs are every pooled pair, each the first time the window
sends it.  The cell's reference module (benchmark/reference/<name>.py,
named by the configuration's `reference`; manifest.load_cell loads it)
works every product out again from the inputs the benchmark gave the
program; its docstring names the route's stages.  The same comparison
judges the control (control.py): the module's `control`, its reference in
the precision next below the configuration's, put in the program's place.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from benchmark import stats
from benchmark.reference import stages

RADII_KEYS = ("normal_cell", "density_src", "density_tgt", "iss_src", "iss_tgt", "feature",
              "thr")
ROW_TOL_VOXELS = 1e-3  # sound rows lie within 1e-5 voxels of the reference's centroid


@dataclass
class Checked:
    """A checked pair's products, as the program (or the control) gave them:
    each side's working rows, the correspondences as (source row, target
    row) into them, the radii derived on them and the pose."""
    pose: int
    src_rows: torch.Tensor  # f32[m, 3]
    tgt_rows: torch.Tensor  # f32[m, 3]
    corr: torch.Tensor  # i64[c, 2]
    radii: dict
    T: np.ndarray  # f64[4, 4]


def row_map(rows: torch.Tensor, ref) -> tuple[torch.Tensor, float]:
    """(the reference row of each program row, -1 where none: see the
    module's docstring; ds_err_m of the rows)."""
    cen, keys, grid = ref
    rows = rows.to(cen.device)
    m = cen.shape[0]
    if rows.shape[0] == 0 or m == 0:
        return (torch.full((rows.shape[0],), -1, dtype=torch.int64, device=cen.device),
                0.0 if rows.shape[0] == m else grid.voxel)
    k = grid.keys(rows)
    pos = torch.searchsorted(keys, k).clamp_max(m - 1)
    hit = keys[pos] == k
    gap = torch.where(hit, (rows - cen[pos]).abs().amax(1), grid.voxel)
    err = float(gap.max())
    if torch.unique(pos[hit]).numel() < m:
        err = max(err, grid.voxel)
    near = hit & (gap <= ROW_TOL_VOXELS * grid.voxel)
    return torch.where(near, pos, -1), err


def radii_rel(prog: dict, ref: dict, keys) -> float:
    return max(abs(float(prog[k]) - ref[k]) / max(abs(ref[k]), 1e-30) for k in keys)


def corr_shares(prog: torch.Tensor, ref: torch.Tensor, n_tgt: int) -> tuple[float, float]:
    """(share of prog's pairs not in ref, share of ref's not in prog); pairs
    i64[c, 2] of reference rows, -1 for a row with no reference row."""
    code_p = torch.where((prog >= 0).all(1), prog[:, 0] * n_tgt + prog[:, 1], -1)
    code_r = ref[:, 0] * n_tgt + ref[:, 1]
    extra = float((~torch.isin(code_p, code_r)).to(torch.float64).mean()) if len(code_p) else 0.0
    missing = float((~torch.isin(code_r, code_p)).to(torch.float64).mean()) if len(code_r) else 0.0
    if len(code_p) == 0 and len(code_r) > 0:
        extra = 1.0
    return extra, missing


def rule_numbers(records: list) -> dict:
    """The rule's three numbers over every pair: records hold r_err, t_err,
    thr and converged."""
    return dict(
        rule_rot_rad=max((r["r_err"] for r in records), default=math.inf),
        rule_t_over_thr=max((r["t_err"] / r["thr"] for r in records), default=math.inf),
        rule_unconverged=float(sum(not r["converged"] for r in records)) if records else math.inf,
    )


def fit(src_rows, tgt_rows, corr, T_gt, thr: float, precision: str) -> np.ndarray:
    """The least-squares rigid pose f64[4, 4] over the correspondences
    i64[c, 2] whose rows lie within thr of each other under the true pose
    (Kabsch: q ~ R p + t, the cross-covariance a matrix product of the
    centred points in `precision`, its SVD in float64); the identity for
    fewer than 3 such pairs."""
    p, q = src_rows[corr[:, 0]], tgt_rows[corr[:, 1]]
    Tg = torch.as_tensor(T_gt, dtype=torch.float64, device=p.device)
    moved = p.to(torch.float64) @ Tg[:3, :3].T + Tg[:3, 3]
    inl = (moved - q.to(torch.float64)).norm(dim=1) < thr
    p, q = p[inl], q[inl]
    T = np.eye(4)
    if p.shape[0] < 3:
        return T
    cp, cq = p.to(torch.float64).mean(0), q.to(torch.float64).mean(0)
    pc = (p.to(torch.float64) - cp).to(torch.float32)
    qc = (q.to(torch.float64) - cq).to(torch.float32)
    S = stages.matmul(pc.T.contiguous(), qc, precision).to(torch.float64).cpu().numpy()
    U, _s, Vt = np.linalg.svd(S)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    T[:3, :3] = R
    T[:3, 3] = cq.cpu().numpy() - R @ cp.cpu().numpy()
    return T


def compare(raw_prog: dict, checked: list, ref) -> tuple[dict, dict]:
    """(the compared numbers, the printed ones) of the checked pairs
    against the cell's reference (its module's Reference: the raw pair's
    densities .ds, .dt, and .pose(k), whose products compare reads are
    vox_src, vox_tgt, radii, kp_src, kp_tgt, corr and T); raw_prog holds
    the program's densities of the raw pair."""
    nums = dict(corr_extra=0.0, corr_missing=0.0)
    shown = dict(ds_err_m=0.0, radii_rel=radii_rel(
        raw_prog, {"density_src": ref.ds, "density_tgt": ref.dt}, ("density_src", "density_tgt")),
        kp_miss=0.0, pose_fit_rad=0.0, pose_fit_t_over_thr=0.0)
    for c in checked:
        pp = ref.pose(c.pose)
        ms, e_s = row_map(c.src_rows, pp.vox_src)
        mt, e_t = row_map(c.tgt_rows, pp.vox_tgt)
        corr = c.corr.to(ms.device)
        mapped = torch.stack([ms[corr[:, 0]], mt[corr[:, 1]]], 1)
        extra, missing = corr_shares(mapped, pp.corr.to(ms.device), pp.vox_tgt[0].shape[0])
        nums["corr_extra"] = max(nums["corr_extra"], extra)
        nums["corr_missing"] = max(nums["corr_missing"], missing)
        hit = torch.cat([torch.where(mapped[:, 0] >= 0, pp.kp_src[mapped[:, 0].clamp_min(0)],
                                     False),
                         torch.where(mapped[:, 1] >= 0, pp.kp_tgt[mapped[:, 1].clamp_min(0)],
                                     False)])
        r, t = stats.rotation_translation_error(c.T, pp.T)
        shown["ds_err_m"] = max(shown["ds_err_m"], e_s, e_t)
        shown["radii_rel"] = max(shown["radii_rel"], radii_rel(c.radii, pp.radii, RADII_KEYS))
        shown["kp_miss"] = max(shown["kp_miss"],
                               float((~hit).to(torch.float64).mean()) if hit.numel() else 0.0)
        shown["pose_fit_rad"] = max(shown["pose_fit_rad"], r)
        shown["pose_fit_t_over_thr"] = max(shown["pose_fit_t_over_thr"], t / pp.radii["thr"])
    return nums, shown


def outlier_share(src_rows, tgt_rows, T_gt: np.ndarray, thr: torch.Tensor) -> float:
    """Share of correspondences farther than their threshold from the truth
    (printed beside the check; not compared)."""
    if src_rows.shape[0] == 0:
        return math.nan
    T = torch.as_tensor(T_gt, dtype=torch.float64, device=src_rows.device)
    p = src_rows.to(torch.float64) @ T[:3, :3].T + T[:3, 3]
    far = (p - tgt_rows.to(torch.float64)).norm(dim=1) >= thr.to(torch.float64)
    return float(far.to(torch.float64).mean())


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Every number at or under its limit; returns (correct, {name: {value,
    limit}})."""
    table = {k: {"value": float(v), "limit": float(limits[k])} for k, v in numbers.items()}
    ok = all(math.isfinite(t["value"]) and t["value"] <= t["limit"] for t in table.values())
    return ok, table

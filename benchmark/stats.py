"""The arithmetic of the end-to-end metrics and of the success rule."""
from __future__ import annotations

import math

import numpy as np


def rotation_translation_error(T: np.ndarray, T_gt: np.ndarray) -> tuple[float, float]:
    """angle(R^-1 R_gt) in rad and |t - t_gt|, in float64."""
    T = np.asarray(T, np.float64)
    T_gt = np.asarray(T_gt, np.float64)
    cos = (np.trace(T[:3, :3].T @ T_gt[:3, :3]) - 1.0) / 2.0
    return float(np.arccos(np.clip(cos, -1.0, 1.0))), float(np.linalg.norm(T[:3, 3] - T_gt[:3, 3]))


def meets_rule(converged: bool, r_err: float, t_err: float, thr: float, rule: dict) -> bool:
    """The success rule (bench.py:86, 327): converged, rotation error under
    rule["rot_rad"] and translation error under rule["t_over_thr"] x thr."""
    return bool(converged) and r_err < rule["rot_rad"] and t_err < rule["t_over_thr"] * thr


def p95(times: list, ok: list) -> float:
    """The 95th percentile (nearest rank) of every pair's seconds, a pair
    that missed the rule counting as infinitely long."""
    if not times:
        return math.inf
    v = sorted(t if good else math.inf for t, good in zip(times, ok))
    return v[max(math.ceil(0.95 * len(v)) - 1, 0)]


def rate(ok: list, window_s: float) -> float:
    """Pairs that met the rule per second of the whole window."""
    return sum(bool(x) for x in ok) / window_s

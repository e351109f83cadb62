"""RANSAC hypotheses and the metric context of one correspondence set
(lidar_global_registration_tpu/models/ransac.py:61-153, 233-246).

The sample draw and the hypothesis body are split, so a test can feed the
same sample rows to this package and to the JAX one (their generators give
different numbers from one seed).  The RANSAC loop itself is
models/flagship.ransac_solve; build_metric_context and _evaluate_one score
one transform for the analysis and the `metric` command.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lidar_global_registration_tpu_torch.ops import metrics as metricsmod
from lidar_global_registration_tpu_torch.ops.density import cloud_density
from lidar_global_registration_tpu_torch.ops.downsample import aabb
from lidar_global_registration_tpu_torch.ops.transform import kabsch
from lidar_global_registration_tpu_torch.types import (
    METRIC_CLOSEST_PLANE,
    METRIC_COMBINATION,
    METRIC_UNIFORMITY,
    METRIC_WEIGHTED_CLOSEST_PLANE,
    SPARSE_POINTS_FRACTION,
    AlignmentParameters,
    Cloud,
    Correspondences,
)


def build_metric_context(src: Cloud, tgt: Cloud, corrs: Correspondences,
                         params: AlignmentParameters, sparse: bool = False,
                         rng: Optional[np.random.Generator] = None) -> metricsmod.MetricContext:
    """What every evaluation of one (src, tgt, correspondences) triple
    shares (ransac.build_metric_context; the reference estimators'
    setSourceCloud / setTargetCloud / setCorrespondences, metric.cpp): the
    correspondences' points, for uniformity their bins over the source's
    box, for the closest-plane metrics the target's density (the inlier
    threshold, metric.cpp:181-186) and the source samples (every valid
    point, or with `sparse` a random SPARSE_POINTS_FRACTION of them)."""
    p = src.xyz[corrs.query]
    q = tgt.xyz[corrs.match]
    ctx = metricsmod.MetricContext(metric_id=params.metric_id, score_id=params.score_id,
                                   p=p, q=q, thr=corrs.threshold, cvalid=corrs.valid)
    if params.metric_id == METRIC_UNIFORMITY:
        lo, hi = aabb(src.xyz, src.valid)
        ctx.bins3 = metricsmod.uniformity_bins(p, lo, hi)
    if params.metric_id in (METRIC_CLOSEST_PLANE, METRIC_WEIGHTED_CLOSEST_PLANE,
                            METRIC_COMBINATION):
        if params.metric_id == METRIC_WEIGHTED_CLOSEST_PLANE:
            raise NotImplementedError(
                "the weighted_closest_plane metric needs ops/weights.py, which is not ported "
                "yet: see ROADMAP.md, Queue 1, item 3 ('Host-path ops')")
        cp_thr = cloud_density(tgt.xyz, tgt.valid)
        ctx.cp_threshold = cp_thr
        ctx.tgt_xyz, ctx.tgt_valid, ctx.tgt_normal = tgt.xyz, tgt.valid, tgt.normal
        n_src = int(src.count())
        valid_idx = np.nonzero(src.valid.cpu().numpy())[0]
        if sparse:
            s = max(int(SPARSE_POINTS_FRACTION * n_src), 1)
            rng = rng or np.random.default_rng(params.seed)
            sel = rng.choice(valid_idx, size=min(s, len(valid_idx)), replace=False)
        else:
            sel = valid_idx
        pad = max(128, 1 << (len(sel) - 1).bit_length()) if len(sel) else 128
        sel_p = np.zeros((pad,), np.int64)
        sel_p[:len(sel)] = sel
        ctx.sample_xyz = src.xyz[torch.from_numpy(sel_p).to(src.xyz.device)]
        ctx.sample_valid = torch.arange(pad, device=src.xyz.device) < len(sel)
        frac = SPARSE_POINTS_FRACTION if sparse else 1.0
        ctx.cp_denom = frac * max(n_src, 1)
    return ctx


def _evaluate_one(ctx: metricsmod.MetricContext, T):
    """One 4x4 transform scored: (metric, inliers, rmse, correspondence
    inlier mask bool[M], support) as device tensors (ransac._evaluate_one)."""
    T = torch.as_tensor(np.asarray(T, np.float32) if not torch.is_tensor(T) else T,
                        dtype=torch.float32, device=ctx.p.device)
    ev = metricsmod.evaluate(ctx, T[None, :3, :3], T[None, :3, 3])
    return ev["metric"][0], ev["inliers"][0], ev["rmse"][0], ev["corr_mask"][0], ev["support"][0]


def hypotheses_from_samples(p: torch.Tensor, q: torch.Tensor, rows: torch.Tensor,
                            edge_thr: float):
    """Hypotheses from sample rows [B, S] into p, q [M, 3]: reject repeated
    rows, prereject by polygon edge-length similarity
    (CorrespondenceRejectorPoly, sac_prerejective_omp.cpp:105-108, 214-217)
    and solve Kabsch per sample.  Returns (R [B,3,3], t [B,3], ok [B])."""
    B, S = rows.shape
    ok = torch.ones((B,), dtype=torch.bool, device=p.device)
    for a in range(S):
        for b in range(a + 1, S):
            ok = ok & (rows[:, a] != rows[:, b])
    p3, q3 = p[rows], q[rows]
    for a in range(S):
        b = (a + 1) % S
        ds = ((p3[:, a] - p3[:, b]) ** 2).sum(-1)
        dt = ((q3[:, a] - q3[:, b]) ** 2).sum(-1)
        ok = ok & (torch.minimum(ds, dt) >= (edge_thr**2) * torch.maximum(ds, dt))
        ok = ok & (torch.maximum(ds, dt) > 0)
    R, t = kabsch(p3, q3)
    return R, t, ok


def draw_hypotheses(p: torch.Tensor, q: torch.Tensor, generator: torch.Generator,
                    nvalid: int, B: int, S: int, edge_thr: float,
                    order: torch.Tensor | None = None):
    """Draw B sample S-tuples from the valid prefix (`order` maps sampled
    slots to rows; None when p, q are already valid-prefix compacted) and
    build their hypotheses."""
    samp = torch.randint(0, nvalid, (B, S), generator=generator, device=p.device)
    rows = samp if order is None else order[samp]
    return hypotheses_from_samples(p, q, rows, edge_thr)

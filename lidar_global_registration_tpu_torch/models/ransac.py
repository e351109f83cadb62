"""Batched prerejective RANSAC (lidar_global_registration_tpu/models/ransac.py).

Reference: src/sac_prerejective_omp.cpp (SampleConsensusPrerejectiveOMP):
draw 3 unique correspondences per iteration, prereject by polygon edge
lengths, solve the pose, score it with the metric, shrink the iteration
budget adaptively, then refit and gate the result.

Iterations become a batch of B hypotheses a round.  The sample draw and
the hypothesis body are split, so a test can feed the same sample rows to
this package and to the JAX one (their generators give different numbers
from one seed).  `ransac_rounds` is the one round loop: the staged path
(models/flagship.ransac_solve) and `align_ransac`, the host path's solver
over a MetricContext of any of the five metrics, both run it.  It reads the
host once per round (the round's best metric and the new iteration
estimate) where the JAX package runs an on-device while_loop.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from lidar_global_registration_tpu_torch.ops import metrics as metricsmod
from lidar_global_registration_tpu_torch.ops.density import cloud_density
from lidar_global_registration_tpu_torch.ops.downsample import aabb
from lidar_global_registration_tpu_torch.ops.grid import nearest_within
from lidar_global_registration_tpu_torch.ops.transform import kabsch, to_matrix4
from lidar_global_registration_tpu_torch.types import (
    DIST_TO_PLANE_COEFFICIENT,
    METRIC_CLOSEST_PLANE,
    METRIC_COMBINATION,
    METRIC_UNIFORMITY,
    METRIC_WEIGHTED_CLOSEST_PLANE,
    SPARSE_POINTS_FRACTION,
    AlignmentParameters,
    AlignmentResult,
    Cloud,
    Correspondences,
)
from lidar_global_registration_tpu_torch.utils import profiling

MIN_NR_INLIERS = 10  # sac_prerejective_omp.cpp:8
MIN_NR_FINAL_INLIERS = 20  # :9
MIN_INLIER_RATE = 0.15  # :10


def combinations_or_max(n: int, k: int) -> int:
    """calculateCombinationOrMax (utils.h:467-475)."""
    result = 1.0
    for i in range(k):
        result *= (n - i) / (i + 1)
    return int(min(result, 2**31 - 1))


def build_metric_context(src: Cloud, tgt: Cloud, corrs: Correspondences,
                         params: AlignmentParameters, sparse: bool = False,
                         generator: Optional[torch.Generator] = None) -> metricsmod.MetricContext:
    """What every evaluation of one (src, tgt, correspondences) triple
    shares (ransac.build_metric_context; the reference estimators'
    setSourceCloud / setTargetCloud / setCorrespondences, metric.cpp): the
    correspondences' points, for uniformity their bins over the source's
    box, for the closest-plane metrics the target's density (the inlier
    threshold, metric.cpp:181-186) and the source samples: every valid
    point, or with `sparse` a random SPARSE_POINTS_FRACTION of them drawn
    from `generator` (one seeded with params.seed when None).  The weighted
    metric weighs each sample by params.weight_id (ops/weights.py) and
    divides by the weights' sum."""
    p = src.xyz[corrs.query]
    q = tgt.xyz[corrs.match]
    ctx = metricsmod.MetricContext(metric_id=params.metric_id, score_id=params.score_id,
                                   p=p, q=q, thr=corrs.threshold, cvalid=corrs.valid)
    if params.metric_id == METRIC_UNIFORMITY:
        lo, hi = aabb(src.xyz, src.valid)
        ctx.bins3 = metricsmod.uniformity_bins(p, lo, hi)
    if params.metric_id in (METRIC_CLOSEST_PLANE, METRIC_WEIGHTED_CLOSEST_PLANE,
                            METRIC_COMBINATION):
        dev = src.xyz.device
        cp_thr = cloud_density(tgt.xyz, tgt.valid)
        ctx.cp_threshold = cp_thr
        ctx.tgt_xyz, ctx.tgt_valid, ctx.tgt_normal = tgt.xyz, tgt.valid, tgt.normal
        n_src = int(src.count())
        sel = torch.nonzero(src.valid).squeeze(1)
        if sparse:
            s = max(int(SPARSE_POINTS_FRACTION * n_src), 1)
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(params.seed)
            perm = torch.randperm(sel.shape[0], generator=generator, device=dev)
            sel = sel[perm[:min(s, sel.shape[0])]]
        n_sel = sel.shape[0]
        pad = max(128, 1 << (n_sel - 1).bit_length()) if n_sel else 128
        sel_p = torch.zeros((pad,), dtype=torch.int64, device=dev)
        sel_p[:n_sel] = sel
        ctx.sample_xyz = src.xyz[sel_p]
        ctx.sample_valid = torch.arange(pad, device=dev) < n_sel
        frac = SPARSE_POINTS_FRACTION if sparse else 1.0
        if params.metric_id == METRIC_WEIGHTED_CLOSEST_PLANE:
            from lidar_global_registration_tpu_torch.ops.weights import weight_function

            w_full = weight_function(params.weight_id, params.normal_nr_points, src)
            ctx.cp_weights = w_full[sel_p]
            ctx.cp_denom = frac * max(float(w_full[src.valid].sum()), 1e-30)
        else:
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


def ransac_rounds(p: torch.Tensor, q: torch.Tensor, generator: torch.Generator, nvalid: int,
                  B: int, S: int, edge_thr: float, confidence: float, n_corr,
                  max_rounds: int, budget: float,
                  score: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], tuple],
                  order: Optional[torch.Tensor] = None, best: Optional[tuple] = None):
    """The adaptive round loop (metric.cpp:103-123; ransac._ransac_adaptive):
    each round draws B hypotheses (draw_hypotheses), scores them with
    `score(R, t, ok) -> (metric f32[B], support)` (support = the best
    supporting correspondence count of the round), keeps the best, and
    shrinks the iteration estimate from the support; it stops after
    max_rounds or once the iterations reach min(estimate, budget).  `best`
    (metric, R, t) is the starting best, e.g. a guess hypothesis (-inf and
    the identity when None).  One host read a round; the rounds run are
    added to the counter solver.rounds.  Returns (best metric,
    R f32[3, 3], t f32[3], iterations, estimate)."""
    dev = p.device
    best_metric, best_R, best_t = best if best is not None else (
        -math.inf, torch.eye(3, device=dev), torch.zeros(3, device=dev))
    est, iters, i = float(2**31 - 1), 0.0, 0
    while i < max_rounds and iters < min(est, budget):
        R, t, ok = draw_hypotheses(p, q, generator, nvalid, B, S, edge_thr, order=order)
        metric, support = score(R, t, ok)
        bi = torch.argmax(metric)
        est_new = metricsmod.estimate_max_iterations(support, n_corr, confidence, S)
        m_bi, est_new = torch.stack([metric[bi], est_new.to(metric.dtype)]).tolist()
        if m_bi > best_metric:
            best_metric, best_R, best_t = m_bi, R[bi], t[bi]
        i += 1
        iters += float(B)
        est = min(est, est_new)
    profiling.count("solver.rounds", i)
    return best_metric, best_R, best_t, iters, est


def _ransac_round(ctx: metricsmod.MetricContext, R: torch.Tensor, t: torch.Tensor,
                  ok: torch.Tensor):
    """Score one round's B hypotheses with the context's metric
    (ransac._ransac_round after its draw): metric f32[B], -inf where
    prerejected or under MIN_NR_INLIERS inliers, and the best supporting
    count among the others."""
    ev = metricsmod.evaluate(ctx, R, t)
    alive = ok & (ev["inliers"] >= MIN_NR_INLIERS)
    return (torch.where(alive, ev["metric"], -torch.inf),
            torch.where(alive, ev["support"], 0).max())


def _refit(ctx: metricsmod.MetricContext, mask: torch.Tensor) -> torch.Tensor:
    """Kabsch refit on the correspondence inliers `mask` bool[M]
    (sac:282, transformation.cpp:4-38).  Returns f32[4, 4]."""
    w = (mask & ctx.cvalid).to(torch.float32)
    R, t = kabsch(ctx.p[None], ctx.q[None], w[None])
    return to_matrix4(R[0], t[0])


def _closest_plane_refit(ctx: metricsmod.MetricContext, T: torch.Tensor,
                         iterations: int = 3) -> torch.Tensor:
    """The (weighted) closest-plane refit (metric.cpp:25-46 feeding
    transformation.cpp), iterated as the JAX package does: each round moves
    the samples, takes each one's nearest target point within 2 x the
    inlier threshold (grid.nearest_within, exact), projects the moved
    sample onto that point's plane (onto the point where its normal is
    invalid) and refits by Kabsch on the inliers."""
    radius = DIST_TO_PLANE_COEFFICIENT * ctx.cp_threshold
    for _ in range(iterations):
        tp = torch.stack(metricsmod.transform_points_soa(T[None, :3, :3], T[None, :3, 3],
                                                         ctx.sample_xyz), -1)[0]
        nn, dist, found = nearest_within(ctx.tgt_xyz, ctx.tgt_valid, tp, ctx.sample_valid,
                                         max(radius, 1e-12))
        npt, nnm = ctx.tgt_xyz[nn], ctx.tgt_normal[nn]
        off = (nnm * (tp - npt)).sum(-1)
        nn_ok = (nnm * nnm).sum(-1) > 0.5
        d2p = torch.where(nn_ok, off.abs(), dist * dist)
        inlier = found & (d2p < ctx.cp_threshold)
        target = torch.where(nn_ok[:, None], tp - off[:, None] * nnm, npt)
        R, t = kabsch(ctx.sample_xyz[None], target[None], inlier.to(torch.float32)[None])
        T = to_matrix4(R[0], t[0])
    return T


@dataclass
class RansacDebug:
    """What align_ransac's loop did: iterations drawn, the last iteration
    estimate and the rounds."""

    iterations: int = 0
    estimated_iters: int = 0
    rounds: int = 0


def align_ransac(src: Cloud, tgt: Cloud, corrs: Correspondences, params: AlignmentParameters,
                 debug: Optional[RansacDebug] = None) -> AlignmentResult:
    """RANSAC alignment (SampleConsensusPrerejectiveOMP::align,
    sac_prerejective_omp.cpp:115-314; ransac.align_ransac) on the clouds'
    device: the metric context with sparse samples, the guess hypothesis
    first when params.guess is set, rounds of params.hypothesis_batch up
    to min(C(n, n_samples), max_iterations) iterations, then the inliers
    of the best pose, the convergence gates (more than MIN_NR_FINAL_INLIERS
    inliers or MIN_INLIER_RATE of the correspondences, and a metric above
    the tolerable minimum) and the refit: the closest-plane refit for the
    (weighted) closest-plane metrics, Kabsch on the correspondence inliers
    otherwise."""
    t0 = time.time()
    dev = src.xyz.device
    corrs = corrs.compact()
    n = int(corrs.count())
    S, B = params.n_samples, int(params.hypothesis_batch)
    if n < S:
        return AlignmentResult(src=src, tgt=tgt, transformation=np.eye(4, dtype=np.float32),
                               correspondences=corrs, iterations=0, converged=False,
                               time_te=time.time() - t0)
    seed = params.seed if params.fix_seed else int(np.random.default_rng().integers(2**31))
    generator = torch.Generator(device=dev).manual_seed(seed)
    ctx = build_metric_context(src, tgt, corrs, params, sparse=True, generator=generator)
    max_iter = min(combinations_or_max(n, S), params.max_iterations)
    best = None
    if params.guess is not None:  # the guess hypothesis first (sac:133-150)
        Tg = torch.as_tensor(np.asarray(params.guess, np.float32), device=dev)
        best = (float(_evaluate_one(ctx, Tg)[0]), Tg[:3, :3], Tg[:3, 3])
    max_rounds = -(-max_iter // B)
    bm, bR, bt, iters, est = ransac_rounds(
        ctx.p, ctx.q, generator, n, B, S, params.edge_thr_coef, params.confidence, n,
        max_rounds, float(max_iter), lambda R, t, ok: _ransac_round(ctx, R, t, ok), best=best)
    best_T = to_matrix4(bR, bt) if math.isfinite(bm) else torch.eye(4, device=dev)

    # the final inliers, gates, refit and re-evaluation (sac:265-296)
    metric0, inliers0, _rmse, mask0, _sup = _evaluate_one(ctx, best_T)
    n_inl = int(inliers0)
    converged = ((n_inl > MIN_NR_FINAL_INLIERS or n_inl > MIN_INLIER_RATE * n)
                 and float(metric0) > ctx.min_tolerable_metric())
    final_T, final_metric = best_T, float(metric0)
    if n_inl >= 3:
        if params.metric_id in (METRIC_CLOSEST_PLANE, METRIC_WEIGHTED_CLOSEST_PLANE):
            final_T = _closest_plane_refit(ctx, best_T)
        else:
            final_T = _refit(ctx, mask0)
        final_metric = float(_evaluate_one(ctx, final_T)[0])
    if debug is not None:
        debug.iterations, debug.estimated_iters = int(iters), int(min(est, 2**31 - 1))
        debug.rounds = int(iters) // B
    return AlignmentResult(src=src, tgt=tgt,
                           transformation=final_T.cpu().numpy().astype(np.float32),
                           correspondences=corrs, iterations=int(iters), converged=converged,
                           time_te=time.time() - t0, metric=final_metric)

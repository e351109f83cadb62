"""Staged registration, keypoint-any route
(lidar_global_registration_tpu/models/flagship.py `register_pair_staged`).

The route the JAX package takes with `use_iss=False` and its cell kernels
on (flagship.py:1795-1836, 1857-1872, 1940-1957):

  plan       four cell grids: each side at normal_cell and feature_radius
  surface    K1 normals + k=2 smoothed density per side
  fpfh       K5 SPFH then K6 combine per side, over every valid point
  match      K7 exact descriptor 1-NN, source->target and target->source
  corr       mutual pairs + per-pair thresholds (_correspondence_stage)
  ransac     compaction, degree prefilter, batched prerejective RANSAC with
             the correspondences score, Kabsch refit (ransac_solve)

Settings that would send the JAX function down another route raise
NotImplementedError naming the ROADMAP.md item that ports it.  There are no
learned weights: what carries over from the JAX package is its config
(`config_from_jax`) and the radii (ops/density.derive_radii).
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import torch

from lidar_global_registration_tpu_torch.models.ransac import draw_hypotheses
from lidar_global_registration_tpu_torch.ops import cellgrid, matchers
from lidar_global_registration_tpu_torch.ops.metrics import (
    estimate_max_iterations,
    transform_points_soa,
)
from lidar_global_registration_tpu_torch.ops.transform import kabsch, to_matrix4

MIN_NR_INLIERS = 10
MIN_NR_FINAL_INLIERS = 20
MIN_INLIER_RATE = 0.15

# (field, value the slice supports, ROADMAP.md item that ports the others)
_SLICE_ONLY = (
    ("use_iss", False, "'ISS keypoints: K2-K4 + iss_pass'"),
    ("descriptor", "fpfh", "'SHOT'"),
    ("alignment", "ransac", "'GROR'"),
    ("pyramid", False, "'staged pyramid'"),
    ("bf16_matching", False, "'exact top-40 kNN' (matcher variants)"),
    ("metric", "correspondences", "'uniformity metric'"),
    ("use_cell_fpfh", True, "'host-path ops' (grid-hash neighbour search)"),
)


@dataclass(frozen=True)
class FlagshipConfig:
    """The fields of the JAX FlagshipConfig this route reads, with the JAX
    defaults; use_iss defaults to False, the only value ported so far."""

    rounds: int = 8
    hypothesis_batch: int = 512
    n_samples: int = 3
    edge_thr: float = 0.95
    confidence: float = 0.999
    use_iss: bool = False
    bf16_matching: bool = False
    match_tile: int = 2048
    use_cell_fpfh: bool = True
    metric: str = "correspondences"
    descriptor: str = "fpfh"
    degree_top: int = 800
    ransac_compact: int = 4096
    alignment: str = "ransac"
    pyramid: bool = False

    def __post_init__(self):
        for field, value, item in _SLICE_ONLY:
            if getattr(self, field) != value:
                raise NotImplementedError(
                    f"{field}={getattr(self, field)!r} takes a route that is not "
                    f"ported yet: see ROADMAP.md, {item}"
                )


def config_from_jax(cfg: dict) -> FlagshipConfig:
    """The port's config from `dataclasses.asdict(jax_flagship_config)`:
    the fields this route reads are copied, the rest (which only other
    routes read) are dropped.  Raises NotImplementedError on a setting
    outside the route."""
    names = {f.name for f in dataclasses.fields(FlagshipConfig)}
    return FlagshipConfig(**{k: v for k, v in cfg.items() if k in names})


def _subset_sel(cvalid: torch.Tensor, M: int) -> torch.Tensor:
    """Rows compacting a masked correspondence set to M: valid rows first in
    row order; with more than M valid, an evenly strided sample over row
    order (flagship._subset_sel)."""
    sel = torch.argsort((~cvalid).to(torch.int8), stable=True)
    K = int(cvalid.sum())
    ar = torch.arange(M, dtype=torch.int64, device=cvalid.device)
    if K > M:
        ar = ar * (K // M) + (ar * (K % M)) // M
    return sel[ar]


def _correspondence_stage(idx_st, mask_st, idx_ts, mask_ts, dens_s, dens_t,
                          distance_thr: float):
    """Mutual 1-NN pairs (lr strategy, matching.h:418-458) and per-pair
    thresholds min(max(density_s, density_t), distance_thr)
    (flagship._correspondence_stage with require_mutual=True)."""
    N = idx_st.shape[0]
    j = idx_st[:, 0]
    keep = mask_st[:, 0] & mask_ts[j, 0] & (
        idx_ts[j, 0] == torch.arange(N, device=j.device))
    thr = torch.minimum(torch.maximum(dens_s, dens_t[j]),
                        torch.tensor(distance_thr, dtype=torch.float32, device=j.device))
    thr = torch.where(thr > 0, thr, distance_thr)
    return j, keep, thr


def _pdist(a: torch.Tensor) -> torch.Tensor:
    """Pairwise distances by the Gram trick (full float32: TF32 is off)."""
    g = a @ a.T
    n2 = torch.diagonal(g)
    return (n2[:, None] + n2[None, :] - 2.0 * g).clamp_min(0.0).sqrt()


def ransac_solve(p, q, thr, cvalid, generator: torch.Generator, cfg: FlagshipConfig):
    """Batched prerejective RANSAC over masked correspondences
    (flagship.ransac_solve, correspondences score).  The JAX package's
    on-device while_loop becomes a Python loop over at most cfg.rounds
    rounds with one host read per round (best metric of the round and the
    new iteration estimate)."""
    if cfg.ransac_compact and cfg.ransac_compact < p.shape[0]:
        sel = _subset_sel(cvalid, cfg.ransac_compact)
        p, q, thr, cvalid = p[sel], q[sel], thr[sel], cvalid[sel]
    if cfg.degree_top and cfg.degree_top < p.shape[0] <= 8192:
        # GROR-style node-reliability prefilter (ia_gror.hpp:126-194):
        # keep the correspondences with the most length-consistent partners;
        # centred first so the Gram trick keeps the geometry in float32
        pv = cvalid.to(torch.float32)
        nv = pv.sum().clamp_min(1.0)
        pc = (p - (p * pv[:, None]).sum(0) / nv) * pv[:, None]
        qc = (q - (q * pv[:, None]).sum(0) / nv) * pv[:, None]
        eps_ij = 2.0 * torch.maximum(thr[:, None], thr[None, :])
        consistent = ((_pdist(pc) - _pdist(qc)).abs() < eps_ij) & cvalid[None, :] & cvalid[:, None]
        deg = consistent.sum(1)
        kth = torch.sort(deg).values[-cfg.degree_top]
        cvalid = cvalid & (deg >= torch.clamp_min(kth, 3))
    dev = p.device
    n_corr = cvalid.to(torch.float32).sum()
    order = torch.argsort((~cvalid).to(torch.int8), stable=True)  # valid rows first
    nvalid = max(int(n_corr), 1)
    B, S = cfg.hypothesis_batch, cfg.n_samples
    best_metric = -1.0
    best_R = torch.eye(3, device=dev)
    best_t = torch.zeros(3, device=dev)
    budget = float(cfg.rounds * B)
    est, iters, i = float(2**31 - 1), 0.0, 0
    while i < cfg.rounds and iters < min(est, budget):
        R, t, ok = draw_hypotheses(p, q, generator, nvalid, B, S, cfg.edge_thr, order=order)
        tx, ty, tz = transform_points_soa(R, t, p)
        d2 = (tx - q[:, 0][None]) ** 2 + (ty - q[:, 1][None]) ** 2 + (tz - q[:, 2][None]) ** 2
        inl = (d2.clamp_min(0.0).sqrt() < thr[None]) & cvalid[None]
        cnt = inl.sum(1)
        alive = ok & (cnt >= MIN_NR_INLIERS)
        metric = torch.where(alive, cnt.to(torch.float32) / n_corr.clamp_min(1.0), -1.0)
        bi = torch.argmax(metric)
        support = torch.where(alive, cnt, 0).max()
        est_new = estimate_max_iterations(support, n_corr, cfg.confidence, S)
        m_bi, est_new = torch.stack([metric[bi], est_new]).tolist()  # the round's host read
        if m_bi > best_metric:
            best_metric, best_R, best_t = m_bi, R[bi], t[bi]
        i += 1
        iters += float(B)
        est = min(est, est_new)

    # final: rebuild inliers, Kabsch refit, convergence gates (sac:265-296)
    def _inliers(Rm, tv):
        tx, ty, tz = transform_points_soa(Rm[None], tv[None], p)
        tp = torch.stack([tx[0], ty[0], tz[0]], -1)
        return (((tp - q) ** 2).sum(-1).clamp_min(0.0).sqrt() < thr) & cvalid

    inl = _inliers(best_R, best_t)
    n_inl = inl.sum()
    Rf, tf = kabsch(p[None], q[None], inl.to(torch.float32)[None])
    T = to_matrix4(Rf[0], tf[0])
    inl2 = _inliers(Rf[0], tf[0]).sum()
    metric = inl2.to(torch.float32) / n_corr.clamp_min(1.0)
    # the convergence gate reads the PRE-refit inliers while the returned
    # pose and metric come from the refit, as the reference does (sac:276-282)
    converged = ((n_inl > MIN_NR_FINAL_INLIERS)
                 | (n_inl.to(torch.float32) > MIN_INLIER_RATE * n_corr)) & (best_metric > 0.0)
    if not best_metric > 0.0:
        T = torch.eye(4, device=dev)
    return {
        "transformation": T,
        "metric": metric,
        "inliers": inl2,
        "converged": converged,
        "n_correspondences": n_corr,
        "iterations": iters,
    }


def register_pair_staged(
    src_xyz, src_valid, tgt_xyz, tgt_valid, generator: torch.Generator,
    normal_cell, density_cell_src, density_cell_tgt,
    iss_radius_src, iss_radius_tgt, feature_radius, distance_thr,
    vp_src=None, vp_tgt=None,
    cfg: FlagshipConfig = FlagshipConfig(),
    return_correspondences: bool = False,
    stage_times: dict | None = None,
):
    """Register one padded pair on the tensors' device (the keypoint-any
    route of the JAX register_pair_staged).  `generator` (on the same
    device) drives the RANSAC draws.  When `stage_times` is a dict, each
    stage is synchronised and its wall seconds recorded there under the
    JAX package's LGR_STAGE_TIMING labels.  Returns the JAX result dict
    (transformation, metric, inliers, converged, n_correspondences,
    iterations), plus "correspondences" = (query rows, matched rows,
    thresholds) of the mutual set when return_correspondences."""
    # Full float32 matmuls: the degree prefilter's Gram-trick distances
    # cancel |a|^2 + |b|^2 - 2ab, which TF32's 10-bit mantissa turns into
    # noise at scene scale (flagship.py:262-270), and the plain 1-NN's
    # q @ t.T would change its argmin ties.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if src_xyz.shape[0] != tgt_xyz.shape[0]:
        raise ValueError(
            f"register_pair_staged requires equal padded capacities "
            f"(got src {src_xyz.shape[0]} vs tgt {tgt_xyz.shape[0]})"
        )
    dev = src_xyz.device
    last = [time.perf_counter()]

    def _t(label):
        if stage_times is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            stage_times[label] = now - last[0]
            last[0] = now

    normal_cell, feature_radius, distance_thr = (
        float(v) for v in (normal_cell, feature_radius, distance_thr))
    plans = [cellgrid.plan_grid(x, v, c)
             for x, v in ((src_xyz, src_valid), (tgt_xyz, tgt_valid))
             for c in (normal_cell, feature_radius)]
    _t("plan")

    def side(plan_n, plan_f, valid, vp, which):
        normal, _curv, density, _eig, _ok = cellgrid.surface_pass(plan_n, normal_cell, vp)
        _t(f"side_{which}")
        feat, fv = cellgrid.fpfh_pass(cellgrid.set_normals(plan_f, normal), feature_radius)
        _t(f"fpfh_{which}")
        return density, feat, fv & valid

    dens_s, fq, fq_valid = side(plans[0], plans[1], src_valid, vp_src, "src")
    dens_t, ft, ft_valid = side(plans[2], plans[3], tgt_valid, vp_tgt, "tgt")

    N_all = src_valid.shape[0]
    n_q, n_t = (int(v) for v in torch.stack([fq_valid.sum(), ft_valid.sum()]).tolist())
    if min(n_q, n_t) > 0 and max(n_q, n_t) <= N_all // 2:
        raise NotImplementedError(
            f"{n_q}/{n_t} descriptor rows of {N_all} take the compacted cluster "
            "matching stage (_compact_match_corr_stage): see ROADMAP.md, "
            "'cluster matching stage'"
        )
    idx_st, _d1, mask_st = matchers.match_bf(fq, ft, fq_valid, ft_valid, k=1, tile=cfg.match_tile)
    _t("match_st")
    idx_ts, _d2, mask_ts = matchers.match_bf(ft, fq, ft_valid, fq_valid, k=1, tile=cfg.match_tile)
    _t("match_ts")
    j, mutual, thr = _correspondence_stage(idx_st, mask_st, idx_ts, mask_ts,
                                           dens_s, dens_t, distance_thr)
    _t("corr")
    res = ransac_solve(src_xyz, tgt_xyz[j], thr, mutual, generator, cfg)
    _t("ransac")
    if return_correspondences:
        rows = torch.nonzero(mutual).squeeze(1)
        res["correspondences"] = (rows, j[rows], thr[rows])
    return res

"""Batched registration of many scan pairs over a ('dp', 'tp') mesh
(lidar_global_registration_tpu/parallel/batch.py).

make_register_batch(mesh, cfg) splits the pair batch over dp, and inside
each pair the rows over tp (_pair_step_tp): every peer holds the whole
pair (the plans are cheap and every query needs the whole neighbour
structure) and computes the products of its shard of rows, N / tp of them:

  normals + density  flagship._side_stage at the shard's rows: the exact
                     radius query of the rows, then their PCA normals; the
                     density's smoothing neighbour may lie on another
                     shard, so it reads the gathered raw distances
  ISS                cellgrid.iss_pass at the shard's rows: K2, K3 and K4's
                     slot-list forms at the rows' plan slots, each pass
                     reading the whole cloud's result of the one before,
                     gathered
  FPFH               K5's slot-list form at the shard's rows, the whole
                     SPFH table gathered, the float32 combine at the
                     shard's keypoints (ops/fpfh); or SHOT at them
  matching           the 1-NN both ways with the train side split over tp
                     (match_bf_tp: K7 on each shard, the winners merged),
                     the cluster gate's keypoint kNN the same way with the
                     self row left out by id (K8 on each shard on the
                     card), then ransac_solve on every peer from the same
                     seed.

Every per-row product is gathered in rank order, so each peer holds the
whole-cloud arrays of the one-process step (models/flagship
.register_pair_step).  The neighbour lists of a shard are padded to the
widest row of the whole cloud (the most any peer's rows have), the width
the one-process query gives them, so each row's float32 sums run over the
same blocks: the FPFH step is the one-process step bit for bit, but for
the cluster gate's keypoint kNN where float32 distances tie exactly across
its k-th place (match_bf_tp).  SHOT's blocks are not padded so, and its
rows may differ from the step's in the last bits.
make_register_batch(None, cfg) is a loop of register_pair_step in one
process.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from lidar_global_registration_tpu_torch.models import flagship as fl
from lidar_global_registration_tpu_torch.ops import fpfh, matchers
from lidar_global_registration_tpu_torch.parallel.mesh import gather_rows, pair_sharding


def match_bf_tp(fq, ft_shard, fq_valid, ft_valid_shard, k: int, tile: int, bf16: bool, group,
                exclude_self: bool = False):
    """Exact k-NN with the train side split over the peers of `group`: each
    matches every query against its shard (rows rank * shard.. of the whole
    train set), the tp * k candidates of a query are gathered and the k
    nearest kept, ties to the lowest global index (K7's rule).
    exclude_self: same-set k-NN, a train row left out for the query whose
    row is its global id.  Returns match_bf's (idx i64[Nq, k] global rows,
    dist, mask).  At k = 1 without exclude_self (K7 on each shard) this is
    the one-process match_bf bit for bit.  The keypoint kNN (xyz rows) runs
    K8 on the card, on each shard and in one process alike, which keeps the
    lowest index among equal d2 as this merge does: the same rows but where
    two unequal float32 d2 round to one distance across the k-th place.  On
    the CPU, torch.topk keeps float32 d2 ties across the k-th place in an
    unspecified order."""
    offset = dist.get_rank(group) * ft_shard.shape[0]
    exclude = torch.arange(fq.shape[0], device=fq.device) if exclude_self else None
    idx, d, m = matchers.match_bf(fq, ft_shard, fq_valid, ft_valid_shard, k=k, tile=tile,
                                  bf16=bf16, exclude_ids=exclude, id_offset=offset)
    Nq = fq.shape[0]

    def merged(x):  # [Nq, k] per peer -> [Nq, tp * k], peer-major
        return gather_rows(x[None], group).permute(1, 0, 2).reshape(Nq, -1)

    all_i, all_d, all_m = merged(idx + offset), merged(d), merged(m)
    key = torch.where(all_m, all_d, math.inf)
    order = torch.argsort(all_i, dim=1, stable=True)
    order = order.gather(1, torch.argsort(key.gather(1, order), dim=1, stable=True))[:, :k]
    out_m = all_m.gather(1, order)
    return torch.where(out_m, all_i.gather(1, order), 0), all_d.gather(1, order), out_m


def _fpfh_rows(xyz, normal, valid, kp, radius: float, rows: slice, gather):
    """flagship._fpfh_fixed at the shard's rows: K5 there, the SPFH table
    gathered, the combine at the shard's keypoints.  Returns the whole
    cloud's (feat f32[N, 33], valid bool[N])."""
    plan = fpfh.surface_plan(xyz, valid, normal, radius)
    shard = torch.arange(rows.start, rows.stop, device=xyz.device)
    spfh_all = gather(fpfh.spfh_rows(plan, radius, shard))
    kpv_l = (valid & kp)[rows]
    kr = torch.nonzero(kpv_l).squeeze(1)
    g = kr + rows.start
    kidx, kdist, kmask = fl._widen(*fpfh.keypoint_neighbors(plan, xyz[g], radius), gather)
    feat_k, kcnt_k = fpfh.combine_at(xyz[g], normal[g], xyz, normal, spfh_all, kidx, kdist,
                                     kmask)
    feat = torch.zeros((shard.shape[0], fpfh.DIM), dtype=torch.float32, device=xyz.device)
    kcnt = torch.zeros((shard.shape[0],), dtype=torch.int64, device=xyz.device)
    feat[kr], kcnt[kr] = feat_k, kcnt_k
    fv = kpv_l & (kcnt > 0)
    return gather(torch.where(fv[:, None], feat, 0.0)), gather(fv)


def _pair_step_tp(src_xyz, src_valid, tgt_xyz, tgt_valid, generator: torch.Generator, radii,
                  vp_src, vp_tgt, cfg: fl.FlagshipConfig, group):
    """register_pair_step with its rows split over the peers of `group`
    (JAX _pair_step_tp, parallel/batch.py:65-238): each side's normals,
    density and ISS keypoints, then FPFH or SHOT, at the shard's rows; the
    1-NN both ways and the cluster gate's keypoint kNN with the train side
    split (match_bf_tp); ransac_solve on every peer from the same
    generator.  Returns ransac_solve's dict, the same on every peer."""
    normal_cell, _ds, _dt, iss_src, iss_tgt, feature_radius, distance_thr = radii
    N = src_xyz.shape[0]
    tp, ti = dist.get_world_size(group), dist.get_rank(group)
    if N % tp or tgt_xyz.shape[0] != N:
        raise ValueError(f"pad both clouds to one row count that tp = {tp} divides, got "
                         f"{N} and {tgt_xyz.shape[0]}")
    shard = N // tp
    rows = slice(ti * shard, (ti + 1) * shard)

    def gather(x):
        return gather_rows(x, group)

    sides = []
    for xyz, valid, iss_r, vp in ((src_xyz, src_valid, iss_src, vp_src),
                                  (tgt_xyz, tgt_valid, iss_tgt, vp_tgt)):
        normal, kp, dens = fl._side_stage(xyz, valid, normal_cell, iss_r, cfg, vp, rows=rows,
                                          gather=gather)
        if cfg.descriptor == "shot":
            feat_l, fv_l = fl._shot_stage(xyz[rows], normal[rows], (valid & kp)[rows], xyz,
                                          normal, valid, feature_radius, cfg)
            feat, fv = gather(feat_l), gather(fv_l)
        else:
            feat, fv = _fpfh_rows(xyz, normal, valid, kp, feature_radius, rows, gather)
        sides.append((feat, fv, dens))
    (fq, fqv, dens_s), (ft, ftv, dens_t) = sides

    def nn(q, t, qv, tv):
        idx, _d, mask = match_bf_tp(q, t[rows], qv, tv[rows], 1, cfg.match_tile,
                                    cfg.bf16_matching, group)
        return idx, mask

    def knn_self(pts, valid, k: int):
        return match_bf_tp(pts, pts[rows], valid, valid[rows], k, cfg.cluster_knn_tile, False,
                           group, exclude_self=True)

    nn_pairs = (*nn(fq, ft, fqv, ftv), *nn(ft, fq, ftv, fqv))
    return fl._filter_and_solve(src_xyz, tgt_xyz, fqv, ftv, nn_pairs, dens_s, dens_t,
                                distance_thr, generator, cfg, knn_self)


def make_register_batch(mesh, cfg: fl.FlagshipConfig = fl.FlagshipConfig()):
    """The batch-registration step for `cfg` over `mesh` (parallel/mesh
    .make_mesh), or in one process without one (mesh None):

        step(src [B, N, 3], src_valid [B, N], tgt [B, N, 3], tgt_valid [B, N],
             seeds, scalars [B, 7], vps [B, 2, 3]) -> (T [B, 4, 4], inliers [B],
             n_correspondences [B])

    scalars hold each pair's (normal_cell, density_cell_src,
    density_cell_tgt, iss_radius_src, iss_radius_tgt, feature_radius,
    distance_thr); vps the scanner viewpoints (src, tgt), zeros for the
    origin; seeds B ints or torch.Generators on the tensors' device (the JAX
    package's [B, 2] PRNG keys).  Over a mesh every process passes the whole
    batch and gets the whole result: it registers the B / dp pairs of its dp
    rank with its tp peers (_pair_step_tp; N a multiple of tp), and the
    results are gathered over dp.  Runs on the tensors' device."""

    def one(src, src_valid, tgt, tgt_valid, seed, scalars, vps, group):
        gen = seed if isinstance(seed, torch.Generator) else torch.Generator(
            device=src.device).manual_seed(int(seed))
        radii = fl._radii(*scalars.tolist())
        if group is None:
            return fl.register_pair_step(src, src_valid, tgt, tgt_valid, gen, *radii,
                                         vp_src=vps[0], vp_tgt=vps[1], cfg=cfg)
        return _pair_step_tp(src, src_valid, tgt, tgt_valid, gen, radii, vps[0], vps[1], cfg,
                             group)

    def step(src, src_valid, tgt, tgt_valid, seeds, scalars, vps):
        if not len(seeds) == src.shape[0] == tgt.shape[0] == scalars.shape[0] == vps.shape[0]:
            raise ValueError("one seed, scalar row and viewpoint pair per pair of the batch")
        group = None
        if mesh is not None:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            take = pair_sharding(mesh)
            src, src_valid, tgt, tgt_valid, seeds, scalars, vps = (
                take(x) for x in (src, src_valid, tgt, tgt_valid, seeds, scalars, vps))
            group = mesh.get_group("tp")
        outs = [one(*args, group) for args in zip(src, src_valid, tgt, tgt_valid, seeds,
                                                  scalars, vps)]
        res = tuple(torch.stack([o[k] for o in outs])
                    for k in ("transformation", "inliers", "n_correspondences"))
        if mesh is None:
            return res
        return tuple(gather_rows(r, mesh.get_group("dp")) for r in res)

    return step

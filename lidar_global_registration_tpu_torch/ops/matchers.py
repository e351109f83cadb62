"""Descriptor-space matching (lidar_global_registration_tpu/ops/matchers.py).

The exact k=1 matcher runs the 1-NN kernel of ops/nn_l2.py
(matchers.py:84-91 routes the JAX package's k=1 to its Pallas counterpart
the same way), also for the bf16 matcher (its bfloat16-rounded form, see
ops/nn_l2.py) and for any descriptor width; on a train shard it returns
local rows, and the caller adds the shard's offset (parallel/batch.py).
k > 1 and the same-set self exclusion (`exclude_diag`, or `exclude_ids`
with `id_offset` on a shard of the set: the cluster matcher's keypoint kNN)
are an exact top-k: over xyz rows on the card (width 3, k <= 64) the
kernel K8 of ops/nn_l2.py (nn_l2.takes_knn_xyz: the cluster gate's
keypoint kNN, ties to the lowest index); every other call, and every call
on the CPU, the tiled top-k in plain PyTorch, `_topk_l2`: `torch.topk` over
query tiles of the Gram-trick distance matrix, with the JAX package's BIG
masking and self exclusion by id (matchers.py:55-77, 92-149).  The JAX package's `approx=True`
(per-tile `lax.approx_max_k`, a TPU PartialReduce) is not a Pallas kernel;
here the set is always exact, as JAX computes it on the CPU.

match_local (matchers.py:152-184) is the guess-guided matcher: the train
keypoints within a radius of each moved query (ops/grid.radius_neighbors,
exact), ranked by descriptor distance.
"""
from __future__ import annotations

import torch

from lidar_global_registration_tpu_torch.ops import cellgrid
from lidar_global_registration_tpu_torch.ops.grid import radius_neighbors
from lidar_global_registration_tpu_torch.ops.nn_l2 import (
    BIG,
    bf16_round,
    knn_xyz_cuda,
    nn_l2,
    takes_knn_xyz,
)

_TOPK_SLOTS = 1 << 27  # distance slots per query tile of the top-k


def _topk_l2(query, train, tvalid, k: int, exclude_ids, id_offset: int = 0,
             bf16: bool = False):
    """(best d2 f32[Nq, k] ascending, best index i64[Nq, k]) over every
    train row; invalid rows and (exclude_ids i64[Nq] or None) the train row
    whose id_offset + local id is the query's exclude id carry BIG.  bf16:
    the dot products of the bfloat16-rounded rows, the norms of the float32
    rows."""
    Nq, Nt = query.shape[0], train.shape[0]
    qn = (query * query).sum(1)
    tn = (train * train).sum(1)
    if bf16:
        query, train = bf16_round(query), bf16_round(train)
    kk = min(k, Nt)
    best_d = torch.full((Nq, k), BIG, dtype=torch.float32, device=query.device)
    best_i = torch.zeros((Nq, k), dtype=torch.int64, device=query.device)
    tile = max(1, _TOPK_SLOTS // max(Nt, 1))
    ids = torch.arange(Nt, device=query.device)
    for s in range(0, Nq, tile):
        q = query[s:s + tile]
        d2 = (qn[s:s + tile, None] + tn[None, :] - 2.0 * (q @ train.T)).clamp_min(0.0)
        d2 = torch.where(tvalid[None, :], d2, BIG)
        if exclude_ids is not None:
            own = exclude_ids[s:s + tile] - id_offset
            d2 = torch.where(ids[None, :] == own[:, None], BIG, d2)
        vals, sel = torch.topk(d2, kk, dim=1, largest=False, sorted=True)
        best_d[s:s + tile, :kk] = vals
        best_i[s:s + tile, :kk] = sel
    return best_d, best_i


def match_bf(query: torch.Tensor, train: torch.Tensor, qvalid: torch.Tensor,
             tvalid: torch.Tensor, k: int = 1, tile: int = 4096, bf16: bool = False,
             exclude_diag: bool = False, exclude_ids: torch.Tensor | None = None,
             id_offset: int = 0):
    """Exact k-NN in descriptor space (L2).  Returns (idx i64[Nq, k] local
    train rows, dist f32[Nq, k] euclidean, mask bool[Nq, k]).  `tile` is
    the JAX package's train tile; it shapes only the plain 1-NN's query
    chunks here.  bf16: the dot products from bfloat16-rounded rows, the
    norms from the float32 rows (matchers.py:93-107).  exclude_ids
    (i64[Nq]) with id_offset: same-set k-NN where `train` is a shard of the
    query set (its rows from id_offset on); a train row is left out for
    query q when id_offset + its local id == exclude_ids[q].  exclude_diag
    is the unsharded case (exclude_ids = the query rows, id_offset 0).
    Over xyz rows on the card (takes_knn_xyz) k > 1 and the same-set k-NN
    run K8, whose ties go to the lowest index."""
    if k == 1 and exclude_ids is None and not exclude_diag:
        idx, dist, mask = nn_l2(query, train, qvalid, tvalid, tile=tile, bf16=bf16)
        return idx[:, None], dist[:, None], mask[:, None]
    if takes_knn_xyz(query, k, bf16):
        best_d, best_i = knn_xyz_cuda(query, train, qvalid, tvalid, k, exclude_ids,
                                      int(id_offset), exclude_diag)
    else:
        if exclude_diag:
            exclude_ids = torch.arange(query.shape[0], device=query.device)
        best_d, best_i = _topk_l2(query, train, tvalid, k, exclude_ids, int(id_offset), bf16)
    mask = (best_d < BIG) & qvalid[:, None]
    dist = torch.where(mask, best_d, BIG).clamp_min(0.0).sqrt()
    return torch.where(mask, best_i, 0), dist, mask


def match_local(query_xyz, qvalid, query_feats, train_xyz, tvalid, train_feats, guess,
                search_radius: float, k: int = 1, cand: int = 64):
    """Guess-guided local matching (matchers.match_local, matching.h:637-678):
    each query moved by `guess` (f32[4, 4]), its `cand` nearest train points
    within `search_radius` (exact; the JAX package keeps 32 points a cell),
    ranked by descriptor L2 in candidate order, so a tie goes to the
    candidate nearer in 3D (lax.top_k's lowest position).  Returns (idx
    i64[Nq, k], dist f32[Nq, k], mask bool[Nq, k]) like match_bf."""
    dev = query_xyz.device
    g = torch.as_tensor(guess, dtype=torch.float32, device=dev)
    R, t = g[:3, :3], g[:3, 3]
    x, y, z = query_xyz[:, 0], query_xyz[:, 1], query_xyz[:, 2]
    tq = torch.stack([R[i, 0] * x + R[i, 1] * y + R[i, 2] * z + t[i] for i in range(3)], 1)
    Nq = query_xyz.shape[0]
    idx = torch.zeros((Nq, k), dtype=torch.int64, device=dev)
    d2 = torch.full((Nq, k), BIG, dtype=torch.float32, device=dev)
    if bool(tvalid.any()):
        # a zero radius finds only coincident points; the plan's cell then
        # comes from the train cloud's extent, so its keys stay in range
        ext = float((train_xyz[tvalid].amax(0) - train_xyz[tvalid].amin(0)).max())
        plan = cellgrid.plan_grid(train_xyz, tvalid, max(float(search_radius), 1e-6 * ext, 1e-30))
        cidx, _cdist, cmask = radius_neighbors(plan, tq, qvalid, float(search_radius), cand)
        cd2 = ((train_feats[cidx] - query_feats[:, None, :]) ** 2).sum(-1)
        cd2 = torch.where(cmask, cd2, BIG)
        kk = min(k, cd2.shape[1])
        vals, sel = torch.sort(cd2, dim=1, stable=True)
        d2[:, :kk] = vals[:, :kk]
        idx[:, :kk] = cidx.gather(1, sel[:, :kk])
    mask = d2 < BIG
    return torch.where(mask, idx, 0), d2.clamp_min(0.0).sqrt(), mask

"""Descriptor-space matching (lidar_global_registration_tpu/ops/matchers.py).

The exact k=1 matcher runs the 1-NN kernel of ops/nn_l2.py
(matchers.py:84-91 routes the JAX package's k=1 to its Pallas counterpart
the same way).  k > 1 and the same-set self exclusion (`exclude_diag`, the
cluster matcher's keypoint kNN) are an exact tiled top-k in plain PyTorch:
`torch.topk` over query tiles of the Gram-trick distance matrix, with the
JAX package's BIG masking and self exclusion by id (matchers.py:92-149).
The JAX package's `approx=True` (per-tile `lax.approx_max_k`, a TPU
PartialReduce) is not a Pallas kernel; here the set is always exact, as
JAX computes it on the CPU.
"""
from __future__ import annotations

import torch

from lidar_global_registration_tpu_torch.ops.nn_l2 import BIG, nn_l2

_TOPK_SLOTS = 1 << 27  # distance slots per query tile of the top-k


def _topk_l2(query, train, tvalid, k: int, exclude_diag: bool):
    """(best d2 f32[Nq, k] ascending, best index i64[Nq, k]) over every
    train row; invalid rows and (exclude_diag) the query's own id carry
    BIG."""
    Nq, Nt = query.shape[0], train.shape[0]
    qn = (query * query).sum(1)
    tn = (train * train).sum(1)
    kk = min(k, Nt)
    best_d = torch.full((Nq, k), BIG, dtype=torch.float32, device=query.device)
    best_i = torch.zeros((Nq, k), dtype=torch.int64, device=query.device)
    tile = max(1, _TOPK_SLOTS // max(Nt, 1))
    ids = torch.arange(Nt, device=query.device)
    for s in range(0, Nq, tile):
        q = query[s:s + tile]
        d2 = (qn[s:s + tile, None] + tn[None, :] - 2.0 * (q @ train.T)).clamp_min(0.0)
        d2 = torch.where(tvalid[None, :], d2, BIG)
        if exclude_diag:
            own = torch.arange(s, s + q.shape[0], device=query.device)
            d2 = torch.where(ids[None, :] == own[:, None], BIG, d2)
        vals, sel = torch.topk(d2, kk, dim=1, largest=False, sorted=True)
        best_d[s:s + tile, :kk] = vals
        best_i[s:s + tile, :kk] = sel
    return best_d, best_i


def match_bf(query: torch.Tensor, train: torch.Tensor, qvalid: torch.Tensor,
             tvalid: torch.Tensor, k: int = 1, tile: int = 4096, bf16: bool = False,
             exclude_diag: bool = False):
    """Exact k-NN in descriptor space (L2).  Returns (idx i64[Nq, k],
    dist f32[Nq, k] euclidean, mask bool[Nq, k]).  `tile` is the JAX
    package's train tile; it shapes only the plain 1-NN's query chunks here."""
    if bf16:
        raise NotImplementedError(
            "match_bf(bf16=True): the bf16 matcher is not ported; see ROADMAP.md, "
            "'host-path ops' (matcher variants)"
        )
    if k == 1 and not exclude_diag:
        idx, dist, mask = nn_l2(query, train, qvalid, tvalid, tile=tile)
        return idx[:, None], dist[:, None], mask[:, None]
    best_d, best_i = _topk_l2(query, train, tvalid, k, exclude_diag)
    mask = (best_d < BIG) & qvalid[:, None]
    dist = torch.where(mask, best_d, BIG).clamp_min(0.0).sqrt()
    return torch.where(mask, best_i, 0), dist, mask

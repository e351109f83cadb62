"""Exact 1-NN in descriptor space (lidar_global_registration_tpu/ops/pallas/topk_l2.py).

d2 = |q|^2 + |t|^2 - 2 q.t; the running argmin keeps the lowest index among
equal minima, and an invalid train row carries |t|^2 = BIG so it never
wins.  The kernel (csrc/nn_l2.cu) keeps the distance tile on chip; the plain
version materialises it one query chunk at a time.
"""
from __future__ import annotations

import torch

from lidar_global_registration_tpu_torch import kernels

BIG = 3.0e38


def _norms(query, train, tvalid):
    qn = (query * query).sum(1)
    tn = torch.where(tvalid, (train * train).sum(1), BIG)
    return qn.contiguous(), tn.contiguous()


def nn_l2_plain(query, train, tvalid, tile: int = 4096):
    """Plain version: (best d2 f32[Nq], best index i32[Nq]) over chunks of
    `tile` queries (the first index of the minimum, BIG / 0 when every train
    row is invalid)."""
    qn, tn = _norms(query, train, tvalid)
    d2_best = torch.empty((query.shape[0],), dtype=torch.float32, device=query.device)
    i_best = torch.empty((query.shape[0],), dtype=torch.int32, device=query.device)
    for s in range(0, query.shape[0], tile):
        q = query[s:s + tile]
        d2 = qn[s:s + tile, None] + tn[None, :] - 2.0 * (q @ train.T)
        v, i = d2.min(1)
        d2_best[s:s + tile] = v
        i_best[s:s + tile] = torch.where(v < BIG, i, 0).to(torch.int32)
    return d2_best, i_best


def nn_l2_cuda(query, train, tvalid):
    """K7 · csrc/nn_l2.cu: same contract as nn_l2_plain (D <= 512)."""
    Nq, D = query.shape
    Nt = train.shape[0]
    if D > 512:
        raise ValueError(f"nn_l2_cuda: D={D} > 512")
    kernels.check(query, torch.float32, (Nq, D), "query")
    kernels.check(train, torch.float32, (Nt, D), "train")
    qn, tn = _norms(query, train, tvalid)
    d2 = torch.empty((Nq,), dtype=torch.float32, device=query.device)
    idx = torch.empty((Nq,), dtype=torch.int32, device=query.device)
    if Nq == 0:
        return d2, idx
    kernels.launch(
        "lgr_nn_l2", query.data_ptr(), train.data_ptr(), qn.data_ptr(),
        tn.data_ptr(), Nq, Nt, D, d2.data_ptr(), idx.data_ptr(),
        torch.cuda.current_stream(query.device).cuda_stream,
    )
    nn_l2_cuda.launches += 1
    return d2, idx


nn_l2_cuda.launches = 0


def nn_l2(query, train, qvalid, tvalid, tile: int = 4096):
    """Exact 1-NN of each query row against the train rows
    (topk_l2.nn_l2_pallas).  Returns (idx i64[Nq], dist f32[Nq] euclidean,
    mask bool[Nq]); the kernel on CUDA tensors, the plain version on CPU."""
    if query.is_cuda:
        d2, idx = nn_l2_cuda(query, train, tvalid)
    else:
        d2, idx = nn_l2_plain(query, train, tvalid, tile)
    idx = idx.long()
    mask = qvalid & (d2 < BIG / 2) & (idx < train.shape[0])
    dist = torch.where(mask, d2, BIG).clamp_min(0.0).sqrt()
    return torch.where(mask, idx, 0), dist, mask

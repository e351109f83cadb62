"""Exact 1-NN in descriptor space (lidar_global_registration_tpu/ops/pallas/topk_l2.py),
and the exact k-NN of xyz rows (K8).

d2 = |q|^2 + |t|^2 - 2 q.t; the running argmin keeps the lowest index among
equal minima, and an invalid train row carries |t|^2 = BIG so it never
wins.  The kernel (csrc/nn_l2.cu) keeps the distance tile on chip and reads
dimension-major, zero-padded copies that its wrapper makes; the plain
version materialises the distances one query chunk at a time.  Any width D
runs, in chunks of 16 dimensions (the JAX package sends D > 512 to its XLA
matcher, matchers.py:82-85, for want of VMEM).

The bf16 form (matchers.match_bf(bf16=True), matchers.py:93-107): the
norms come from the float32 rows and the dot products from the rows
rounded to bfloat16.  Its wrapper rounds the kernel's padded copies to
bfloat16 and back; a product of two bfloat16 values is exact in float32, so
the kernel's arithmetic stays IEEE float32 and computes the JAX function up
to the order of the sums.  No bfloat16 matmul is called: on CUDA its output
would be rounded to bfloat16.

K8 (csrc/knn_xyz.cu, `knn_xyz_cuda`) is the exact k-NN of xyz rows that
matchers.match_bf sends to the card (`takes_knn_xyz`): the cluster gate's
same-set keypoint k-NN.  It keeps matchers._topk_l2's contract, its plain
version: the k train rows least by (d2, index) per query, the same
float32 Gram-trick d2, invalid rows and the query's own row left out.
"""
from __future__ import annotations

import ctypes

import torch

from lidar_global_registration_tpu_torch import kernels
from lidar_global_registration_tpu_torch.utils import profiling

BIG = 3.0e38


def _norms(query, train, tvalid):
    qn = (query * query).sum(1)
    tn = torch.where(tvalid, (train * train).sum(1), BIG)
    return qn.contiguous(), tn.contiguous()


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest even), as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def nn_l2_plain(query, train, tvalid, tile: int = 4096, bf16: bool = False):
    """Plain version: (best d2 f32[Nq], best index i32[Nq]) over chunks of
    `tile` queries (the first index of the minimum, BIG / 0 when every train
    row is invalid).  bf16: the dot products of the bfloat16-rounded rows
    (a float32 product), the norms of the float32 rows."""
    qn, tn = _norms(query, train, tvalid)
    if bf16:
        query, train = bf16_round(query), bf16_round(train)
    d2_best = torch.empty((query.shape[0],), dtype=torch.float32, device=query.device)
    i_best = torch.empty((query.shape[0],), dtype=torch.int32, device=query.device)
    for s in range(0, query.shape[0], tile):
        q = query[s:s + tile]
        d2 = qn[s:s + tile, None] + tn[None, :] - 2.0 * (q @ train.T)
        v, i = d2.min(1)
        d2_best[s:s + tile] = v
        i_best[s:s + tile] = torch.where(v < BIG, i, 0).to(torch.int32)
    return d2_best, i_best


TILE = 128  # queries and train rows per block tile of csrc/nn_l2.cu
CHUNK = 16  # dimensions per chunk of csrc/nn_l2.cu
MAX_SPLITS = 16  # train ranges of a split at most


def _dim_major(x, n_pad: int, d_pad: int):
    """x f32[N, D] -> its zero-padded transpose f32[d_pad, n_pad]."""
    out = x.new_zeros((d_pad, n_pad))
    out[:x.shape[1], :x.shape[0]] = x.T
    return out


def _padded(v, n_pad: int, fill: float):
    out = torch.full((n_pad,), fill, dtype=torch.float32, device=v.device)
    out[:v.shape[0]] = v
    return out


def split_plan(nq: int, nt: int, slots: int) -> tuple[int, int]:
    """(ranges S, train tiles per range) of the K7 grid: ceil(nq / 128)
    query tiles times S train ranges, `slots` blocks resident on the card at
    once.  S minimises the waves a range's work takes, ceil(blocks * S /
    slots) / S; a larger S must save more than 5 %, so a grid that already
    fills the card some twice or more stays whole."""
    q_tiles = -(-max(nq, 1) // TILE)
    t_tiles = max(-(-nt // TILE), 1)
    best, best_cost = 1, float("inf")
    for s in range(1, min(MAX_SPLITS, t_tiles) + 1):
        cost = -(-q_tiles * s // slots) / s
        if cost < 0.95 * best_cost:
            best, best_cost = s, cost
    per = -(-t_tiles // best)
    return -(-t_tiles // per), per


_RESIDENT: dict = {}


def _resident_blocks(device, d: int) -> int:
    """SMs x resident blocks per SM of the K7 kernel of dimension d on
    `device` (asked once per device and kernel)."""
    key = (device, d == 33)
    if key not in _RESIDENT:
        per_sm = ctypes.c_int(0)
        kernels.launch("lgr_nn_l2_blocks_per_sm", d, ctypes.addressof(per_sm))
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _RESIDENT[key] = sms * max(per_sm.value, 1)
    return _RESIDENT[key]


def _launch_nn(query, train, tvalid, bf16: bool):
    """One K7 launch (and its merge) on the padded copies; returns (d2, idx)."""
    Nq, D = query.shape
    Nt = train.shape[0]
    kernels.check(query, torch.float32, (Nq, D), "query")
    kernels.check(train, torch.float32, (Nt, D), "train")
    qn, tn = _norms(query, train, tvalid)
    d2 = torch.empty((Nq,), dtype=torch.float32, device=query.device)
    idx = torch.empty((Nq,), dtype=torch.int32, device=query.device)
    if Nq == 0:
        return d2, idx
    nq_pad = -(-Nq // TILE) * TILE
    nt_pad = max(-(-Nt // TILE), 1) * TILE
    d_pad = max(-(-D // CHUNK), 1) * CHUNK
    splits, per = split_plan(Nq, Nt, _resident_blocks(query.device, D))
    part_d2 = part_i = d2
    if splits > 1:
        part_d2 = torch.empty((splits, Nq), dtype=torch.float32, device=query.device)
        part_i = torch.empty((splits, Nq), dtype=torch.int32, device=query.device)
    # held in names until the launch: a temporary freed at once would hand
    # its memory to the next allocation before the kernel reads it
    qt, tt = _dim_major(query, nq_pad, d_pad), _dim_major(train, nt_pad, d_pad)
    if bf16:
        qt, tt = bf16_round(qt), bf16_round(tt)
    qn_p, tn_p = _padded(qn, nq_pad, 0.0), _padded(tn, nt_pad, BIG)
    kernels.launch(
        "lgr_nn_l2", qt.data_ptr(), tt.data_ptr(), qn_p.data_ptr(), tn_p.data_ptr(), Nq,
        nq_pad, nt_pad, D, per, splits, part_d2.data_ptr(), part_i.data_ptr(), d2.data_ptr(),
        idx.data_ptr(), torch.cuda.current_stream(query.device).cuda_stream,
    )
    return d2, idx


def nn_l2_cuda(query, train, tvalid):
    """K7 · csrc/nn_l2.cu: same contract as nn_l2_plain, any D."""
    out = _launch_nn(query, train, tvalid, False)
    if query.shape[0]:
        nn_l2_cuda.launches += 1
    return out


nn_l2_cuda.launches = 0


def nn_l2_bf16_cuda(query, train, tvalid):
    """K7 · csrc/nn_l2.cu on bfloat16-rounded copies: same contract as
    nn_l2_plain(..., bf16=True)."""
    out = _launch_nn(query, train, tvalid, True)
    if query.shape[0]:
        nn_l2_bf16_cuda.launches += 1
    return out


nn_l2_bf16_cuda.launches = 0


def nn_l2(query, train, qvalid, tvalid, tile: int = 4096, bf16: bool = False):
    """Exact 1-NN of each query row against the train rows
    (topk_l2.nn_l2_pallas; with bf16, the bf16 form of matchers.match_bf).
    Returns (idx i64[Nq], dist f32[Nq] euclidean, mask bool[Nq]); the kernel
    on CUDA tensors, the plain version on CPU."""
    if query.is_cuda:
        d2, idx = (nn_l2_bf16_cuda if bf16 else nn_l2_cuda)(query, train, tvalid)
    else:
        d2, idx = nn_l2_plain(query, train, tvalid, tile, bf16)
    idx = idx.long()
    mask = qvalid & (d2 < BIG / 2) & (idx < train.shape[0])
    dist = torch.where(mask, d2, BIG).clamp_min(0.0).sqrt()
    return torch.where(mask, idx, 0), dist, mask


KNN_MAX_K = 64  # the longest list K8 keeps for a query
KNN_QUERIES = 32  # queries per K8 block


def takes_knn_xyz(query, k: int, bf16: bool = False) -> bool:
    """Whether matchers.match_bf sends a k-NN to K8, read from the call's
    input alone: rows on a CUDA device, three wide (points, not
    descriptors), 1 <= k <= KNN_MAX_K, and not the bf16 matcher."""
    return bool(query.is_cuda) and query.shape[1] == 3 and 1 <= k <= KNN_MAX_K and not bf16


def knn_xyz_cuda(query, train, qvalid, tvalid, k: int, exclude_ids=None, id_offset: int = 0,
                 exclude_diag: bool = False):
    """K8 · csrc/knn_xyz.cu: (best d2 f32[Nq, k] ascending, best index
    i64[Nq, k]) of xyz rows, the k train rows least by (d2, index) for
    each valid query; invalid train rows and the query's own row never
    win (exclude_ids i64[Nq] with id_offset: the train row whose
    id_offset + local id is the query's id; exclude_diag: exclude_ids =
    the query rows); slots beyond the rows found, and invalid queries,
    hold (BIG, 0).  matchers._topk_l2's contract, as matchers.match_bf
    reads it.  Launches: the keys, a sort of each set (one when train is
    query and tvalid is qvalid), the pack and the scan; no host
    synchronisation."""
    if not 1 <= k <= KNN_MAX_K:
        raise ValueError(f"K8 keeps 1 to {KNN_MAX_K} neighbours, got k = {k}")
    dev = query.device
    Nq, Nt = query.shape[0], train.shape[0]
    same = train is query and tvalid is qvalid
    query, train = query.contiguous(), train.contiguous()
    qvalid, tvalid = qvalid.contiguous(), tvalid.contiguous()
    kernels.check(query, torch.float32, (Nq, 3), "query")
    kernels.check(train, torch.float32, (Nt, 3), "train")
    kernels.check(qvalid, torch.bool, (Nq,), "qvalid")
    kernels.check(tvalid, torch.bool, (Nt,), "tvalid")
    if Nq == 0 or Nt == 0:
        return (torch.full((Nq, k), BIG, dtype=torch.float32, device=dev),
                torch.zeros((Nq, k), dtype=torch.int64, device=dev))
    knn_xyz_cuda.launches += 1
    profiling.count("match.knn_xyz")
    excl = None
    if exclude_ids is not None and not exclude_diag:
        excl = exclude_ids.to(device=dev, dtype=torch.int64).contiguous()
        kernels.check(excl, torch.int64, (Nq,), "exclude_ids")
    stream = torch.cuda.current_stream(dev).cuda_stream
    part = torch.empty((64, 6), dtype=torch.float32, device=dev)  # the keys' partial boxes
    qkey = torch.empty((Nq,), dtype=torch.int16, device=dev)
    tkey = qkey if same else torch.empty((Nt,), dtype=torch.int16, device=dev)
    kernels.launch("lgr_knn_xyz_keys", query.data_ptr(), qvalid.data_ptr(), Nq,
                   None if same else train.data_ptr(), tvalid.data_ptr(), Nt, part.data_ptr(),
                   qkey.data_ptr(), tkey.data_ptr(), stream)
    qkey_s, perm_q = torch.sort(qkey)
    tkey_s, perm_t = (qkey_s, perm_q) if same else torch.sort(tkey)
    nt_pad = max(-(-Nt // TILE), 1) * TILE
    t4 = torch.empty((nt_pad, 4), dtype=torch.float32, device=dev)
    tid = torch.empty((nt_pad,), dtype=torch.int32, device=dev)
    box = torch.empty((nt_pad // 64, 4), dtype=torch.float32, device=dev)
    home = torch.empty((-(-Nq // KNN_QUERIES),), dtype=torch.int32, device=dev)
    nt_valid = torch.empty((1,), dtype=torch.int32, device=dev)
    best_d = torch.empty((Nq, k), dtype=torch.float32, device=dev)
    best_i = torch.empty((Nq, k), dtype=torch.int64, device=dev)
    kernels.launch(
        "lgr_knn_xyz", query.data_ptr(), perm_q.data_ptr(), qkey_s.data_ptr(), Nq,
        train.data_ptr(), tvalid.data_ptr(), perm_t.data_ptr(), tkey_s.data_ptr(), Nt, nt_pad,
        None if excl is None else excl.data_ptr(), int(id_offset), int(exclude_diag), k,
        t4.data_ptr(), tid.data_ptr(), box.data_ptr(), home.data_ptr(), nt_valid.data_ptr(),
        best_d.data_ptr(), best_i.data_ptr(), stream)
    return best_d, best_i


knn_xyz_cuda.launches = 0

"""The matcher functions of lidar_global_registration_tpu/models/pyramid.py
that the staged path reads: the cluster-consensus distance of the cluster
matcher (`_cluster_distances`) and the cross-level consensus vote of the
staged multi-scale pyramid (`_consensus_vote`).

The host pyramid itself (initialize_side, match_multiscale, the matching
strategies) is not ported (ROADMAP.md, Queue 1, 'Host-path ops'); the
staged pyramid is models/flagship._pyramid_route.
"""
from __future__ import annotations

import torch


def _cluster_distances(match_of_q, has_q, nbq_idx, nbq_mask, nbt_idx, nbt_mask):
    """1 - (consistent pairs / total pairs) per (i, match(i)) pair
    (ClusterMatcher::calculateCorrespondenceDistance, matching.h:524-550).

    match_of_q i64[Mq] best train row per query row, has_q bool[Mq];
    nbq_idx/mask [Mq, Kc] kNN of query keypoints among query keypoints,
    nbt_idx/mask [Mt, Kc] the same on the train side.  Returns f32[Mq]."""
    j = match_of_q
    jn = nbt_idx[j]  # neighbours of the matched train keypoint
    jn_mask = nbt_mask[j]
    nb_match = match_of_q[nbq_idx]  # matches of i's neighbours
    nb_has = has_q[nbq_idx] & nbq_mask
    member = ((nb_match[:, :, None] == jn[:, None, :]) & jn_mask[:, None, :]).any(2)
    cc = (nb_has & member).sum(1).to(torch.float32)
    cp = nb_has.sum(1).to(torch.float32)
    return torch.where(cp > 0, 1.0 - cc / cp.clamp_min(1.0), 0.0)


def _first_argmax(key: torch.Tensor) -> torch.Tensor:
    """Column of each row's maximum, the lowest among equal maxima (what
    jnp.argmax promises; torch.argmax promises no order among equals)."""
    L = key.shape[1]
    cols = torch.arange(L, device=key.device)[None, :]
    return torch.where(key == key.amax(1, keepdim=True), cols, L).amin(1).clamp_max(L - 1)


def _consensus_vote(cand_idx, cand_dist, cand_mask, train_xyz, iss_radius: float):
    """Winner per query among its cross-level candidates by spatial
    consensus (pyramid._consensus_vote, matching.h:264-354).

    cand_* : [M, L] (L = levels x randomness), cand_idx rows of train_xyz.
    Score of candidate m1 = sum over m2 >= m1 of iss_r / max(d3(m1, m2),
    iss_r) for the pairs within 32 iss_r (the reference's asymmetric
    m2 >= m1 loop, matching.h:330-340); the winner has the highest
    key = score - 1e-6 x descriptor distance, the first of equal keys.  The
    runner-up is the best key among candidates with another train index.

    d3 is a sum of squared differences (no Gram product: nothing for TF32
    or cancellation to touch) and each score is summed over m2 in
    ascending order, so the card and the CPU give the same winners.
    Returns (b_idx i64[M], b_dist f32[M], b_mask bool[M], s_dist f32[M],
    s_mask bool[M])."""
    L = cand_idx.shape[1]
    r = torch.tensor(iss_radius, dtype=torch.float32, device=train_xyz.device)
    pos = train_xyz[cand_idx]  # [M, L, 3]
    col = torch.arange(L, device=cand_idx.device)[None, :]
    counts = torch.zeros(cand_idx.shape, dtype=torch.float32, device=train_xyz.device)
    for m2 in range(L):
        d = pos - pos[:, m2:m2 + 1, :]
        d3 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
              + d[..., 2] * d[..., 2]).clamp_min(0.0).sqrt()  # [M, L]: m1 against m2
        pair_ok = cand_mask & cand_mask[:, m2:m2 + 1] & (d3 < 32.0 * r) & (col <= m2)
        counts = counts + torch.where(pair_ok, r / torch.maximum(d3, r), 0.0)
    counts = torch.where(cand_mask, counts, -torch.inf)
    key = counts - 1e-6 * cand_dist
    best = _first_argmax(key)[:, None]
    b_idx = cand_idx.gather(1, best)[:, 0]
    b_dist = cand_dist.gather(1, best)[:, 0]
    b_mask = cand_mask.gather(1, best)[:, 0]
    key2 = torch.where(cand_idx == b_idx[:, None], -torch.inf, key)
    second = _first_argmax(key2)[:, None]
    s_dist = cand_dist.gather(1, second)[:, 0]
    s_mask = cand_mask.gather(1, second)[:, 0] & (cand_idx.gather(1, second)[:, 0] != b_idx)
    return b_idx, b_dist, b_mask, s_dist, s_mask

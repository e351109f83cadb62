"""The cluster-consensus distance of the staged matcher
(lidar_global_registration_tpu/models/pyramid.py `_cluster_distances`).

The multi-scale pyramid itself is not ported (ROADMAP.md, 'staged
pyramid'); the staged cluster matcher reads this one function.
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

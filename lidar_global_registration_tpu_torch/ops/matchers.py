"""Descriptor-space matching (lidar_global_registration_tpu/ops/matchers.py).

Only the exact k=1 matcher of the keypoint-any path is ported; it runs the
1-NN kernel of ops/nn_l2.py (matchers.py:84-91 routes the JAX package's k=1
to its Pallas counterpart the same way).
"""
from __future__ import annotations

import torch

from lidar_global_registration_tpu_torch.ops.nn_l2 import nn_l2


def match_bf(query: torch.Tensor, train: torch.Tensor, qvalid: torch.Tensor,
             tvalid: torch.Tensor, k: int = 1, tile: int = 4096, bf16: bool = False):
    """Exact 1-NN in descriptor space (L2).  Returns (idx i64[Nq, 1],
    dist f32[Nq, 1] euclidean, mask bool[Nq, 1])."""
    if k != 1 or bf16:
        raise NotImplementedError(
            f"match_bf(k={k}, bf16={bf16}): only exact k=1 is ported; the exact "
            "top-k kernel is ROADMAP Queue 2 item 'exact top-40 kNN'"
        )
    idx, dist, mask = nn_l2(query, train, qvalid, tvalid, tile=tile)
    return idx[:, None], dist[:, None], mask[:, None]

"""Batched registration of many scan pairs on one device
(lidar_global_registration_tpu/parallel/batch.make_register_batch).

The JAX package maps its flagship step over the pairs of a dp shard and
splits each pair's rows and its matcher's train side over tp peers, a
re-tiling of the same step (tests/test_tp_feature_sharding.py holds it to
the single-device step).  On one GPU dp is the loop over the pairs and
tp = 1, so each pair is models/flagship.register_pair_step.
"""
from __future__ import annotations

import torch

from lidar_global_registration_tpu_torch.models.flagship import (
    FlagshipConfig,
    register_pair_step,
)


def make_register_batch(cfg: FlagshipConfig = FlagshipConfig()):
    """The batch-registration step for `cfg`:

        step(src [B, N, 3], src_valid [B, N], tgt [B, N, 3], tgt_valid [B, N],
             seeds, scalars [B, 7], vps [B, 2, 3]) -> (T [B, 4, 4], inliers [B],
             n_correspondences [B])

    scalars hold each pair's (normal_cell, density_cell_src,
    density_cell_tgt, iss_radius_src, iss_radius_tgt, feature_radius,
    distance_thr); vps the scanner viewpoints (src, tgt), zeros for the
    origin; seeds B ints or torch.Generators on the tensors' device (the JAX
    package's [B, 2] PRNG keys).  Runs on the tensors' device."""

    def step(src, src_valid, tgt, tgt_valid, seeds, scalars, vps):
        if not len(seeds) == src.shape[0] == tgt.shape[0] == scalars.shape[0] == vps.shape[0]:
            raise ValueError("one seed, scalar row and viewpoint pair per pair of the batch")
        outs = []
        for b, seed in enumerate(seeds):
            gen = seed if isinstance(seed, torch.Generator) else torch.Generator(
                device=src.device).manual_seed(int(seed))
            outs.append(register_pair_step(
                src[b], src_valid[b], tgt[b], tgt_valid[b], gen,
                *scalars[b].tolist(), vp_src=vps[b, 0], vp_tgt=vps[b, 1],
                cfg=cfg))
        return tuple(torch.stack([o[k] for o in outs])
                     for k in ("transformation", "inliers", "n_correspondences"))

    return step

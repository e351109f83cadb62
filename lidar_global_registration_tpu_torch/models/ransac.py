"""RANSAC hypotheses (lidar_global_registration_tpu/models/ransac.py:125-153).

The sample draw and the hypothesis body are split, so a test can feed the
same sample rows to this package and to the JAX one (their generators give
different numbers from one seed).
"""
from __future__ import annotations

import torch

from lidar_global_registration_tpu_torch.ops.transform import kabsch


def hypotheses_from_samples(p: torch.Tensor, q: torch.Tensor, rows: torch.Tensor,
                            edge_thr: float):
    """Hypotheses from sample rows [B, S] into p, q [M, 3]: reject repeated
    rows, prereject by polygon edge-length similarity
    (CorrespondenceRejectorPoly, sac_prerejective_omp.cpp:105-108, 214-217)
    and solve Kabsch per sample.  Returns (R [B,3,3], t [B,3], ok [B])."""
    B, S = rows.shape
    ok = torch.ones((B,), dtype=torch.bool, device=p.device)
    for a in range(S):
        for b in range(a + 1, S):
            ok = ok & (rows[:, a] != rows[:, b])
    p3, q3 = p[rows], q[rows]
    for a in range(S):
        b = (a + 1) % S
        ds = ((p3[:, a] - p3[:, b]) ** 2).sum(-1)
        dt = ((q3[:, a] - q3[:, b]) ** 2).sum(-1)
        ok = ok & (torch.minimum(ds, dt) >= (edge_thr**2) * torch.maximum(ds, dt))
        ok = ok & (torch.maximum(ds, dt) > 0)
    R, t = kabsch(p3, q3)
    return R, t, ok


def draw_hypotheses(p: torch.Tensor, q: torch.Tensor, generator: torch.Generator,
                    nvalid: int, B: int, S: int, edge_thr: float,
                    order: torch.Tensor | None = None):
    """Draw B sample S-tuples from the valid prefix (`order` maps sampled
    slots to rows; None when p, q are already valid-prefix compacted) and
    build their hypotheses."""
    samp = torch.randint(0, nvalid, (B, S), generator=generator, device=p.device)
    rows = samp if order is None else order[samp]
    return hypotheses_from_samples(p, q, rows, edge_thr)

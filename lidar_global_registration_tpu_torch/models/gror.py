"""GROR: graph-reliability based optimal registration
(lidar_global_registration_tpu/models/gror.py; the reference's second
solver, include/gror/ia_gror.hpp, called from alignment.cpp:21-35 with
K_optimal = 800 and resolution = distance_thr).  Stages:

  1. node reliability: the degree of each correspondence in the
     length-consistency graph |d_src - d_tgt| < 2 resolution; the top K stay
     (ia_gror.hpp:126-194);
  2. edge enumeration: per surviving node one consistent partner (:82-124);
  3. for the most promising edges: two-point alignment (:418-441), a bound
     in the relaxed constraint space (RCFS, :473-501), then the exact 1-DoF
     rotation search by interval stabbing over azimuth arcs (TCFS, :521-747);
  4. refinement: the inliers within 2 resolution of the best transform ->
     Umeyama.

Plain functions on tensors, on the device of `p`; function for function the
JAX module, names kept.  `align_gror` is the host path's solver around
`gror_solve`; `gror_preparation` is GROR's own preprocessing (no caller on
the command line's path): voxel downsample, kNN normals, ISS keypoints
(K2-K4), FPFH (K5's full pass) and mutual 1-NN (K7).  The solver draws
nothing, so on one correspondence
set both packages give the same result.  The orchestration (the stable
order of the nodes and of the edges, the early exit once the best TCFS
count reaches the largest RCFS bound left) runs on the host with one read
per round, as in the JAX package.  The 3 x 3 products are written as
elementwise sums: full float32 whatever the matmul precision settings are.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from lidar_global_registration_tpu_torch.ops.transform import to_matrix4, umeyama
from lidar_global_registration_tpu_torch.types import (
    AlignmentParameters,
    AlignmentResult,
    Cloud,
    Correspondences,
)

K_OPTIMAL = 800  # alignment.cpp:31
TWO_PI = 2.0 * math.pi
MIN_EDGE_ADJACENCY = 10  # ia_gror.hpp:205-207: skip edges with < 10 pairs


def _mm3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched A @ B of [..., 3, 3] matrices, summed in float32."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def _mv3(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched A @ v: [..., 3, 3] x [..., 3]."""
    return (A * v[..., None, :]).sum(-1)


def _mtv3(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched A^T @ v."""
    return (A * v[..., :, None]).sum(-2)


def _norm3(x: torch.Tensor) -> torch.Tensor:
    return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]).sqrt()


def _pair_lengths(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a_i - b_j| for a [m, 3], b [n, 3] (differences, not the Gram trick:
    the consistency test compares lengths at scene scale to centimetres)."""
    return _norm3(a[:, None, :] - b[None, :, :])


def _degrees_only(p, q, valid, resolution: float, chunk: int = 1024) -> torch.Tensor:
    """Degrees of the length-consistency graph without the [n, n] adjacency
    (ia_gror.hpp:126-194 computes only the counts too): row chunks, so peak
    memory is [chunk, n] however large the correspondence set.  i64[n]."""
    n = p.shape[0]
    col = torch.arange(n, device=p.device)
    out = []
    for a in range(0, n, chunk):
        r = col[a:a + chunk]
        ok = (((_pair_lengths(p[r], p) - _pair_lengths(q[r], q)).abs() < 2.0 * resolution)
              & valid[r][:, None] & valid[None, :] & (r[:, None] != col[None, :]))
        out.append(ok.sum(1))
    return torch.cat(out) if out else torch.zeros((0,), dtype=torch.int64, device=p.device)


def _node_degrees(p, q, valid, resolution: float):
    """(degree i64[n], adjacency bool[n, n]) of the length-consistency
    graph (ia_gror.hpp:126-194)."""
    n = p.shape[0]
    ok = (((_pair_lengths(p, p) - _pair_lengths(q, q)).abs() < 2.0 * resolution)
          & valid[:, None] & valid[None, :]
          & ~torch.eye(n, dtype=torch.bool, device=p.device))
    return ok.sum(1), ok


def _skew(u: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(u[..., 0])
    return torch.stack([
        torch.stack([z, -u[..., 2], u[..., 1]], -1),
        torch.stack([u[..., 2], z, -u[..., 0]], -1),
        torch.stack([-u[..., 1], u[..., 0], z], -1),
    ], dim=-2)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / _norm3(x)[..., None].clamp_min(1e-30)


def _two_point_align(p1, q1, p2, q2):
    """twoPairPointsAlign (ia_gror.hpp:418-441), batched over edges [E, ...]:
    the source edge direction onto the target's (Rodrigues through the skew
    matrix), translation = mean of the two endpoint residuals.  Returns
    (R [E, 3, 3], t [E, 3], axis [E, 3], origin [E, 3])."""
    vs = _unit(p1 - p2)
    vt = _unit(q1 - q2)
    v = torch.linalg.cross(vs, vt)
    c = (vs * vt).sum(-1)
    V = _skew(v)
    eye = torch.eye(3, dtype=p1.dtype, device=p1.device).expand_as(V)
    R = eye + V + _mm3(V, V) / (1.0 + c).clamp_min(1e-6)[..., None, None]
    # antipodal edge directions (c ~ -1): rotate pi about an axis
    # perpendicular to vs
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=p1.dtype, device=p1.device).expand_as(vs)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=p1.dtype, device=p1.device).expand_as(vs)
    perp = torch.linalg.cross(vs, ex)
    perp = torch.where(_norm3(perp)[..., None] > 1e-3, perp, torch.linalg.cross(vs, ey))
    perp = _unit(perp)
    R_pi = 2.0 * perp[..., :, None] * perp[..., None, :] - eye
    R = torch.where((c < -1.0 + 1e-6)[..., None, None], R_pi, R)
    t = 0.5 * ((q1 - _mv3(R, p1)) + (q2 - _mv3(R, p2)))
    return R, t, vt, q1


def _rcfs_counts(R, t, axis, origin, p, q, valid, resolution: float) -> torch.Tensor:
    """Relaxed-space reliability per edge (calEdgeReliabilityInRCFS,
    ia_gror.hpp:473-501): consistency of the distance to the edge's origin
    and of the projection on its axis.  R, t, axis, origin: [E, ...]; p, q:
    [M, 3].  i64[E]."""
    diff_t = q[None, :, :] - origin[:, None, :]  # [E, M, 3]
    first_s = _mtv3(R, origin - t)  # the edge's first source point, R^T (origin - t)
    axis_s = _mtv3(R, axis)
    diff_s = p[None, :, :] - first_s[:, None, :]
    ok = (((_norm3(diff_t) - _norm3(diff_s)).abs() < 2.0 * resolution)
          & (((diff_t * axis[:, None, :]).sum(-1)
              - (diff_s * axis_s[:, None, :]).sum(-1)).abs() < 2.0 * resolution)
          & valid[None, :])
    return ok.sum(1)


def _tcfs_stab(R, t, axis, origin, p, q, valid, resolution: float):
    """Tight-space reliability: batched interval stabbing over azimuth arcs
    (calEdgeReliabilityInTCFS + intervalStab, ia_gror.hpp:521-747).
    Returns (best_angle f32[E], best_count i32[E])."""
    E, M = R.shape[0], p.shape[0]
    dev = p.device
    # float32 throughout, as the JAX package traces `resolution`: (2 res)^2
    # is the float32 product
    thr = np.float32(2.0) * np.float32(resolution)
    thr2 = float(thr * thr)
    # rotate both point sets into the frame whose z is the rotation axis
    z = torch.tensor([0.0, 0.0, 1.0], dtype=p.dtype, device=dev).expand_as(axis)
    c = (axis * z).sum(-1)
    V = _skew(torch.linalg.cross(axis, z))
    eye = torch.eye(3, dtype=p.dtype, device=dev).expand_as(V)
    W = eye + V + _mm3(V, V) / (1.0 + c).clamp_min(1e-6)[..., None, None]
    flipz = torch.diag(torch.tensor([1.0, -1.0, -1.0], dtype=p.dtype, device=dev)).expand_as(V)
    W = torch.where((c < -1.0 + 1e-6)[..., None, None], flipz, W)
    # local target coordinates W (q - origin); local source W (R p + t - origin)
    Wb = W[:, None, :, :]
    tq = _mv3(Wb, q[None, :, :] - origin[:, None, :])
    sp = _mv3(R[:, None, :, :], p[None, :, :]) + t[:, None, :] - origin[:, None, :]
    sp = _mv3(Wb, sp)

    def cyl(x):
        length = (x[..., 0] ** 2 + x[..., 1] ** 2).clamp_min(0.0).sqrt()
        return length, x[..., 2], torch.atan2(x[..., 1], x[..., 0])

    m_len, m_z, m_azi = cyl(sp)
    b_len, b_z, b_azi = cyl(tq)
    dz = b_z - m_z
    d = b_len - m_len
    th_mz = thr2 - dz * dz
    feasible = (d * d <= th_mz) & valid[None, :]
    rth = th_mz.clamp_min(0.0).sqrt()
    # circle intersection half-angle (circleIntersection, ia_gror.hpp:521-552)
    Rr = m_len.clamp_min(1e-12)
    dd = b_len.clamp_min(0.0)
    rat = (dd * dd - rth * rth + Rr * Rr) / (2.0 * dd.clamp_min(1e-12)) / Rr
    half = torch.where((dd <= 1e-7) | (rat <= -1.0), math.pi, torch.acos(rat.clamp(-1.0, 1.0)))
    full = (m_len <= 1e-7) | ((half - math.pi).abs() <= 1e-7)
    center = torch.remainder(b_azi - m_azi + TWO_PI, TWO_PI)
    beg = torch.remainder(center - half + TWO_PI, TWO_PI)
    end = torch.remainder(center + half + TWO_PI, TWO_PI)
    beg = torch.where(full, 0.0, beg)
    end = torch.where(full, TWO_PI, end)
    wrap = end < beg  # wrapped arcs split into [beg, 2 pi] + [0, end]
    big = 1e9
    # events: 2 intervals a correspondence -> 4 endpoints
    s1 = torch.where(feasible, beg, big)
    e1 = torch.where(feasible, torch.where(wrap, TWO_PI, end), big)
    s2 = torch.where(feasible & wrap, 0.0, big)
    e2 = torch.where(feasible & wrap, end, big)
    locs = torch.cat([s1, s2, e1, e2], 1)  # [E, 4M]: starts, then ends
    is_start = torch.arange(4 * M, device=dev) < 2 * M
    deltas = torch.where(is_start, 1.0, -1.0).to(p.dtype).expand(E, 4 * M)
    # Sort by (location, ends first).  The tie-break may reorder only exact
    # ties: every location is a non-negative float32, whose bit pattern is
    # monotone as an integer, so (bits << 1) | is_start is an exact
    # lexicographic key (int64 here: PyTorch has no uint32 arithmetic).
    # Ends sort before starts at exact ties because the angle returned is
    # the open-gap midpoint below: an interval that ends exactly where the
    # best start lies is not active there.
    keys = (locs.contiguous().view(torch.int32).to(torch.int64) << 1) | is_start.to(torch.int64)
    order = torch.argsort(keys, dim=1, stable=True)
    sl = locs.gather(1, order)
    sd = deltas.gather(1, order)
    sd = torch.where(sl >= big, 0.0, sd)
    run = sd.cumsum(1)
    run_at_start = torch.where((sd > 0) & (sl < big), run, -torch.inf)
    best_count = run_at_start.amax(1)
    best_idx = torch.argmax(run_at_start, dim=1)  # first maximal index, as jnp.argmax
    # the stab angle is the midpoint between the best start event and the
    # next strictly greater event location: strictly inside every stabbed
    # interval (the JAX package's documented deviation from the reference's
    # one_to_one variant, which keeps the start location itself)
    li = sl.gather(1, best_idx[:, None])
    nxt = torch.where((sl > li) & (sl < big), sl, torch.inf).amin(1)
    best_angle = torch.where(torch.isfinite(nxt), 0.5 * (li[:, 0] + nxt), li[:, 0])
    best_count = torch.where(torch.isfinite(best_count), best_count, 0.0)
    return best_angle, best_count.to(torch.int32)


def _axis_rotation(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation about `axis` by `angle` (batched)."""
    a = _unit(axis)
    c = torch.cos(angle)[..., None, None]
    s = torch.sin(angle)[..., None, None]
    K = _skew(a)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device).expand_as(K)
    return c * eye + s * K + (1.0 - c) * (a[..., :, None] * a[..., None, :])


def _edge_search(p, q, valid, resolution: float, i1, i2, edge_batch: int, e_valid=None):
    """Exact optimal edge search over the candidate edges (i1, i2): two-point
    alignment and RCFS bounds for every edge at once, then TCFS interval
    stabbing in rounds of `edge_batch` edges by descending RCFS, with a host
    early exit once best_tcfs >= the largest RCFS left.  RCFS counts bound
    TCFS counts from above edge for edge (the relaxed space drops the azimuth
    constraint), so the exit keeps the exact optimum over the edge set, as the
    reference's full scan with its `der_in_rcfs <= best_count_` prune
    (ia_gror.hpp:230-236).  `e_valid` (host bool[E] or None) marks padding
    edges: they get RCFS -1, sort last and never win.  Returns (best_e,
    best_count, best_angle, rounds, R, t, axis, origin)."""
    R, t, axis, origin = _two_point_align(p[i1], q[i1], p[i2], q[i2])
    rc_np = _rcfs_counts(R, t, axis, origin, p, q, valid, resolution).cpu().numpy()
    if e_valid is not None:
        rc_np = np.where(np.asarray(e_valid), rc_np, -1)
    e_order = np.argsort(-rc_np, kind="stable")
    best_count, best_e, best_angle_v, rounds = 0, -1, 0.0, 0
    for s in range(0, len(e_order), edge_batch):
        chunk = e_order[s:s + edge_batch]
        if rc_np[chunk[0]] <= best_count:
            break  # RCFS >= TCFS: nothing left can beat the best
        sel = np.full((edge_batch,), chunk[0], np.int64)
        sel[:len(chunk)] = chunk
        sel_t = torch.from_numpy(sel).to(p.device)
        angles, counts = _tcfs_stab(R[sel_t], t[sel_t], axis[sel_t], origin[sel_t], p, q, valid,
                                    resolution)
        both = torch.stack([angles, counts.to(angles.dtype)]).cpu().numpy()  # the round's host read
        counts_np = both[1, :len(chunk)].astype(np.int64)
        counts_np = np.where(rc_np[chunk] < 0, -1, counts_np)
        rounds += 1
        ci = int(np.argmax(counts_np))
        if int(counts_np[ci]) > best_count:
            best_count = int(counts_np[ci])
            best_e = int(chunk[ci])
            best_angle_v = float(both[0, ci])
    return best_e, best_count, best_angle_v, rounds, R, t, axis, origin


def _inlier_mask(p, q, valid, T, resolution: float) -> torch.Tensor:
    moved = _mv3(T[:3, :3], p) + T[:3, 3]
    return (_norm3(q - moved) < 2.0 * resolution) & valid


def gror_solve(p_all, q_all, valid, resolution: float, k_optimal: int = K_OPTIMAL,
               edge_batch: int = 256) -> dict:
    """GROR over matched point pairs, the solver core (gror.gror_solve):
    the correspondence endpoints p_all / q_all [P, 3] with a validity mask,
    on their device.  The top-K node set has min(k_optimal, P) rows and the
    candidate edge list one row a node, nodes that qualify for no edge
    riding as masked padding, as in the JAX package.  Algorithm and gates
    are align_gror's (ia_gror.hpp:126-365).

    Returns the staged solver's result dict, the keys of
    flagship.ransac_solve: `transformation` a float32 [4, 4] tensor on the
    inputs' device, the rest host values (metric = the refined inlier count,
    iterations = the TCFS rounds)."""
    P = int(p_all.shape[0])
    dev = p_all.device
    valid = valid.to(torch.bool)
    n_corr = int(valid.sum())
    fail = {
        "transformation": torch.eye(4, dtype=torch.float32, device=dev),
        "metric": 0.0,
        "inliers": 0,
        "converged": False,
        "n_correspondences": n_corr,
        "iterations": 0,
    }
    if n_corr < 2:
        return fail

    # 1. node reliability: the top K nodes among those with >= 1 consistent
    # pair (chunked: only the degrees, never the [P, P] graph)
    deg = torch.where(valid, _degrees_only(p_all, q_all, valid, resolution), 0)
    k_pad = int(min(k_optimal, P))
    keep = torch.argsort(-deg, stable=True)[:k_pad]
    vk = deg[keep] > 0
    if int(vk.sum()) < 2:
        return fail
    p, q = p_all[keep], q_all[keep]

    # 2. edge enumeration among the survivors (ia_gror.hpp:82-124): one edge
    # per node i whose adjacency over j > i holds >= 10 nodes; the partner is
    # the consistent j > i of the highest degree, first by index among equals
    # (the reference takes the first by index, :209).  Edges shorter than the
    # 2 resolution consistency band on either side are left out: two source
    # keypoints may share one target point under one-sided matching, and a
    # zero-length edge has no direction.
    _deg2, adj = _node_degrees(p, q, vk, resolution)
    upper = torch.triu(adj, 1)
    floor = 2.0 * resolution
    sel_ok = upper & (_pair_lengths(p, p) > floor) & (_pair_lengths(q, q) > floor)
    e_valid = (upper.sum(1) >= MIN_EDGE_ADJACENCY) & sel_ok.any(1)
    partner_score = torch.where(sel_ok, adj.sum(1)[None, :], -1)
    i2 = torch.argmax(partner_score, dim=1)  # first maximal index, as np.argmax
    e_valid_np = e_valid.cpu().numpy()
    if not e_valid_np.any():
        return fail
    i1 = torch.arange(k_pad, device=dev)

    best_e, best_count, best_angle_v, rounds, R, t, axis, origin = _edge_search(
        p, q, vk, resolution, i1, i2, edge_batch, e_valid=e_valid_np)
    if best_e < 0:
        return fail

    # 3. compose: to the edge's origin, rotate about its axis, back
    rot = _axis_rotation(axis[best_e], torch.tensor(best_angle_v, dtype=torch.float32,
                                                    device=dev))
    Rf = _mm3(rot, R[best_e])
    tf = _mv3(rot, t[best_e] - origin[best_e]) + origin[best_e]
    T = to_matrix4(Rf, tf)

    # 4. refine: inliers < 2 resolution over all input correspondences ->
    # Umeyama (ia_gror.hpp:261-365), then the count under the refined pose
    inl = _inlier_mask(p_all, q_all, valid, T, resolution)
    n_inl = int(inl.sum())
    if n_inl >= 3:
        Ru, tu = umeyama(p_all[None], q_all[None], inl.to(torch.float32)[None])
        T = to_matrix4(Ru[0], tu[0])
        n_inl = int(_inlier_mask(p_all, q_all, valid, T, resolution).sum())
    # the refined inlier support must reach the edge qualification floor: a
    # lone degenerate edge cannot report success
    converged = bool(n_inl >= MIN_EDGE_ADJACENCY and best_count >= MIN_EDGE_ADJACENCY)
    return {
        "transformation": T.to(torch.float32),
        "metric": float(n_inl),
        "inliers": n_inl,
        "converged": converged,
        "n_correspondences": n_corr,
        "iterations": rounds,
    }


def align_gror(src: Cloud, tgt: Cloud, corrs: Correspondences, params: AlignmentParameters,
               k_optimal: int = K_OPTIMAL, edge_batch: int = 256) -> AlignmentResult:
    """GROR alignment of a correspondence set (gror.align_gror,
    ia_gror.hpp:199-258): gror_solve over the compacted correspondences'
    endpoints at resolution = distance_thr, on the clouds' device."""
    t0 = time.time()
    corrs = corrs.compact()
    if int(corrs.count()) < 2:
        return AlignmentResult(src=src, tgt=tgt, transformation=np.eye(4, dtype=np.float32),
                               correspondences=corrs, iterations=1, converged=False,
                               time_te=time.time() - t0)
    out = gror_solve(src.xyz[corrs.query], tgt.xyz[corrs.match], corrs.valid,
                     float(params.distance_thr), k_optimal=k_optimal, edge_batch=edge_batch)
    return AlignmentResult(src=src, tgt=tgt,
                           transformation=out["transformation"].cpu().numpy().astype(np.float32),
                           correspondences=corrs, iterations=max(int(out["iterations"]), 1),
                           converged=bool(out["converged"]), time_te=time.time() - t0,
                           metric=float(out["metric"]))


def gror_preparation(src: Cloud, tgt: Cloud, resolution: float):
    """GROR's own preprocessing (gror.gror_preparation; the reference's
    gror_pre.cpp grorPreparation) on the clouds' device: each cloud voxel
    downsampled at `resolution`, its kNN-30 normals, ISS keypoints at 2 x
    resolution (ops/iss: K2-K4), FPFH of the keypoints at 8 x resolution
    (ops/fpfh: K5's full pass), then the mutual 1-NN of the descriptors
    (K7) with threshold 2 x resolution.  Returns (src_down, tgt_down,
    correspondences between their rows, padded to round_up(n))."""
    from lidar_global_registration_tpu_torch.ops.downsample import voxel_downsample
    from lidar_global_registration_tpu_torch.ops.fpfh import fpfh
    from lidar_global_registration_tpu_torch.ops.iss import detect_keypoints
    from lidar_global_registration_tpu_torch.ops.matchers import match_bf
    from lidar_global_registration_tpu_torch.ops.normals import estimate_normals_knn
    from lidar_global_registration_tpu_torch.types import round_up

    def side(cloud: Cloud):
        down = estimate_normals_knn(voxel_downsample(cloud, resolution).compact(), k=30)
        kp = detect_keypoints(down, "iss", 2.0 * resolution)
        kv = torch.ones(kp.shape, dtype=torch.bool, device=kp.device)
        feat, fv = fpfh(down.xyz[kp], kv, down.xyz, down.normal, down.valid, 8.0 * resolution,
                        kp_normal=down.normal[kp])
        return down, kp, feat, fv

    src_d, kp_s, fs, vs = side(src)
    tgt_d, kp_t, ft, vt = side(tgt)
    dev = src_d.xyz.device
    i_st, d_st, m_st = match_bf(fs, ft, vs, vt, k=1)
    i_ts, _d, m_ts = match_bf(ft, fs, vt, vs, k=1)
    j = i_st[:, 0]
    mutual = m_st[:, 0] & m_ts[j, 0] & (i_ts[j, 0] == torch.arange(j.shape[0], device=dev))
    rows = torch.nonzero(mutual).squeeze(1)
    n = int(rows.shape[0])
    corrs = Correspondences.empty(round_up(max(n, 1)), dev)
    corrs.query[:n] = kp_s[rows].to(corrs.query.dtype)
    corrs.match[:n] = kp_t[j[rows]].to(corrs.match.dtype)
    corrs.distance[:n] = d_st[rows, 0]
    corrs.threshold.fill_(2.0 * resolution)
    corrs.valid[:n] = True
    return src_d, tgt_d, corrs

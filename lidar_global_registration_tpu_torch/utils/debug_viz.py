"""Debug PLY / CSV artifact writers (lidar_global_registration_tpu/utils/debug_viz.py).

Reference: the debug-save half of src/common.cpp (757-1266): colorized
clouds, keypoint / correspondence / inlier colouring, GT-aligned side-by-side
correspondence clouds with edge faces, distance / normal-difference
temperature maps with histograms, colorized weights.  Colours and
distances are computed on the clouds' device; arrays come to NumPy only at
the writer (utils/io.write_ply, the CSV loops).  The nearest-point queries
are exact (ops/grid.nearest_within, ops/grid.knn), where the JAX package's
grids keep 64 points a cell.  Histogram PNGs need matplotlib; without it
they are skipped with one printed line, and the distance CSVs are still
written.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from lidar_global_registration_tpu_torch.ops.grid import knn, nearest_within
from lidar_global_registration_tpu_torch.types import (
    DIST_TO_PLANE_COEFFICIENT,
    AlignmentParameters,
    Cloud,
    Correspondences,
)
from lidar_global_registration_tpu_torch.utils import io as iomod
from lidar_global_registration_tpu_torch.utils.naming import construct_path

COLOR_BEIGE = 0xF8C471
COLOR_PURPLE = 0xAF7AC5
COLOR_RED = 0xFF0000
COLOR_PARAKEET = 0x03C04A
COLOR_ROSE = 0xE3242B
COLOR_BLUE = 0x0000FF
COLOR_WHITE = 0xFFFFFF


def _rgb(color: int, device=None) -> torch.Tensor:
    return torch.tensor([(color >> 16) & 0xFF, (color >> 8) & 0xFF, color & 0xFF],
                        dtype=torch.uint8, device=device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _mask(m, n: int, device) -> torch.Tensor:
    """The first n entries of a boolean mask given as an array or a tensor."""
    return torch.as_tensor(m, dtype=torch.bool, device=device)[:n]


def _write_cloud(path: str, cloud: Cloud, color: torch.Tensor) -> None:
    """The valid rows of `cloud` with their normals and `color` u8[N, 3]."""
    v = cloud.valid
    iomod.write_ply(path, _np(cloud.xyz[v]), normal=_np(cloud.normal[v]), color=_np(color[v]))


def temperature_color(v: torch.Tensor, vmin: float, vmax: float) -> torch.Tensor:
    """getColor's blue -> green -> red ramp (common.cpp:818-835), f32[N, 3]
    in [0, 255], in float32 in the JAX function's order of operations."""
    v = v.clamp(vmin, vmax)
    dv = max(vmax - vmin, 1e-30)
    s1 = v < (vmin + dv / 3)
    s2 = (~s1) & (v < vmin + 2 * dv / 3)
    s3 = ~(s1 | s2)
    one = torch.ones_like(v)
    b = torch.where(s1, 1 - 3 * (v - vmin) / dv, 0.0)
    g = torch.where(s2, 2 - 3 * (v - vmin) / dv, torch.where(s3, 0.0, one))
    r = torch.where(s3, 3 - 3 * (v - vmin) / dv, one)
    return torch.stack([r, g, b], 1) * 255.0


def save_colorized_cloud(cloud: Cloud, transformation_gt, color: int, filepath: str) -> None:
    """saveColorizedPointCloud (common.cpp:757-769)."""
    moved = cloud.transformed(transformation_gt)
    _write_cloud(filepath, moved,
                 _rgb(color, cloud.xyz.device).expand(cloud.capacity, 3))


def save_cloud_with_correspondences(cloud: Cloud, key_point_indices, correspondences:
                                    Optional[Correspondences], correct_mask, inlier_mask,
                                    params: AlignmentParameters, transformation_gt,
                                    is_source: bool) -> str:
    """savePointCloudWithCorrespondences (common.cpp:771-816): keypoints
    beige on parakeet (all beige without keypoints), correspondences red,
    inliers blue, correct ones blended with white.  The masks run over the
    valid correspondences in order."""
    dev = cloud.xyz.device
    moved = cloud.transformed(transformation_gt)
    base = COLOR_PARAKEET if key_point_indices is not None else COLOR_BEIGE
    col = _rgb(base, dev).repeat(cloud.capacity, 1)
    if key_point_indices is not None:
        col[torch.as_tensor(key_point_indices, device=dev).long()] = _rgb(COLOR_BEIGE, dev)
    if correspondences is not None:
        ids = (correspondences.query if is_source else correspondences.match)[
            correspondences.valid]
        col[ids] = _rgb(COLOR_RED, dev)
        if inlier_mask is not None:
            col[ids[_mask(inlier_mask, ids.shape[0], dev)]] = _rgb(COLOR_BLUE, dev)
        if correct_mask is not None:
            sel = ids[_mask(correct_mask, ids.shape[0], dev)]
            col[sel] = col[sel] // 2 + _rgb(COLOR_WHITE, dev) // 2
    path = construct_path(params, "downsampled_" + ("src" if is_source else "tgt"), "ply",
                          True, True, True, True)
    _write_cloud(path, moved, col)
    return path


def save_colorized_weights(cloud: Cloud, weights: torch.Tensor, name: str,
                           params: AlignmentParameters, transformation) -> str:
    """saveColorizedWeights (common.cpp:837-850): the valid rows' weights on
    a ramp between their 1 % and 99 % quantiles."""
    from lidar_global_registration_tpu_torch.ops.weights import _quantile

    moved = cloud.transformed(transformation)
    w = torch.as_tensor(weights, dtype=torch.float32, device=cloud.xyz.device)
    wv = _np(w[cloud.valid])
    col = temperature_color(w, _quantile(wv, 0.01), _quantile(wv, 0.99)).to(torch.uint8)
    path = construct_path(params, name, "ply", True, True, True, True)
    _write_cloud(path, moved, col)
    return path


def save_correspondence_edges(src: Cloud, tgt: Cloud, corrs: Correspondences,
                              transformation_gt, params: AlignmentParameters,
                              sparse: bool = False, max_edges: int = 100) -> str:
    """saveCorrespondences (common.cpp:1019-1060): the GT-aligned source and
    the target moved along x by the source's AABB diagonal, side by side,
    one degenerate triangle face per correspondence (its two ends and their
    midpoint, an extra vertex), each in a random colour (NumPy's generator
    seeded 566, as the JAX package); a point on several edges takes the
    last one's colour."""
    from lidar_global_registration_tpu_torch.ops.downsample import aabb

    dev = src.xyz.device
    moved = src.transformed(transformation_gt)
    sv, tv = moved.valid, tgt.valid
    lo, hi = aabb(moved.xyz, sv)
    txyz = tgt.xyz.clone()
    txyz[:, 0] += float(((hi - lo) ** 2).sum().sqrt())

    q, m = corrs.query[corrs.valid], corrs.match[corrs.valid]
    rng = np.random.default_rng(566)
    order = np.arange(q.shape[0])
    if sparse and len(order) > max_edges:
        order = rng.permutation(order)[:max_edges]
    order_t = torch.from_numpy(order).to(dev)

    xyz = torch.cat([moved.xyz[sv], txyz[tv]])
    nrm = torch.cat([moved.normal[sv], tgt.normal[tv]])
    ns = int(sv.sum())
    col = torch.cat([_rgb(COLOR_BEIGE, dev).repeat(ns, 1),
                     _rgb(COLOR_PURPLE, dev).repeat(xyz.shape[0] - ns, 1)])
    # rows of the compacted concatenation
    a = (torch.cumsum(sv, 0) - 1)[q[order_t]]
    b = (torch.cumsum(tv, 0) - 1 + ns)[m[order_t]]
    edge_colors = torch.from_numpy(rng.integers(0, 256, size=(len(order), 3))).to(dev)
    n_e = len(order)
    if n_e:
        ends = torch.cat([a, b])
        last = torch.full((xyz.shape[0],), -1, dtype=torch.int64, device=dev)
        last.scatter_reduce_(0, ends, torch.arange(n_e, device=dev).repeat(2), "amax")
        hit = last >= 0
        col[hit] = edge_colors[last[hit]].to(torch.uint8)
    mids = (xyz[a] + xyz[b]) / 2
    faces = torch.stack([a, b, xyz.shape[0] + torch.arange(n_e, device=dev)], 1)
    xyz = torch.cat([xyz, mids])
    nrm = torch.cat([nrm, torch.zeros_like(mids)])
    col = torch.cat([col, torch.full((n_e, 3), 255, dtype=torch.uint8, device=dev)])
    path = construct_path(params, "correspondences_sparse" if sparse else "correspondences")
    iomod.write_ply(path, _np(xyz), normal=_np(nrm), color=_np(col), binary=False,
                    faces=_np(faces) if n_e else None)
    return path


def save_temperature_maps(src: Cloud, tgt: Cloud, name: str, params: AlignmentParameters,
                          distance_thr: float, transformation) -> list[str]:
    """saveTemperatureMaps (common.cpp:859-963): per valid point of each
    side its distance to the other side's nearest point's plane within
    DIST_TO_PLANE_COEFFICIENT * distance_thr (capped at distance_thr), and
    its normal's angle to that point's, as temperature-coloured PLYs; the
    distances below distance_thr as a CSV and a histogram PNG."""
    moved = src.transformed(transformation)
    outputs = []
    radius = DIST_TO_PLANE_COEFFICIENT * distance_thr
    for tag, compared, reference in (("src", moved, tgt), ("tgt", tgt, moved)):
        nn, dist, found = nearest_within(reference.xyz, reference.valid, compared.xyz,
                                         compared.valid, max(radius, 1e-12))
        cxyz, cnrm = compared.xyz, compared.normal
        rxyz, rnrm = reference.xyz[nn], reference.normal[nn]
        d2p = (rnrm * (rxyz - cxyz)).sum(-1).abs()
        nrm_ok = (rnrm * rnrm).sum(-1) > 0.5
        # degenerate normal: the plain nearest-point distance
        d2p = torch.where(nrm_ok, d2p, torch.where(found, dist, distance_thr))
        near = found & (d2p < distance_thr)
        temp = torch.where(near, d2p, distance_thr)
        p1 = construct_path(params, f"{name}_dists_{tag}")
        _write_cloud(p1, compared, temperature_color(temp, 0.0, distance_thr).to(torch.uint8))
        outputs.append(p1)

        dists_in = _np(temp[compared.valid & (temp < distance_thr)])
        save_vector_csv(dists_in, construct_path(params, f"{name}_distances_{tag}", "csv"))
        _histogram_png(dists_in, construct_path(params, f"{name}_histogram_{tag}", "png"))

        nd = torch.arccos((cnrm * rnrm).sum(-1).clamp(-1, 1)).abs()
        nd = torch.where(near & nrm_ok, nd, math.pi / 2).clamp_max(math.pi / 2)
        p2 = construct_path(params, f"{name}_normal_diffs_{tag}")
        _write_cloud(p2, compared, temperature_color(nd, 0.0, math.pi / 2).to(torch.uint8))
        outputs.append(p2)
    return outputs


def _histogram_png(values: np.ndarray, path: str) -> None:
    """A 50-bin histogram PNG (plots.py in the reference, common.cpp:852-857)."""
    try:
        import matplotlib
    except ImportError:
        print(f"# debug: no matplotlib, histogram PNG skipped ({os.path.basename(path)})",
              flush=True)
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(4, 3))
    if len(values):
        ax.hist(values, bins=50)
    fig.savefig(path)
    plt.close(fig)


def save_features_csv(features, feat_valid, indices, filepath: str) -> None:
    """saveFeatures (include/feature_analysis.h:11-27): one row per valid
    descriptor, `index,val0,...,valD`, the index from `indices` (the row
    itself when None)."""
    f32 = _np(torch.as_tensor(features))
    v = _np(torch.as_tensor(feat_valid))
    ids = None if indices is None else _np(torch.as_tensor(indices))
    os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
    with open(filepath, "w") as f:
        for i in np.nonzero(v)[0]:
            row = [str(ids[i] if ids is not None else i)] + [f"{x:g}" for x in f32[i]]
            f.write(",".join(row) + "\n")


def save_vector_csv(values, filepath: str) -> None:
    with open(filepath, "w") as f:
        f.write("value\n")
        for x in np.asarray(values):
            f.write(f"{x:g}\n")


def save_normals(cloud: Cloud, transformation_gt, is_source: bool,
                 params: AlignmentParameters) -> str:
    """saveNormals (feature_analysis.cpp:11-18): the GT-aligned cloud with
    its normals as a binary PLY."""
    moved = cloud.transformed(transformation_gt)
    v = moved.valid
    path = construct_path(params, "normals_" + ("src" if is_source else "tgt"))
    iomod.write_ply(path, _np(moved.xyz[v]), normal=_np(moved.normal[v]))
    return path


def save_extracted_point_ids(src: Cloud, tgt: Cloud, transformation_gt,
                             params: AlignmentParameters, extracted_xyz) -> str:
    """saveExtractedPointIds (feature_analysis.cpp:20-56): the nearest point
    ids of `extracted_xyz` in the GT-aligned source and in the target, with
    their coordinates (exact nearest points, ops/grid.knn)."""
    moved = src.transformed(transformation_gt)
    q = torch.as_tensor(extracted_xyz, dtype=torch.float32, device=src.xyz.device)
    src_ids = knn(moved.xyz, moved.valid, 1, queries=q)[0][:, 0]
    tgt_ids = knn(tgt.xyz, tgt.valid, 1, queries=q)[0][:, 0]
    sxyz, txyz = _np(moved.xyz[src_ids]), _np(tgt.xyz[tgt_ids])
    s_np, t_np = _np(src_ids), _np(tgt_ids)
    path = construct_path(params, "ids", "csv")
    with open(path, "w") as f:
        f.write("id_src,id_tgt,x_src,x_tgt,y_src,y_tgt,z_src,z_tgt\n")
        for i in range(len(s_np)):
            s, t = sxyz[i], txyz[i]
            f.write(f"{s_np[i]},{t_np[i]},{s[0]:g},{t[0]:g},{s[1]:g},{t[1]:g},{s[2]:g},"
                    f"{t[2]:g}\n")
    return path

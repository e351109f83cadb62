#!/usr/bin/env python3
"""Timings behind two design choices of the port's host pipeline, on one
CUDA card, on the graded bench pair that chip_smoke.py's CLI phase writes:

1. The nearest point within a radius (analysis.overlap_rmse /
   normal_difference / merge_overlaps at 2 x distance_thr and
   distance_thr; ops/metrics.closest_plane_metric, the `metric` command's
   closest-plane query, at 2 x the target's density): one pass over a plan
   whose cell is the radius (ops/grid.radius_neighbors, k = 1) against
   ops/grid.nearest_within (passes at radius / 8, / 4, / 2 and the radius,
   each over its own plan, a query going on only while nothing was
   found).  Both are exact; each query is timed warm, three times, and the
   two answers are compared.
2. The loader's raw-cloud density (ops/density.cloud_density ->
   knn_nonself): its cell passes against its finish over the whole cloud
   (_knn_brute), with the rows each doubling of the cell leaves, per scan.

    python3 probe_queries.py                   # 1,048,576 and 10,485,760
    python3 probe_queries.py --sizes 1048576

The clouds are preprocessed as `load_point_clouds` does it (density, the
fine voxel downsample, kNN-30 normals) from the scene chip_smoke.py
samples.  Prints one line per measurement, the card's name and power
limit, and a JSON line of every number; needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

sys.modules["jax"] = None  # the port runs without JAX

from chip_smoke import gpu_line, iss_scene, log  # noqa: E402


def one_pass(plan, q, qv, r):
    from lidar_global_registration_tpu_torch.ops.grid import radius_neighbors

    i, d, m = radius_neighbors(plan, q, qv, r, 1)
    return i[:, 0], d[:, 0], m[:, 0]


def wall(fn, reps: int = 3):
    """(result, [seconds of each of `reps` calls after one warm-up])."""
    import torch

    out = fn()
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return out, ts


def compare_query(label, xyz, valid, q, qv, r, plan=None):
    """Both designs on one query set; `plan`: a prebuilt plan of cell r
    (as a metric context would build once for many transforms), else the
    one pass builds its own."""
    import torch

    from lidar_global_registration_tpu_torch.ops import cellgrid
    from lidar_global_registration_tpu_torch.ops.grid import nearest_within

    out = {"label": label, "radius": r, "queries": int(qv.sum()), "support": int(valid.sum())}
    if plan is None:
        one, out["one_pass_s"] = wall(lambda: one_pass(cellgrid.plan_grid(xyz, valid, r),
                                                       q, qv, r))
    else:
        one, out["one_pass_s"] = wall(lambda: one_pass(plan, q, qv, r))
        _p, out["plan_s"] = wall(lambda: cellgrid.plan_grid(xyz, valid, r))
    four, out["passes_s"] = wall(lambda: nearest_within(xyz, valid, q, qv, r))
    # candidates a query scans in the one pass: its 9 stencil columns
    p1 = plan if plan is not None else cellgrid.plan_grid(xyz, valid, r)
    cols = cellgrid.position_cols(p1, q[qv])
    out["candidates_mean"] = float((cols[..., 1] - cols[..., 0]).sum(1).double().mean())
    same_found = torch.equal(one[2], four[2])
    same_dist = torch.equal(one[1], four[1])
    out["idx_differ"] = int((one[0] != four[0]).sum())
    out["found"] = int(one[2].sum())
    assert same_found and same_dist, f"{label}: the two designs disagree"
    log(f"#   {label}: r {r:.5g}, {out['queries']} queries on {out['support']} rows, "
        f"{out['candidates_mean']:.1f} candidates a query in one pass, found {out['found']}; "
        f"one pass {' '.join(f'{t:.4f}' for t in out['one_pass_s'])} s"
        + (f" (+ plan {out['plan_s'][0]:.4f} s, built once)" if plan is not None else "")
        + f"; four passes {' '.join(f'{t:.4f}' for t in out['passes_s'])} s; "
        f"equal found and dist, {out['idx_differ']} idx on ties")
    return out


def timed_density(xyz):
    """cloud_density with the time of its cell passes and of its finish
    over the whole cloud, and the rows each plan was queried for."""
    import torch

    from lidar_global_registration_tpu_torch.ops import cellgrid, density

    brute, plans = [], []
    orig_brute, orig_plan = density._knn_brute, cellgrid.plan_grid

    def timed_brute(pts, rows, k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orig_brute(pts, rows, k)
        torch.cuda.synchronize()
        brute.append((int(rows.shape[0]), time.perf_counter() - t0))
        return res

    def counted_plan(pts, valid, cell):
        plans.append(float(cell))
        return orig_plan(pts, valid, cell)

    density._knn_brute, cellgrid.plan_grid = timed_brute, counted_plan
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = density.cloud_density(xyz)
        total = time.perf_counter() - t0
    finally:
        density._knn_brute, cellgrid.plan_grid = orig_brute, orig_plan
    rows, t_brute = (brute[0] if brute else (0, 0.0))
    return dict(density=d, total_s=total, brute_rows=rows, brute_s=t_brute,
                cells=plans, cell_passes_s=total - t_brute)


def probe(n: int, dev) -> dict:
    import torch

    from lidar_global_registration_tpu_torch.models.pipeline import preprocess_cloud
    from lidar_global_registration_tpu_torch.ops import cellgrid
    from lidar_global_registration_tpu_torch.ops.density import cloud_density
    from lidar_global_registration_tpu_torch.types import DIST_TO_PLANE_COEFFICIENT, Cloud

    a, b, vp_a, vp_b, T_gt = iss_scene(n, dev, graded=True)
    rec = {"n": n}
    clouds = []
    for side, x, vp in (("A", a, vp_a), ("B", b, vp_b)):
        dens = timed_density(x)
        rec[f"raw_density_{side}"] = dens
        log(f"# n={n} scan {side}: raw density {dens['density']:.6g} in {dens['total_s']:.3f} s: "
            f"cell passes {dens['cell_passes_s']:.3f} s over {len(dens['cells'])} cells "
            f"({', '.join(f'{c:.4g}' for c in dens['cells'])}), finish over the whole cloud "
            f"{dens['brute_s']:.3f} s for {dens['brute_rows']} rows")
        clouds.append(preprocess_cloud(Cloud.from_numpy(x), vp.cpu().numpy()))
    src, tgt = clouds
    ds, dt = (cloud_density(c.xyz, c.valid) for c in clouds)
    thr = 4.0 * max(ds, dt)  # expand_parameters' AUTO distance_thr
    log(f"# n={n}: preprocessed {int(src.count())} / {int(tgt.count())} rows, densities "
        f"{ds:.6g} / {dt:.6g}, distance_thr {thr:.6g}")
    src_gt = src.transformed(T_gt.to(dev))
    r2 = DIST_TO_PLANE_COEFFICIENT * thr
    rec["queries"] = [
        compare_query("analysis: GT-aligned source -> target, 2 thr", tgt.xyz, tgt.valid,
                      src_gt.xyz, src_gt.valid, r2),
        compare_query("analysis: GT-aligned source -> target, thr", tgt.xyz, tgt.valid,
                      src_gt.xyz, src_gt.valid, thr),
        compare_query("analysis: target -> GT-aligned source, 2 thr", src_gt.xyz, src_gt.valid,
                      tgt.xyz, tgt.valid, r2),
    ]
    rc = DIST_TO_PLANE_COEFFICIENT * dt  # build_metric_context: 2 x the target's density
    plan = cellgrid.plan_grid(tgt.xyz, tgt.valid, rc)
    rec["queries"].append(compare_query("metric: closest-plane samples -> target, 2 density",
                                        tgt.xyz, tgt.valid, src_gt.xyz, src_gt.valid, rc, plan))
    rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"# n={n}: peak device memory {rec['peak_gib']:.2f} GiB")
    del a, b, clouds, src, tgt, src_gt, plan
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[1048576, 10485760])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_queries: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    log(f"# gpu: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}")
    recs = [probe(n, dev) for n in args.sizes]
    log(gpu)
    log(json.dumps({"gpu": gpu, "probes": recs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""One run of one cell of the PyTorch + CUDA port's benchmark, on the card it
is started on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (BENCHMARK.json `workloads`) names a configuration (its file under
benchmark/configs/) and a traffic mix (benchmark/traffic/<name>.json).
Set-up builds the traffic from the seed on the card, derives the radii
(the raw pair's densities, then each pooled pose's seven radii on its
pre-downsampled pair) and registers every pooled pair once.  The window is
a closed loop with one client: pair i is pooled pair i mod pool, and each pair
is `flagship.pre_downsample_pair` then `flagship.register_pair_staged`, the
pose read to the host.  After the window check.py compares the outcome
with the cell's reference module (benchmark/reference/<name>.py, named by
the configuration's `reference`); the last stdout line is the JSON result,
and the numbers compared, each beside its limit, close stderr.

With --trace 1 the first `profiled_pairs` pairs of the window run under
torch.profiler and the rest with register_pair_staged's stage_times; the
line then carries the per-layer metrics (benchmark/metrics/<name>.py) and
the breakdown.  Without a card (or with fewer than the cell asks for) it
exits 2 and prints no result; with jax, jaxlib, flax or the JAX package
loaded after the window it exits 3.
"""
from __future__ import annotations

import time

_T0 = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check, manifest, stats, tracing  # noqa: E402
from benchmark import traffic as traffic_mod  # noqa: E402

PORT = "lidar_global_registration_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "lidar_global_registration_tpu")
MISSED_P95_S = 1e9  # the 95th percentile reads this where it falls on a missed pair


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_program():
    """The entries the window drives, and derive_radii for set-up."""
    import importlib

    flagship = importlib.import_module(f"{PORT}.models.flagship")
    density = importlib.import_module(f"{PORT}.ops.density")
    cellgrid = importlib.import_module(f"{PORT}.ops.cellgrid")
    nn_l2 = importlib.import_module(f"{PORT}.ops.nn_l2")
    wrappers = [f for m in (cellgrid, nn_l2) for name, f in vars(m).items()
                if name.endswith("_cuda") and hasattr(f, "launches")]
    return SimpleNamespace(
        FlagshipConfig=flagship.FlagshipConfig,
        pre_downsample_pair=flagship.pre_downsample_pair,
        register_pair_staged=flagship.register_pair_staged,
        derive_radii=density.derive_radii,
        csrc=Path(flagship.__file__).resolve().parents[1] / "csrc",
        wrappers=wrappers,
    )


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device,
             program=None, t_start: float = _T0) -> dict:
    """One run; returns the result dict (the JSON line's keys)."""
    prog = program or load_program()
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    conf, spec = cell.config, cell.traffic
    cfg = prog.FlagshipConfig(**conf["flagship"])
    rule = conf["rule"]
    pool = int(spec["pool"])
    n = int(spec["points_per_side"])

    # ---- set-up: traffic, radii, one registration of every pooled pair
    tr = traffic_mod.build(spec, seed, device)
    ones = torch.ones((n,), dtype=torch.bool, device=device)
    raw = prog.derive_radii(tr.src, tr.tgt_world)
    factor = float(conf["pre_downsample_voxel_per_density"])
    vox = (factor * raw["density_src"], factor * raw["density_tgt"])
    radii = []
    for pair in tr.pairs:
        sx, sv, tx, tv = prog.pre_downsample_pair(tr.src, ones, pair.tgt, ones, *vox,
                                                  aabb=pair.aabb)
        radii.append(prog.derive_radii(sx, tx, sv, tv))
        del sx, sv, tx, tv
    acc = {"pre_downsample": 0.0}
    profiling = [False]

    def span(name):
        """A host annotation in the profiled pairs' trace; nothing elsewhere."""
        if profiling[0]:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def step(k: int, stage_times=None):
        pair, r = tr.pairs[k], radii[k]
        if stage_times is not None:
            sync()
            t0 = time.perf_counter()
        with span("bench.pre_downsample"):
            sx, sv, tx, tv = prog.pre_downsample_pair(tr.src, ones, pair.tgt, ones, *vox,
                                                      aabb=pair.aabb)
        if stage_times is not None:
            sync()
            acc["pre_downsample"] += time.perf_counter() - t0
        gen = torch.Generator(device=device).manual_seed(pair.ransac_seed)
        with span("bench.register"):
            out = prog.register_pair_staged(sx, sv, tx, tv, gen,
                                            *(float(r[key]) for key in check.RADII_KEYS),
                                            vp_src=tr.vp_src, vp_tgt=pair.vp_tgt, cfg=cfg,
                                            return_correspondences=True,
                                            stage_times=stage_times)
        with span("bench.pose_read"):
            T = out["transformation"].cpu().numpy()  # the pose on the host ends the pair
            converged = bool(out["converged"])
        return T, converged, (sx, sv, tx, tv, out)

    for k in range(pool):
        step(k)
    sync()
    setup_s = time.time() - t_start

    # ---- the window
    check_poses = set(traffic_mod.checked_pairs(seed, spec))
    n_prof = int(spec["profiled_pairs"]) if trace else 0
    readings = tracing.Readings(profiled_pairs=n_prof)
    kept, records = {}, []
    for w in prog.wrappers:
        w.launches = 0
    prof = ann = None
    if trace:
        prof = tracing.profile(device)
        prof.__enter__()
        ann = torch.profiler.record_function(tracing.WINDOW)
        ann.__enter__()
        profiling[0] = True
    t_open = time.perf_counter()
    i = 0
    while time.perf_counter() - t_open < seconds:
        k = i % pool
        if ann is not None and i == n_prof:
            profiling[0] = False
            ann.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            ann = None
        stage_times = {} if trace and i >= n_prof else None
        t0 = time.perf_counter()
        T, conv, products = step(k, stage_times)
        records.append(dict(pose=k, seconds=time.perf_counter() - t0, converged=conv, T=T))
        if k in check_poses and k not in kept:
            kept[k] = products
        if stage_times is not None:
            for label, s in stage_times.items():
                readings.stage_s[label] = readings.stage_s.get(label, 0.0) + s
            readings.stage_pairs += 1
            readings.pair_s.append(records[-1]["seconds"])
        i += 1
    window_s = time.perf_counter() - t_open
    if ann is not None:
        profiling[0] = False
        ann.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        readings.profiled_pairs = i
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    leaked = forbidden_modules()
    if leaked:
        raise SystemExit(f"loaded after the window: {', '.join(leaked)}")

    # ---- the end-to-end metrics
    for rec in records:
        rec["r_err"], rec["t_err"] = stats.rotation_translation_error(
            rec["T"], tr.pairs[rec["pose"]].T_gt)
        rec["thr"] = float(radii[rec["pose"]]["thr"])
        rec["ok"] = stats.meets_rule(rec["converged"], rec["r_err"], rec["t_err"], rec["thr"],
                                     rule)
    times = [r["seconds"] for r in records]
    oks = [r["ok"] for r in records]
    failed = len(oks) - sum(oks)
    p95 = stats.p95(times, oks)
    launches = {w.__name__: w.launches for w in prog.wrappers if w.launches}
    log(f"# device: {gpu_line() if cuda else 'cpu'}; peak memory {peak} bytes")
    log(f"# window: {len(records)} pairs in {window_s:.4f} s, {failed} missed the rule; "
        f"set-up {setup_s:.4f} s; launches a pair "
        f"{ {k: v / max(len(records), 1) for k, v in launches.items()} }")
    log(f"# radii of the raw pair {raw}; of pose 0 {radii[0]}")
    log("# median seconds a pair by pose of the pool: " + ", ".join(
        f"{tr.pairs[k].pose}: {np.median([r['seconds'] for r in records if r['pose'] == k]):.4f}"
        for k in range(pool) if any(r["pose"] == k for r in records)))
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    metrics = {}
    values = {"pairs_per_s": stats.rate(oks, window_s),
              "pair_s_p95": p95 if math.isfinite(p95) else MISSED_P95_S,
              "setup_s": setup_s}
    traced = {}
    if trace:
        readings.handwritten = tracing.handwritten_kernels(prog.csrc)
        readings.pre_downsample_s = acc["pre_downsample"]
        if prof is not None:
            tracing.reduce_trace(tracing.read_profile(prof), readings)
        for m in cell.per_layer:
            v = manifest.reader(m["name"])(readings)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_info["busy_s"] = readings.busy_s
        device_info["window_s"] = readings.window_s
        traced["breakdown"] = tracing.breakdown(readings)
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

    # ---- the check, once the program's state is freed
    checked = []
    for k, (sx, sv, tx, tv, out) in sorted(kept.items()):
        sel, jm, thr, valid = out["correspondences"]
        T = next(r["T"] for r in records if r["pose"] == k)
        checked.append(check.Checked(pose=k, src_rows=sx[sv], tgt_rows=tx[tv],
                                     corr=torch.stack([sel[valid], jm[valid]], 1),
                                     radii=radii[k], T=T))
        log(f"# checked pose {tr.pairs[k].pose}: {int(sv.sum())} / {int(tv.sum())} working rows, "
            f"{int(valid.sum())} correspondences, inliers {int(out['inliers'])}, "
            f"share beyond thr of the truth "
            f"{check.outlier_share(sx[sel[valid]], tx[jm[valid]], tr.pairs[k].T_gt, thr[valid])}")
    del kept, step
    tr.pairs = [p if k in check_poses else None for k, p in enumerate(tr.pairs)]
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = check.rule_numbers(records)
    ref = cell.reference.Reference(tr, conf)
    compared, shown = check.compare(raw, checked, ref)
    numbers.update(compared)
    for c in checked:
        counts = ", ".join(f"{k} {v}" for k, v in ref.pose(c.pose).counts.items())
        log(f"# reference of pose {tr.pairs[c.pose].pose}: {counts} "
            f"(the program's {c.corr.shape[0]})")
    limits = {"rule_rot_rad": rule["rot_rad"], "rule_t_over_thr": rule["t_over_thr"],
              "rule_unconverged": 0.0, **cell.limits}
    correct, table = check.judge(numbers, limits)
    log(f"# reference check {time.perf_counter() - t_ref:.3f} s")
    log("# printed, not compared: " + ", ".join(f"{k} {v!r}" for k, v in shown.items()))
    for name, t in table.items():
        log(f"# check {name} {t['value']!r} limit {t['limit']!r} "
            f"{'ok' if math.isfinite(t['value']) and t['value'] <= t['limit'] else 'FAILED'}")
    return {"correct": correct, "attempted": len(records), "failed": failed,
            "metrics": metrics, "device": device_info, **traced,
            "checks": {k: [t["value"] if math.isfinite(t["value"]) else None, t["limit"]]
                       for k, t in table.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"no result: the cell needs {cell.chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 2
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"))
    except SystemExit as e:
        log(f"no result: {e}")
        return 3
    leaked = forbidden_modules()
    if leaked:
        log(f"no result: loaded in this process: {', '.join(leaked)}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Builds the kernels of lidar_global_registration_tpu_torch/csrc from
source, checks each against its plain PyTorch version at the main path's
shapes, then registers the bench's keypoint-any pair (bench.py:177-190,
65,536 points per side) through `models.flagship.register_pair_staged`:
one warm-up and three timed repeats, each held to the bench's success rule
(converged, rotation error < 0.05 rad, translation error < distance_thr).
Then a small pair through both the kernels and the plain versions, and one
262,144-point pair.  Every launch counter must rise during the main runs.

The next-to-last line of standard output is a JSON object with one entry
per kernel; the last is {"ok": true, "device": {...}}.  Any failure exits
non-zero without those lines.  Needs one CUDA device; JAX is never imported.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.modules["jax"] = None  # the port must run without JAX: any import fails

ROOT = Path(__file__).resolve().parent
ANG = 0.4  # the synthetic pair's known rotation about z and translation
T_OFF = np.array([2.0, -1.0, 0.5], np.float32)
R_ERR_MAX = 0.05  # bench.py:86
N_MAIN = 65536  # the bench's keypoint-any row (bench.py:77)
REPEATS = 3
N_LARGE = 262144


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def scene(n: int):
    """The bench's keypoint-any pair, viewpoints and ground truth."""
    from __graft_entry__ import _synthetic_pair

    a, b = _synthetic_pair(n)
    Rb = np.array([[np.cos(ANG), -np.sin(ANG), 0], [np.sin(ANG), np.cos(ANG), 0], [0, 0, 1]],
                  np.float32)
    vp_a = np.array([15.0, 15.0, 120.0], np.float32)
    vp_b = Rb.T @ (vp_a - T_OFF)
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3] = Rb.T
    T_gt[:3, 3] = -Rb.T @ T_OFF
    return a, b, vp_a, vp_b, T_gt


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps launches (after one warm-up)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def frac_off(a, b, thr=0.5) -> float:
    return float(((a - b).abs() > thr).float().mean())


def check_kernels(dev, a, b, radii):
    """Each kernel against its plain version on the card, at the main path's
    shapes; returns the per-kernel records (launches filled in later)."""
    import torch

    from lidar_global_registration_tpu_torch.ops import cellgrid as cg
    from lidar_global_registration_tpu_torch.ops import nn_l2

    A = torch.from_numpy(a).to(dev)
    B = torch.from_numpy(b).to(dev)
    ones = torch.ones(A.shape[0], dtype=torch.bool, device=dev)
    rn, rf = radii["normal_cell"], radii["feature"]
    plan_n = cg.plan_grid(A, ones, rn)
    r2n = cg._f32_square(rn)
    records = []

    # K1 surface
    out_k, d_k, id_k = cg.surface_cuda(plan_n, r2n)
    out_p, d_p, id_p = cg.surface_plain(plan_n, r2n)
    sign = torch.where((out_k[:, :3] * out_p[:, :3]).sum(1, keepdim=True) < 0, -1.0, 1.0)
    err = torch.cat([(out_k[:, :3] * sign - out_p[:, :3]).abs().flatten(),
                     (out_k[:, 3:7] - out_p[:, 3:7]).abs().flatten(), (d_k - d_p).abs()])
    dots = (out_k[:, :3] * out_p[:, :3]).sum(1).abs()
    assert torch.equal(out_k[:, 7], out_p[:, 7]), "K1 neighbour counts differ"
    assert torch.equal(id_k, id_p), "K1 nearest-neighbour ids differ"
    # normals up to sign: 1e-5 where the normal is well defined (eigen gap
    # l1 - l0 >= 1e-2 l2), as in tests/test_torch_cellgrid.py
    ok = out_p[:, 7] >= 3
    well = ok & (out_p[:, 5] - out_p[:, 4] >= 1e-2 * out_p[:, 6])
    assert bool((dots[well] > 1 - 1e-5).all()), f"K1 normals: min |dot| {float(dots[well].min())}"
    assert bool((dots[ok] > 0.99).all()), f"K1 normals: min |dot| {float(dots[ok].min())}"
    # curvature: the sums run in another order; l0 of a flat patch is a
    # float32 cancellation residue, so small values carry ~1e-7 absolute noise
    torch.testing.assert_close(out_k[:, 3], out_p[:, 3], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(d_k, d_p, rtol=1e-4, atol=0.0)
    records.append(dict(
        name="surface", route="cuda", source="lidar_global_registration_tpu_torch/csrc/surface.cu",
        replaces="lidar_global_registration_tpu/ops/pallas/cellgrid.py:1241",
        max_abs_err=float(err.max()),
        ms=cuda_ms(lambda: cg.surface_cuda(plan_n, r2n), 10),
        plain_ms=cuda_ms(lambda: cg.surface_plain(plan_n, r2n), 2),
    ))
    log(f"# K1 surface ok: n={plan_n.n_valid} max_abs_err={records[-1]['max_abs_err']:.3g}")

    # K5 spfh and K6 combine on the feature grid with the kernel's normals
    normal = cg.surface_pass(plan_n, rn)[0]
    plan_f = cg.set_normals(cg.plan_grid(A, ones, rf), normal)
    r2f = cg._f32_square(rf)
    cen = cg.aabb_centre(plan_f)
    sp_k, c_k = cg.spfh_cuda(plan_f, r2f, cen)
    sp_p, c_p = cg.spfh_plain(plan_f, r2f, cen)
    assert torch.equal(c_k, c_p), "K5 pair counts differ"
    f5 = frac_off(sp_k, sp_p)
    assert f5 < 1e-3 and float((sp_k - sp_p).abs().median()) < 1e-3, f"K5: {f5:.2e} off by > 0.5"
    records.append(dict(
        name="spfh", route="cuda", source="lidar_global_registration_tpu_torch/csrc/fpfh.cu",
        replaces="lidar_global_registration_tpu/ops/pallas/cellgrid.py:1554",
        max_abs_err=float((sp_k - sp_p).abs().max()),
        ms=cuda_ms(lambda: cg.spfh_cuda(plan_f, r2f, cen), 5),
        plain_ms=cuda_ms(lambda: cg.spfh_plain(plan_f, r2f, cen), 1),
    ))
    log(f"# K5 spfh ok: frac_off={f5:.2e} max_abs_err={records[-1]['max_abs_err']:.3g}")
    f_k, k_k = cg.combine_cuda(plan_f, r2f, sp_p)
    f_p, k_p = cg.combine_plain(plan_f, r2f, sp_p)
    assert torch.equal(k_k, k_p), "K6 neighbour counts differ"
    f6 = frac_off(f_k, f_p)
    assert f6 < 1e-3 and float((f_k - f_p).abs().median()) < 1e-3, f"K6: {f6:.2e} off by > 0.5"
    records.append(dict(
        name="combine", route="cuda", source="lidar_global_registration_tpu_torch/csrc/fpfh.cu",
        replaces="lidar_global_registration_tpu/ops/pallas/cellgrid.py:1608",
        max_abs_err=float((f_k - f_p).abs().max()),
        ms=cuda_ms(lambda: cg.combine_cuda(plan_f, r2f, sp_p), 5),
        plain_ms=cuda_ms(lambda: cg.combine_plain(plan_f, r2f, sp_p), 1),
    ))
    log(f"# K6 combine ok: frac_off={f6:.2e} max_abs_err={records[-1]['max_abs_err']:.3g}")

    # K7 nn: source descriptors against target descriptors, D = 33
    feat_s, fv_s = cg.fpfh_pass(plan_f, rf)
    plan_tn = cg.plan_grid(B, ones, rn)
    plan_tf = cg.set_normals(cg.plan_grid(B, ones, rf), cg.surface_pass(plan_tn, rn)[0])
    feat_t, fv_t = cg.fpfh_pass(plan_tf, rf)
    d2k, ik = nn_l2.nn_l2_cuda(feat_s, feat_t, fv_t)
    d2p, ip = nn_l2.nn_l2_plain(feat_s, feat_t, fv_t)
    dk = d2k.clamp_min(0).sqrt()
    dp = d2p.clamp_min(0).sqrt()
    torch.testing.assert_close(dk, dp, rtol=1e-5, atol=1e-5)
    same = (dk - dp).abs() <= 1e-6
    assert torch.equal(ik[same], ip[same]), "K7 indices differ where distances agree"
    records.append(dict(
        name="nn_l2", route="cuda", source="lidar_global_registration_tpu_torch/csrc/nn_l2.cu",
        replaces="lidar_global_registration_tpu/ops/pallas/topk_l2.py:26",
        max_abs_err=float((dk - dp).abs().max()),
        ms=cuda_ms(lambda: nn_l2.nn_l2_cuda(feat_s, feat_t, fv_t), 3),
        plain_ms=cuda_ms(lambda: nn_l2.nn_l2_plain(feat_s, feat_t, fv_t), 1),
    ))
    log(f"# K7 nn_l2 ok: D={feat_s.shape[1]} idx_mismatch={int((ik != ip).sum())} "
        f"max_abs_err={records[-1]['max_abs_err']:.3g}")
    return records


def register(dev, a, b, vp_a, vp_b, radii, seed, times=None):
    import torch

    from lidar_global_registration_tpu_torch.models.flagship import (
        FlagshipConfig,
        register_pair_staged,
    )

    # bench.py:238-256 in keypoint-any mode
    cfg = FlagshipConfig(rounds=8, hypothesis_batch=1024, use_iss=False, match_tile=4096,
                         metric="correspondences")
    A = a if torch.is_tensor(a) else torch.from_numpy(a).to(dev)
    B = torch.from_numpy(b).to(dev)
    ones = torch.ones(A.shape[0], dtype=torch.bool, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return register_pair_staged(
        A, ones, B, ones, gen, radii["normal_cell"], radii["density_src"],
        radii["density_tgt"], radii["iss_src"], radii["iss_tgt"], radii["feature"],
        radii["thr"], vp_src=torch.from_numpy(vp_a).to(dev),
        vp_tgt=torch.from_numpy(vp_b).to(dev), cfg=cfg, return_correspondences=True,
        stage_times=times,
    )


def pose_error(out, T_gt):
    import torch

    from lidar_global_registration_tpu_torch.ops.transform import rotation_translation_error

    T = out["transformation"].cpu()
    r, t = rotation_translation_error(T, torch.from_numpy(T_gt))
    return float(r), float(t), bool(torch.isfinite(T).all())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from lidar_global_registration_tpu_torch import kernels
        from lidar_global_registration_tpu_torch.ops import cellgrid, nn_l2
        from lidar_global_registration_tpu_torch.ops.density import derive_radii
        from lidar_global_registration_tpu_torch.types import SEED
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"# gpu: {gpu}")

    path = kernels.library_path()
    nvcc_s, ptxas = kernels.build(path, verbose=True)
    kernels.library()
    log(f"# build: {nvcc_s:.2f} s (nvcc, from source) -> {path.name}")
    for line in ptxas.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log(f"#   {line.strip()}")

    a, b, vp_a, vp_b, T_gt = scene(N_MAIN)
    t0 = time.perf_counter()
    radii = derive_radii(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
    log(f"# radii ({time.perf_counter() - t0:.2f} s set-up): {radii}")

    records = check_kernels(dev, a, b, radii)

    counters = (cellgrid.surface_cuda, cellgrid.spfh_cuda, cellgrid.combine_cuda,
                nn_l2.nn_l2_cuda)
    for c in counters:
        c.launches = 0
    a_dev = torch.from_numpy(a).to(dev)
    out = register(dev, a_dev, b, vp_a, vp_b, radii, SEED)  # warm-up
    torch.cuda.synchronize()
    for r in range(REPEATS):
        times = {}
        t0 = time.perf_counter()
        out = register(dev, a_dev + 1e-5 * (r + 1), b, vp_a, vp_b, radii, SEED + r, times)
        out["transformation"].cpu()  # waits for the device
        dt = time.perf_counter() - t0
        r_err, t_err, finite = pose_error(out, T_gt)
        conv = bool(out["converged"])
        ok = conv and r_err < R_ERR_MAX and t_err < radii["thr"] and finite
        log(f"# repeat {r} n={N_MAIN}: {dt:.4f} s converged={conv} r_err={r_err:.5f} "
            f"t_err={t_err:.4f} corr={float(out['n_correspondences']):.0f} "
            f"inliers={int(out['inliers'])} ok={ok}")
        log("#   stages (s): " + " ".join(f"{k}={v:.4f}" for k, v in times.items()))
        assert ok, f"repeat {r} failed the bench's success rule"
    launches = [c.launches for c in counters]
    log(f"# launches in the main runs: {dict(zip([r['name'] for r in records], launches))}")
    assert all(n > 0 for n in launches), "a kernel of the path was never launched"
    for rec, n in zip(records, launches):
        rec["launches"] = n

    # small pair: the kernels' path against the plain versions' path (CPU)
    sa, sb, svp_a, svp_b, sT = scene(4096)
    sradii = derive_radii(torch.from_numpy(sa), torch.from_numpy(sb))
    gpu_out = register(dev, sa, sb, svp_a, svp_b, sradii, SEED)
    cpu_out = register(torch.device("cpu"), sa, sb, svp_a, svp_b, sradii, SEED)
    rg, tg, _ = pose_error(gpu_out, sT)
    rc, tc, _ = pose_error(cpu_out, sT)
    pairs_g = set(zip(*(x.cpu().tolist() for x in gpu_out["correspondences"][:2])))
    pairs_c = set(zip(*(x.tolist() for x in cpu_out["correspondences"][:2])))
    share = len(pairs_g & pairs_c) / max(len(pairs_c), 1)
    log(f"# small pair n=4096: kernels r_err={rg:.5f} t_err={tg:.4f}, plain r_err={rc:.5f} "
        f"t_err={tc:.4f}, shared mutual correspondences {share:.4f}")
    assert bool(gpu_out["converged"]) and bool(cpu_out["converged"])
    assert rg < R_ERR_MAX and rc < R_ERR_MAX and share >= 0.9

    # one large pair: completes with a finite pose (no reference row at this size)
    la, lb, lvp_a, lvp_b, lT = scene(N_LARGE)
    t0 = time.perf_counter()
    lradii = derive_radii(torch.from_numpy(la).to(dev), torch.from_numpy(lb).to(dev))
    log(f"# large radii ({time.perf_counter() - t0:.2f} s set-up): {lradii}")
    la_dev = torch.from_numpy(la).to(dev)
    register(dev, la_dev, lb, lvp_a, lvp_b, lradii, SEED)  # warm-up
    times = {}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    lout = register(dev, la_dev + 1e-5, lb, lvp_a, lvp_b, lradii, SEED, times)
    lout["transformation"].cpu()
    dt = time.perf_counter() - t0
    r_err, t_err, finite = pose_error(lout, lT)
    log(f"# large n={N_LARGE}: {dt:.4f} s converged={bool(lout['converged'])} "
        f"r_err={r_err:.5f} t_err={t_err:.4f} "
        f"corr={float(lout['n_correspondences']):.0f} inliers={int(lout['inliers'])} "
        f"peak_mem={torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    log("#   stages (s): " + " ".join(f"{k}={v:.4f}" for k, v in times.items()))
    assert finite, "large run: non-finite pose"

    log(f"{gpu}")
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

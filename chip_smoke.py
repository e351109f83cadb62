#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Builds the kernels of lidar_global_registration_tpu_torch/csrc from
source and drives the ported routes of `models.flagship.register_pair_staged`:

  keypoint-any (bench.py:177-190): K1, K5, K6, K7 checked against their
      plain PyTorch versions at 65,536 points (K6 also on shuffled,
      repeated and padding slots); K5 and K1 at the edges of their work
      shapes (dense cells of over 32 and 128 queries, stencil columns of 1
      to 9 points, distance ties, zero normals, slot lists of whole
      stencils, partial cells, single slots and none, a one-point plan);
      K3 and K4 at the edges of their walks (cells of 1, 1.545 and 4 radii,
      points on cell faces and corners, pairs at exactly the radius across
      a corner, K3's gates shut and open for every query, K4 on ties, on
      saliencies whose only blocker comes last, on min_neighbors above
      every count);
      K7 at the edges of its tiling (D in {1, 33, 135, 352, 512, 1960},
      nq in {1, 127, 129, 22203}, its bf16 form at D = 33 and 352,
      duplicate rows across every split of the train range, no valid row);
      the bench's 65,536-point pair, one warm-up and three timed repeats; a
      4,096-point pair through the kernels and the plain versions; the JAX
      package's one-graph entry points on the 65,536-point pair
      (register_pair_step, register_pair_two_stage and register_pair_staged
      with use_cell_fpfh=False), a warm-up and three repeats each under
      the rule; the batched-pairs API (parallel/batch.make_register_batch)
      at B = 4 on copies of that pair turned and shifted by known
      transforms, each pair torch.equal to register_pair_step and under the
      rule; K5, K6 and K7 checked at 262,144 points, then one
      262,144-point pair.  Keypoint-any SHOT (descriptor shot; bench.py with
      LGR_BENCH_DESC=shot in keypoint-any mode): the 65,536-point pair once,
      warm, K7 at D = 352 over 65,536 x 65,536 checked, a 4,096-point pair
      through the kernels and the plain versions.
  ISS (the bench's flagship row, bench.py:159-176, 194-256, 420-438):
      the box + mound pair at 10,485,760 points per side, sampled on the
      card; radii derived on the raw pair and again after the
      loader-equivalent pre-downsample, both outside the timed region;
      K2, K3, K4, K1 on the voxel surface and the K5 / K6 subset forms
      checked at the shapes of the pre-downsampled working cloud, K2-K4 on
      the classic masked route's plan (its cell holds the normal radius
      too), K1's slot-list form and the K5 / K6 subset forms at that
      route's shapes (with its fpfh stage split), K7 at D =
      33 and D = 352 on the pair's FPFH and SHOT keypoint descriptors.
      Then on that pair, pre-downsample + register_pair_staged:
        FPFH feature-scale route (the flagship row): warm-up + 3 repeats;
        the shipped SHOT regime (descriptor shot, lrf gravity; bench.py with
          LGR_BENCH_DESC=shot): warm-up + 3 repeats;
        the classic masked route (feature_scale=False), FPFH and SHOT:
          warm-up + one run each, a finite pose required;
        the unmasked route (masked_features=False), FPFH and SHOT: the
          same, after K1's, K5's and K6's full forms were checked at its
          shapes (1.12M rows) and its keypoints, normals and FPFH at the
          keypoints held against the classic route's;
        the FPFH flagship route with the GROR solver (alignment gror;
          bench.py with LGR_BENCH_ALIGN=gror): warm-up + 3 repeats.
      A 65,536-point ISS pair through the kernels and the plain versions
      (CPU), with FPFH, with SHOT and with FPFH + GROR (there also GROR on
      the card and on the CPU over one exported correspondence set).
  The staged pyramid (the reference's AUTO feature radius; bench.py with
      LGR_BENCH_ISS=1 LGR_BENCH_GRADED=1 LGR_BENCH_PYRAMID=1) on the
      range-graded scene: at 1,048,576 points a side pre-downsample +
      registration with FPFH and with the reference's default configuration
      (SHOT, gravity frames), which comes out of the port's front (Config ->
      expand_parameters -> staged_envelope), warm-up + 3 repeats each under
      the success rule, once through align_point_clouds, and the vote and
      the bucket query on the card against the CPU; at 2,097,152 points (the
      CLI phase runs the 10,485,760-point pair)
      once per descriptor, held to a finite pose, with K1 and the K5 / K6
      subset forms checked on the finest and the coarsest level's surface
      and K7 on one level's rows.  Each run prints its level ranges, matched
      window, keypoints per bucket and surface rows per level, and must
      match over at least 2 levels with no gate failed; the single
      feature-scale route runs once on each pair beside it.  A graded
      65,536-point pair through the kernels and the plain versions.
  The command line (`python -m lidar_global_registration_tpu_torch`, one
      process a command, as a user runs it, in chiprun_out/cli) on the graded
      pair written as binary PLY scans with their ground truth and
      viewpoints: at 1,048,576 points `alignment` with the reference's
      default configuration and with FPFH at the fixed feature radius that the
      printed density gives, `metric` on both caches and a `measure` test
      (n_times 3); at 10,485,760 points `alignment` with FPFH and the AUTO
      radius.  Then the host path on the 1M scans (align_point_clouds outside
      the staged envelope): one `alignment` process over a `tests:` list of
      the reference's default configuration with the combination metric (H1:
      SHOT, the AUTO radius, the host pyramid) and FPFH at the fixed radius
      with lr matching and the weighted closest-plane metric, solved by
      RANSAC and by GROR (H2), RoPS (H3), USC with ground-truth frames (H4),
      FPFH with ground-truth frames and one_sided matching (H5) and the
      default configuration with the bf16 matcher (H6, the staged pyramid);
      it must launch K2-K4, K5's full pass, K7 in both forms and K1 (H6) and
      no K1 slot list, K5 subset or K6 form, and one launch each of K2-K4,
      K2 on the r / 5 plan of a level surface, K5 and K7 (D = 33, 135, 352,
      1,960 and the bf16 form) is captured at its shape in this process and
      held against its plain version.  In the same process: the pair
      registered with an initial guess (the ground truth turned by 2 degrees
      and moved by distance_thr), GROR's own preparation followed by
      align_gror, and the hypothesis pool (the ground truth among two
      turned poses must win).  The debug side on the 1M scans, one process
      a command: `debug` of the default SHOT and the FPFH configuration,
      `debug` of H2 (the weights dump) traced with LGR_PROFILE (its ten
      longest device operations printed), and one `alignment` over a
      `keypoint`, a `compare`, a `measure` with save_features and H2 with
      save_features: every artifact of the JAX package's names, one vertex
      a preprocessed row, one CSV row a valid descriptor of its level (held
      against this process's own computation of the level), sub-voxel
      keypoints within the ISS radius, K2-K4 (and for save_features K5's
      full pass and K7) launched and no other form.  Each result row must be converged with r_err
      < 0.05 rad and t_err and overlap_rmse < distance_thr, `metric`'s
      cached inliers within 1 % of the alignment's, `measure`'s success
      rate 1; each command's step times, peak device memory and K1-K7
      launches are printed.
  The dataset tool (tools/datasets_torch.py, its main(argv, device) in
      this process, in chiprun_out/datasets): the graded 1M pair and the
      source in a third frame written as a Stanford directory (.conf of
      their poses), the source as LAS and 65,536 rows of two scans as ETH
      CSV; then stanford, las, eth, eth_gt, transform to the global frame,
      overlap of the 1M scans there, transform back, downsample on the card
      and on the CPU, overlap of the downsampled scans on the card and on
      the CPU (the same CSV), and perturb --seed, downsample
      --without-transformation and `alignment` (FPFH at the fixed radius of
      the loader's density) on the pair, held to the success rules.  The
      tool itself launches none of K1-K7.
  The bench entry (bench_torch.py, bench.py's port, as a user runs it, in a
      process of its own): its two default rows, the 65,536-point
      keypoint-any pair and the 10,485,760-point ISS pair, warm-up + 3
      repeats each under the success rule, with both CPU baselines measured
      afresh at 4,096 points; each row's timed repeats must have launched
      the kernel forms of its route and no other, and the merged flagship
      line must carry a rate for both rows and a vs_baseline.
  The ('dp', 'tp') mesh (parallel/mesh.py, parallel/batch.py): K2-K4's
      slot-list forms at each half of the 1M scan's host ISS plan and of the
      64k pair's, each equal to the full pass's rows and held against its
      plain version; then the batched pairs through
      make_register_batch(make_mesh(2, tp=2)), two ranks on this card over
      gloo (processes of this script, `--mesh-rank`), and through
      make_register_batch(make_mesh(1, tp=1)) on NCCL at world size 1, with
      ISS + FPFH + cluster matching and with keypoint-any FPFH: every pair
      torch.equal to register_pair_step and under the rule, each rank's
      counters risen for K2-K4 and K5 at its shard's rows and K7, and no
      other form; the seconds a pair of both beside the one-process loop.

Every timed repeat of the FPFH, SHOT and keypoint-any rows is held to the
bench's success rule (converged, rotation error < 0.05 rad, translation
error < distance_thr, bench.py:327).  Each route's launch counters are set
to 0 just before its runs and must all have risen after them.

The next-to-last line of standard output is a JSON object with one entry
per kernel and shape: its launches on the main path (and, as
launches_<route>, on the other routes and the CLI runs), its error against the
plain version, its time, the plain version's, the bound (bound_ms,
bound_by), the library yardstick (library_ms; K7's, null elsewhere) and
for K5 the static SASS count of its pair body; the last is
{"ok": true, "device": {...}}.  Any failure exits
non-zero without those lines.  Needs one CUDA device; JAX is never imported.
"""
from __future__ import annotations

import contextlib
import json
import re
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
N_ISS = 10485760  # the bench's flagship ISS row (bench.py:422-425)
N_ISS_SMALL = 65536
N_PYR = 1048576  # the bench's graded pyramid rows at full width
# the pyramid phase's larger pair, cut from the bench's 10,485,760 points to
# keep the whole run's time: the CLI phase registers the 10M pair that way
N_PYR_LARGE = 2097152


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


def timed_once(fn):
    """(result, device milliseconds) of one call of fn(): for the plain
    versions that take seconds, whose one result is also the one compared."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def frac_off(a, b, thr=0.5) -> float:
    """Share of the entries that differ by more than thr (0 for none)."""
    return float(((a - b).abs() > thr).float().mean()) if a.numel() else 0.0


# The least time the card could take for a kernel's work (bound_ms): the
# larger of its bytes (each input read once, each output written once) over
# the H100 SXM's 3.35 TB/s and its float32 operations over 67 TFLOP/s (no
# tensor cores).  Operations are counted from each kernel's source on this
# run's data: every stencil candidate costs a distance test (3 sub, 3 mul,
# 2 add); each pair within r and each query add what the kernel computes
# for them (rounded).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
CAND_FLOPS = 8
PAIR_FLOPS = {"surface": 16, "iss_count": 0, "iss_saliency": 17, "iss_nms": 1, "spfh": 80,
              "combine": 67}
QUERY_FLOPS = {"surface": 200, "iss_count": 0, "iss_saliency": 200, "iss_nms": 0, "spfh": 0,
               "combine": 165}


def tbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(nbytes: float, flops: float) -> dict:
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = flops / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations"}


def stencil_bound(kind: str, plan, pairs, nbytes: int, slots=None) -> dict:
    """bound() of a cell-list kernel over the sorted queries `slots` (all
    when None; padding < 0 skipped) with `pairs` pairs within r."""
    per_cell = (plan.cols[:, :, 1] - plan.cols[:, :, 0]).sum(1).double()
    cells = plan.cell_of if slots is None else plan.cell_of[slots[slots >= 0].long()]
    cand = float(per_cell[cells.long()].sum())
    flops = CAND_FLOPS * cand + PAIR_FLOPS[kind] * float(pairs) + QUERY_FLOPS[kind] * cells.numel()
    return bound(nbytes, flops)


def nn_bound(q, t, tvalid, d2, idx) -> dict:
    """bound() of K7: 2 nq nt D for the products, 4 nq nt for d2 and the argmin."""
    nq, nt = q.shape[0], t.shape[0]
    return bound(tbytes(q, t, tvalid, d2, idx), 2.0 * nq * nt * q.shape[1] + 4.0 * nq * nt)


def library_nn(q, t, tvalid, tile: int = 4096):
    """K7's yardstick: cuBLAS's float32 product with the train norms folded
    in (`torch.addmm`) and `torch.min` over it, in chunks of `tile` queries
    (|q|^2 does not move a row's argmin)."""
    import torch

    tn = torch.where(tvalid, (t * t).sum(1), 3.0e38)[None, :]
    return [torch.addmm(tn, q[s:s + tile], t.T, alpha=-2.0).min(1)
            for s in range(0, q.shape[0], tile)]


def surface_err(out_k, d_k, id_k, out_p, d_p, id_p, label: str) -> float:
    """K1's full pass against its plain version: counts and nearest ids
    exact, well-defined normals, curvature and distances to float32
    summation order; returns the largest absolute difference (normals up to
    sign)."""
    import torch

    sign = torch.where((out_k[:, :3] * out_p[:, :3]).sum(1, keepdim=True) < 0, -1.0, 1.0)
    err = torch.cat([(out_k[:, :3] * sign - out_p[:, :3]).abs().flatten(),
                     (out_k[:, 3:7] - out_p[:, 3:7]).abs().flatten(), (d_k - d_p).abs()])
    dots = (out_k[:, :3] * out_p[:, :3]).sum(1).abs()
    assert torch.equal(out_k[:, 7], out_p[:, 7]), f"{label} neighbour counts differ"
    assert torch.equal(id_k, id_p), f"{label} nearest-neighbour ids differ"
    # normals up to sign: 1e-5 where the normal is well defined (eigen gap
    # l1 - l0 >= 1e-2 l2), as in tests/test_torch_cellgrid.py
    ok = out_p[:, 7] >= 3
    well = ok & (out_p[:, 5] - out_p[:, 4] >= 1e-2 * out_p[:, 6])
    assert bool((dots[well] > 1 - 1e-5).all()), f"{label} normals: {float(dots[well].min())}"
    # curvature: the sums run in another order; l0 of a flat patch is a
    # float32 cancellation residue, so small values carry ~1e-7 absolute noise
    torch.testing.assert_close(out_k[:, 3], out_p[:, 3], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(d_k, d_p, rtol=1e-4, atol=0.0)
    return float(err.max())


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
    dots = (out_k[:, :3] * out_p[:, :3]).sum(1).abs()
    ok = out_p[:, 7] >= 3
    assert bool((dots[ok] > 0.99).all()), f"K1 normals: min |dot| {float(dots[ok].min())}"
    records.append(dict(
        name="surface", route="cuda", source="lidar_global_registration_tpu_torch/csrc/surface.cu",
        replaces="lidar_global_registration_tpu/ops/pallas/cellgrid.py:1241",
        max_abs_err=surface_err(out_k, d_k, id_k, out_p, d_p, id_p, "K1"),
        ms=cuda_ms(lambda: cg.surface_cuda(plan_n, r2n), 10),
        plain_ms=cuda_ms(lambda: cg.surface_plain(plan_n, r2n), 2),
        **stencil_bound("surface", plan_n, out_p[:, 7].sum(), tbytes(
            plan_n.pts, plan_n.cell_of, plan_n.cols, plan_n.oid, out_k, d_k, id_k)),
        library_ms=None,
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
        **stencil_bound("spfh", plan_f, c_p.sum(), tbytes(
            plan_f.pts, plan_f.nrm, plan_f.cell_of, plan_f.cols, sp_k, c_k)),
        library_ms=None,
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
        **stencil_bound("combine", plan_f, k_p.sum(), tbytes(
            plan_f.pts, plan_f.cell_of, plan_f.cols, sp_p, f_k, k_k)),
        library_ms=None,
    ))
    log(f"# K6 combine ok: frac_off={f6:.2e} max_abs_err={records[-1]['max_abs_err']:.3g}")
    # K6's slot form on unsorted, repeated and padding slots: the full
    # kernel's rows there bit for bit, zeros at the padding, counts equal to
    # the plain version's
    gen = torch.Generator().manual_seed(5)
    pick = torch.randint(0, plan_f.n_valid, (3000,), generator=gen)
    mixed = torch.cat([pick, pick[:200], torch.full((64,), -1)])
    mixed = mixed[torch.randperm(mixed.numel(), generator=gen)].to(dev)
    f_m, k_m = cg.combine_at_cuda(plan_f, r2f, sp_p, mixed)
    real = mixed >= 0
    assert torch.equal(f_m[real], f_k[mixed[real]]) and torch.equal(k_m[real], k_k[mixed[real]])
    assert not bool(f_m[~real].any()) and not bool(k_m[~real].any())
    f_mp, k_mp = cg.combine_plain(plan_f, r2f, sp_p, mixed)
    assert torch.equal(k_m, k_mp) and frac_off(f_m, f_mp) < 1e-3, "K6 mixed slots"
    log(f"# K6 slot form ok on {mixed.numel()} shuffled slots ({int((~real).sum())} padding, "
        f"200 repeats)")

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
        ms=cuda_ms(lambda: nn_l2.nn_l2_cuda(feat_s, feat_t, fv_t), 5),
        plain_ms=cuda_ms(lambda: nn_l2.nn_l2_plain(feat_s, feat_t, fv_t), 1),
        **nn_bound(feat_s, feat_t, fv_t, d2k, ik),
        library_ms=cuda_ms(lambda: library_nn(feat_s, feat_t, fv_t), 2),
    ))
    log(f"# K7 nn_l2 ok: D={feat_s.shape[1]} idx_mismatch={int((ik != ip).sum())} "
        f"max_abs_err={records[-1]['max_abs_err']:.3g}")
    return records


def check_cell_edges(dev):
    """K5 and K1 where their work shapes have edges, each against its plain
    version (counts and ids exact, K5's bins by frac_off) and against its
    full pass at the same slots (bit for bit): two dense clusters of points
    all within r of each other (cells of more than 32 and more than 128
    queries; K5's queue fills on every step), groups of 1 to 9 points alone
    in their cells (stencil columns of length 1 to 9: every tail of K1's
    walk, 4 rows at a time, and of K5's, 8 at a time, and one full group
    before a tail), an 8 x 8 grid of equal spacings (distance ties), zero
    normals on a tenth of the points, terrain; slot lists of whole
    stencils, partial cells, single slots, one slot and none; a plan of one
    point."""
    import torch

    from lidar_global_registration_tpu_torch.ops import cellgrid as cg

    rng = np.random.default_rng(17)
    r = 0.3
    r2 = cg._f32_square(r)
    parts = [rng.normal(size=(300, 3)) * 0.02 + [3.0, 3.0, 5.0],
             rng.normal(size=(60, 3)) * 0.02 + [6.0, 3.0, 5.0]]
    parts += [rng.normal(size=(k, 3)) * 0.005 + [20.0 + 1.0 * k, 0.0, 0.0] for k in range(1, 10)]
    g = np.stack(np.meshgrid(np.arange(8), np.arange(8), [0.0]), -1).reshape(-1, 3)
    parts.append(g * 0.25 + [8.0, 8.0, 0.0])
    xy = rng.uniform(0.0, 12.0, size=(4000, 2))
    parts.append(np.column_stack([xy, 0.3 * np.sin(xy[:, 0]) * np.cos(0.7 * xy[:, 1])]))
    X = torch.from_numpy(np.concatenate(parts).astype(np.float32)).to(dev)
    N = X.shape[0]
    ones = torch.ones(N, dtype=torch.bool, device=dev)
    nrm = torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32)).to(dev)
    nrm = nrm / nrm.norm(dim=1, keepdim=True)
    nrm[torch.from_numpy(rng.random(N) < 0.1).to(dev)] = 0.0
    plan = cg.set_normals(cg.plan_grid(X, ones, r), nrm)
    n = plan.n_valid
    per_cell = torch.bincount(plan.cell_of.long())
    assert int(per_cell.max()) > 128 and bool(((per_cell > 32) & (per_cell <= 128)).any())
    col_len = set((plan.cols[:, :, 1] - plan.cols[:, :, 0]).flatten().tolist())
    assert set(range(1, 10)) <= col_len, f"K1 column lengths {sorted(col_len)[:12]}"
    pick = torch.from_numpy(rng.choice(n, 60, replace=False)).to(dev)
    slot_lists = {
        "stencil": cg.stencil_slots(plan, pick),
        "partial cells": torch.nonzero(torch.from_numpy(rng.random(n) < 0.3).to(dev)).squeeze(1),
        "single slots": torch.sort(pick[:9]).values,
        "empty": torch.zeros((0,), dtype=torch.int64, device=dev),
    }
    slot_lists["one slot"] = slot_lists["single slots"][:1]
    cen = cg.aabb_centre(plan)
    s_full, c_full = cg.spfh_cuda(plan, r2, cen)
    s_p, c_p = cg.spfh_plain(plan, r2, cen)
    assert torch.equal(c_full, c_p) and frac_off(s_full, s_p) < 1e-3, "K5 edges: full pass"
    k1_full = cg.surface_cuda(plan, r2)
    k1_p = cg.surface_plain(plan, r2)
    assert torch.equal(k1_full[0][:, 7], k1_p[0][:, 7]) and torch.equal(k1_full[2], k1_p[2])
    torch.testing.assert_close(k1_full[1], k1_p[1], rtol=1e-4, atol=0.0)
    for name, sl in slot_lists.items():
        rest = torch.ones(n, dtype=torch.bool, device=dev)
        rest[sl] = False
        s_at, c_at = cg.spfh_at_cuda(plan, r2, cen, sl)
        assert torch.equal(s_at[sl], s_full[sl]) and torch.equal(c_at[sl], c_full[sl]), name
        assert not bool(s_at[rest].any()) and not bool(c_at[rest].any()), name
        s_atp, c_atp = cg.spfh_plain(plan, r2, cen, sl)
        assert torch.equal(c_at, c_atp) and frac_off(s_at[sl], s_atp[sl]) < 1e-3, name
        out, d, ids = cg.surface_at_cuda(plan, r2, sl)
        assert all(torch.equal(a[sl], b[sl]) for a, b in zip((out, d, ids), k1_full)), name
        assert not bool(out[rest].any()) and bool((ids[rest] == -1).all()), name
        o_p, _d_p, id_p = cg.surface_plain(plan, r2, sl)
        assert torch.equal(out[:, 7], o_p[:, 7]) and torch.equal(ids, id_p), name
    one = cg.set_normals(cg.plan_grid(X[:1], ones[:1], r), nrm[:1])
    c1 = cg.aabb_centre(one)
    for got, want in ((cg.surface_cuda(one, r2), cg.surface_plain(one, r2)),
                      (cg.spfh_cuda(one, r2, c1), cg.spfh_plain(one, r2, c1))):
        assert all(torch.equal(a, b) for a, b in zip(got, want)), "one-point plan"
    log(f"# K5/K1 edges ok: {n} points, cells of up to {int(per_cell.max())} queries, "
        f"{int(c_full.sum())} pairs, slot lists {[int(s.numel()) for s in slot_lists.values()]}, "
        f"one-point plan")


def pair_body_sass() -> int:
    """Static SASS instructions of K5's pair body (`pair_bins` in
    csrc/fpfh.cu), compiled alone into a probe kernel with the library's
    flags; the count includes the probe's 3 loads, its store and exit."""
    from lidar_global_registration_tpu_torch import kernels

    nvcc = kernels._nvcc()
    probe = kernels.BUILD_DIR / "pair_body_probe.cu"
    probe.write_text(
        f'#include "{kernels.CSRC / "fpfh.cu"}"\n'
        'extern "C" __global__ void pair_body_probe(const float4* in, int* out) {\n'
        '  const float4 d = in[0], qn = in[1], cn = in[2];\n'
        '  int b1 = 0, b2 = 0, b3 = 0;\n'
        '  const bool ok = pair_bins(d.x, d.y, d.z, d.w, qn, qn.w, cn, b1, b2, b3);\n'
        '  out[0] = ok ? b1 + 11 * b2 + 121 * b3 : -1;\n'
        '}\n')
    cubin = probe.with_suffix(".cubin")
    subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-cubin", "-o", str(cubin), str(probe)],
                   check=True, capture_output=True, timeout=300)
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)],
                          check=True, capture_output=True, text=True, timeout=120).stdout
    body = sass.split("Function : pair_body_probe")[1].split("Function :")[0]
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]+);", body)
    return sum(1 for op in ops if not op.strip().startswith("NOP"))


def check_nn_edges(dev):
    """K7 against its plain version where its tiling has edges: D in {1, 33,
    352, 512} and nq in {1, 127, 129, 22203} against nt = 5003 train rows
    (not a multiple of a tile or a chunk); exact duplicate rows on both sides
    of every boundary of the train split, far apart and at the ends; no
    valid train row at all."""
    import torch

    from lidar_global_registration_tpu_torch.ops import nn_l2

    rng = np.random.default_rng(11)
    nt = 5003
    for D in (1, 33, 135, 352, 512, 1960):
        t = torch.from_numpy(rng.normal(size=(nt, D)).astype(np.float32)).to(dev)
        tv = torch.from_numpy(rng.random(nt) > 0.05).to(dev)
        for nq in (1, 127, 129, 22203):
            q = torch.from_numpy(rng.normal(size=(nq, D)).astype(np.float32)).to(dev)
            d2k, ik = nn_l2.nn_l2_cuda(q, t, tv)
            d2p, ip = nn_l2.nn_l2_plain(q, t, tv)
            # plain fp32 q @ t.T sums in another order: d2 within 1e-5
            # relatively, and a different index only at a near tie
            torch.testing.assert_close(d2k, d2p, rtol=1e-5, atol=1e-5)
            diff = ik != ip
            near = (d2k - d2p).abs() <= 1e-5 * d2p.abs() + 1e-5
            assert bool(near[diff].all()), f"K7 D={D} nq={nq}: an index differs beyond a tie"
            assert bool(tv[ik.long()].all()), f"K7 D={D} nq={nq}: an invalid row won"
            if D in (33, 352):
                # the bf16 form: the kernel on rounded copies against the
                # plain product of the same rounded rows
                d2k, ik = nn_l2.nn_l2_bf16_cuda(q, t, tv)
                d2p, ip = nn_l2.nn_l2_plain(q, t, tv, bf16=True)
                torch.testing.assert_close(d2k, d2p, rtol=1e-5, atol=1e-5)
                near = (d2k - d2p).abs() <= 1e-5 * d2p.abs() + 1e-5
                assert bool(near[ik != ip].all()), f"K7 bf16 D={D} nq={nq}: index beyond a tie"
    resident = nn_l2._resident_blocks(dev, 33)
    for nq in (129, 22203):
        S, per = nn_l2.split_plan(nq, nt, resident)
        assert S > 1, (nq, S)
        t = rng.normal(size=(nt, 33)).astype(np.float32)
        q = rng.normal(size=(nq, 33)).astype(np.float32)
        cuts = [k * per * nn_l2.TILE for k in range(1, S)]
        pairs = [(0, nt - 1), (5, nt - 3)] + [(c - 1, c) for c in cuts]
        for k, (lo, hi) in enumerate(pairs):  # query k's row sits at lo and hi
            t[hi] = t[lo]
            q[k] = t[lo]
        tt = torch.from_numpy(t).to(dev)
        tv = torch.ones(nt, dtype=torch.bool, device=dev)
        d2k, ik = nn_l2.nn_l2_cuda(torch.from_numpy(q).to(dev), tt, tv)
        got = ik[:len(pairs)].tolist()
        assert got == [lo for lo, _ in pairs], f"K7 ties across the split: {got}"
        d2k, ik = nn_l2.nn_l2_cuda(torch.from_numpy(q).to(dev), tt, torch.zeros_like(tv))
        assert bool((d2k == nn_l2.BIG).all()) and not bool(ik.any()), "K7 with no valid row"
        log(f"# K7 split nq={nq}: {S} ranges of {per} tiles, lowest index at every cut")
    log("# K7 edges ok: D 1/33/135/352/512/1960 x nq 1/127/129/22203 vs plain (bf16 form at "
        "D 33/352), ties, no valid row")


def check_large(dev, a, b, radii):
    """K5's and K6's full forms and K7 at 262,144 points, the large pair's
    shapes, each against its plain version."""
    import torch

    from lidar_global_registration_tpu_torch.ops import cellgrid as cg
    from lidar_global_registration_tpu_torch.ops import nn_l2

    ones = torch.ones(a.shape[0], dtype=torch.bool, device=dev)
    rn, rf = radii["normal_cell"], radii["feature"]
    r2f = cg._f32_square(rf)
    feats = []
    for x in (a, b):
        X = torch.from_numpy(x).to(dev)
        pf = cg.set_normals(cg.plan_grid(X, ones, rf),
                            cg.surface_pass(cg.plan_grid(X, ones, rn), rn)[0])
        feats.append(cg.fpfh_pass(pf, rf))
        if len(feats) == 1:
            cen = cg.aabb_centre(pf)
            sp_k, c_k = cg.spfh_cuda(pf, r2f, cen)
            sp_p, c_p = cg.spfh_plain(pf, r2f, cen)
            f5 = frac_off(sp_k, sp_p)
            assert torch.equal(c_k, c_p) and f5 < 1e-3, f"K5 262k: {f5:.2e} off by > 0.5"
            rec5 = dict(
                name="spfh_262k", route="cuda",
                source="lidar_global_registration_tpu_torch/csrc/fpfh.cu",
                replaces="lidar_global_registration_tpu/ops/pallas/cellgrid.py:1554",
                max_abs_err=float((sp_k - sp_p).abs().max()), queries=int(pf.n_valid),
                ms=cuda_ms(lambda: cg.spfh_cuda(pf, r2f, cen), 5),
                plain_ms=cuda_ms(lambda: cg.spfh_plain(pf, r2f, cen), 1),
                **stencil_bound("spfh", pf, c_p.sum(), tbytes(
                    pf.pts, pf.nrm, pf.cell_of, pf.cols, sp_k, c_k)),
                library_ms=None)
            log(f"# K5 at {pf.n_valid} points ok: {rec5['ms']:.3f} ms, frac_off={f5:.2e}")
            f_k, k_k = cg.combine_cuda(pf, r2f, sp_k)
            f_p, k_p = cg.combine_plain(pf, r2f, sp_k)
            assert torch.equal(k_k, k_p), "K6 (262k) neighbour counts differ"
            f6 = frac_off(f_k, f_p)
            assert f6 < 1e-3 and float((f_k - f_p).abs().median()) < 1e-3, f"K6 262k: {f6:.2e}"
            rec6 = dict(
                name="combine_262k", route="cuda",
                source="lidar_global_registration_tpu_torch/csrc/fpfh.cu",
                replaces="lidar_global_registration_tpu/ops/pallas/cellgrid.py:1608",
                max_abs_err=float((f_k - f_p).abs().max()), queries=int(pf.n_valid),
                ms=cuda_ms(lambda: cg.combine_cuda(pf, r2f, sp_k), 5),
                plain_ms=cuda_ms(lambda: cg.combine_plain(pf, r2f, sp_k), 1),
                **stencil_bound("combine", pf, k_p.sum(), tbytes(
                    pf.pts, pf.cell_of, pf.cols, sp_k, f_k, k_k)),
                library_ms=None)
            log(f"# K6 at {pf.n_valid} points ok: max_abs_err={rec6['max_abs_err']:.3g}")
    (fs, _fvs), (ft, fvt) = feats
    d2k, ik = nn_l2.nn_l2_cuda(fs, ft, fvt)
    d2p, ip = nn_l2.nn_l2_plain(fs, ft, fvt)
    dk, dp = d2k.clamp_min(0).sqrt(), d2p.clamp_min(0).sqrt()
    torch.testing.assert_close(dk, dp, rtol=1e-5, atol=1e-5)
    same = (dk - dp).abs() <= 1e-6
    assert torch.equal(ik[same], ip[same]), "K7 (262k) indices differ where distances agree"
    rec7 = dict(
        name="nn_l2_262k", route="cuda", source="lidar_global_registration_tpu_torch/csrc/nn_l2.cu",
        replaces="lidar_global_registration_tpu/ops/pallas/topk_l2.py:26",
        max_abs_err=float((dk - dp).abs().max()), shape=[int(fs.shape[0]), int(ft.shape[0]), 33],
        ms=cuda_ms(lambda: nn_l2.nn_l2_cuda(fs, ft, fvt), 3),
        plain_ms=cuda_ms(lambda: nn_l2.nn_l2_plain(fs, ft, fvt), 1),
        **nn_bound(fs, ft, fvt, d2k, ik),
        library_ms=cuda_ms(lambda: library_nn(fs, ft, fvt), 1))
    log(f"# K7 at {fs.shape[0]}^2 ok: {rec7['ms']:.2f} ms, plain {rec7['plain_ms']:.2f}, "
        f"library {rec7['library_ms']:.2f}, idx_mismatch={int((ik != ip).sum())}")
    return [rec5, rec6, rec7]


def register(dev, a, b, vp_a, vp_b, radii, seed, times=None, **change):
    import torch

    from lidar_global_registration_tpu_torch.models.flagship import (
        FlagshipConfig,
        register_pair_staged,
    )

    # bench.py:238-256 in keypoint-any mode
    cfg = FlagshipConfig(rounds=8, hypothesis_batch=1024, use_iss=False, match_tile=4096,
                         metric="correspondences", **change)
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


def any_shot_phase(dev, a, b, vp_a, vp_b, T_gt, radii):
    """Keypoint-any SHOT on the bench's 65,536-point pair: K7 at D = 352 over
    65,536 x 65,536 descriptors (SHOT at every row, as the route computes
    them) against its plain version and the library yardstick; one warm-up
    and one timed run with stage times, held to a finite pose (whether the
    bench's rule holds is printed); a 4,096-point pair through the kernels
    and through the plain versions.  Returns K7's record with the launches of
    the timed 65,536-point run."""
    import torch

    from lidar_global_registration_tpu_torch.models.flagship import FlagshipConfig, _shot_stage
    from lidar_global_registration_tpu_torch.ops import cellgrid as cg
    from lidar_global_registration_tpu_torch.ops import nn_l2
    from lidar_global_registration_tpu_torch.ops.density import derive_radii
    from lidar_global_registration_tpu_torch.types import SEED

    rn, rf = radii["normal_cell"], radii["feature"]
    cfg = FlagshipConfig(use_iss=False, descriptor="shot")
    ones = torch.ones(a.shape[0], dtype=torch.bool, device=dev)
    desc = []
    for x, vp in ((a, vp_a), (b, vp_b)):
        X = torch.from_numpy(x).to(dev)
        normal = cg.surface_pass(cg.plan_grid(X, ones, rn), rn, torch.from_numpy(vp).to(dev))[0]
        desc.append(_shot_stage(X, normal, ones, X, normal, ones, rf, cfg,
                                plan=cg.plan_grid(X, ones, rf)))
    (fq, okq), (ft, okt) = desc
    d2k, ik = nn_l2.nn_l2_cuda(fq, ft, okt)
    d2p, ip = nn_l2.nn_l2_plain(fq, ft, okt)
    # as K7's D = 352 row on the ISS keypoints: equal indices, or a d2 within
    # 1e-6 relatively where they differ (a near tie)
    diff = ik != ip
    near = (d2k - d2p).abs() <= 1e-6 * d2p.abs().clamp_min(1e-30)
    assert bool(near[diff].all()), "K7 D=352 (64k): an index differs beyond a near tie"
    torch.testing.assert_close(d2k, d2p, rtol=1e-5, atol=1e-6)
    rec = dict(
        name="nn_l2_d352_64k", route="cuda",
        source="lidar_global_registration_tpu_torch/csrc/nn_l2.cu",
        replaces="lidar_global_registration_tpu/ops/pallas/topk_l2.py:26",
        max_abs_err=float((d2k - d2p).abs().max()), idx_mismatch=int(diff.sum()),
        shape=[int(fq.shape[0]), int(ft.shape[0]), int(fq.shape[1])],
        ms=cuda_ms(lambda: nn_l2.nn_l2_cuda(fq, ft, okt), 2),
        plain_ms=cuda_ms(lambda: nn_l2.nn_l2_plain(fq, ft, okt), 1),
        **nn_bound(fq, ft, okt, d2k, ik),
        library_ms=cuda_ms(lambda: library_nn(fq, ft, okt), 1))
    log(f"# K7 D=352 at {fq.shape[0]}^2 ok: {rec['ms']:.2f} ms, plain {rec['plain_ms']:.2f}, "
        f"library {rec['library_ms']:.2f}, {int(diff.sum())} index differences (near ties), "
        f"{int(okq.sum())}/{int(okt.sum())} valid descriptors")
    del desc, fq, ft, d2k, d2p

    counters = (cg.surface_cuda, nn_l2.nn_l2_cuda)
    a_dev = torch.from_numpy(a).to(dev)
    register(dev, a_dev, b, vp_a, vp_b, radii, SEED, descriptor="shot")  # warm-up
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    times = {}
    t0 = time.perf_counter()
    out = register(dev, a_dev + 1e-5, b, vp_a, vp_b, radii, SEED, times, descriptor="shot")
    out["transformation"].cpu()
    dt = time.perf_counter() - t0
    r_err, t_err, finite = pose_error(out, T_gt)
    conv = bool(out["converged"])
    ok = conv and r_err < R_ERR_MAX and t_err < radii["thr"] and finite
    log(f"# any-SHOT n={a.shape[0]}: {dt:.4f} s converged={conv} r_err={r_err:.5f} "
        f"t_err={t_err:.4f} corr={float(out['n_correspondences']):.0f} "
        f"inliers={int(out['inliers'])} bench rule holds={ok} "
        f"peak_mem={torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    log("#   stages (s): " + " ".join(f"{k}={v:.4f}" for k, v in times.items()))
    assert finite, "any-SHOT: non-finite pose"
    launches = {c.__name__: c.launches for c in counters}
    log(f"# launches in the any-SHOT run: {launches}")
    assert all(n > 0 for n in launches.values()), "a kernel of the any-SHOT path was never launched"
    rec["launches"] = launches["nn_l2_cuda"]

    sa, sb, svp_a, svp_b, sT = scene(4096)
    sradii = derive_radii(torch.from_numpy(sa), torch.from_numpy(sb))
    gpu_out = register(dev, sa, sb, svp_a, svp_b, sradii, SEED, descriptor="shot")
    cpu_out = register(torch.device("cpu"), sa, sb, svp_a, svp_b, sradii, SEED,
                       descriptor="shot")
    (rg, tg, fg), (rc, tc, fc) = pose_error(gpu_out, sT), pose_error(cpu_out, sT)
    share = shared_share(gpu_out, cpu_out)
    log(f"# small any-SHOT pair n=4096: kernels r_err={rg:.5f} t_err={tg:.4f} "
        f"converged={bool(gpu_out['converged'])}, plain r_err={rc:.5f} t_err={tc:.4f} "
        f"converged={bool(cpu_out['converged'])}, shared mutual correspondences {share:.4f}")
    # the two paths share K1's normals up to float32 summation order, which
    # orient the gravity frames; a near-tied descriptor 1-NN may flip
    assert fg and fc and share >= 0.9, share
    assert bool(gpu_out["converged"]) == bool(cpu_out["converged"])
    return rec


def pose_error(out, T_gt):
    import torch

    from lidar_global_registration_tpu_torch.ops.transform import rotation_translation_error

    T = out["transformation"].cpu()
    r, t = rotation_translation_error(T, torch.from_numpy(T_gt))
    return float(r), float(t), bool(torch.isfinite(T).all())


def shared_share(gpu_out, cpu_out) -> float:
    """Share of the plain path's correspondences that the kernels' path has."""
    def pairs(out):
        rows, match, _thr, ok = (x.cpu() for x in out["correspondences"])
        return set(zip(rows[ok].tolist(), match[ok].tolist()))

    pc = pairs(cpu_out)
    return len(pairs(gpu_out) & pc) / max(len(pc), 1)


RADII_KEYS = ("normal_cell", "density_src", "density_tgt", "iss_src", "iss_tgt", "feature",
              "thr")


def iss_cfg(**change):
    from lidar_global_registration_tpu_torch.models.flagship import FlagshipConfig

    # bench.py:238-256 in ISS mode (LGR_BENCH_DESC=shot sets the shipped
    # SHOT regime); the other fields are the JAX defaults
    return FlagshipConfig(**{**dict(rounds=64, hypothesis_batch=1024, use_iss=True,
                                    match_tile=4096, metric="uniformity"), **change})


SHOT_CFG = dict(descriptor="shot", lrf="gravity")


def iss_scene(n: int, dev, graded: bool = False):
    """The bench's ISS pair: the box + mound scene on 30 x sqrt(n / 2^20) m
    (bench.py:168-176), sampled on `dev` from the scene's patch tables;
    graded: with the range falloff of LGR_BENCH_GRADED=1."""
    from __graft_entry__ import _scene_tables

    from lidar_global_registration_tpu_torch.scene import scene_pair
    from lidar_global_registration_tpu_torch.types import SEED

    extent = 30.0 * max(1.0, float(np.sqrt(n / 2**20)))
    return scene_pair(_scene_tables(SEED, extent=extent), n, extent, SEED, dev, graded=graded)


def saliency_err(got, want, r2: float, label: str, well=None):
    """K3 against its plain version: neighbour counts exact; the weighted
    scatter's smallest eigenvalue is a float32 cancellation residue of sums
    taken in another order (thread registers against vectorised
    reductions): bounded at 1e-3 relatively plus 1e-5 of r^2 absolutely;
    the gamma decisions may flip only where a ratio sits within rounding of
    its gate or l3 of 0 (at most 1e-3 of the queries `well`, all when None).
    Returns (largest absolute saliency difference, flips)."""
    import torch

    (s_k, ok_k, nb_k), (s_p, ok_p, nb_p) = got, want
    assert torch.equal(nb_k, nb_p), f"{label}: K3 neighbour counts differ"
    flip = ok_k != ok_p
    flips = int((flip if well is None else flip & well).sum())
    both = ok_k & ok_p
    err = (s_k - s_p).abs()[both]
    bad = int((err > 1e-3 * s_p.abs()[both] + 1e-5 * r2).sum())
    assert bad == 0 and flips <= 1e-3 * s_k.numel(), \
        f"{label}: K3 {bad} saliencies off, {flips} gate flips"
    return (float(err.max()) if err.numel() else 0.0), flips


def iss_records(plan, r_iss: float, suffix: str = ""):
    """K2, K3 and K4 on one plan of a working cloud, each against its plain
    version; the record names end in `suffix`."""
    import torch

    from lidar_global_registration_tpu_torch.ops import cellgrid as cg

    src = "lidar_global_registration_tpu_torch/csrc/"
    pallas = "lidar_global_registration_tpu/ops/pallas/cellgrid.py:"
    records = []
    r2 = cg._f32_square(r_iss)
    n = plan.n_valid
    # the candidates of the 27-cell stencil (bound_ms counts them all; K2
    # and K3 test them all) and those in the columns that K4's walk keeps (it
    # ends a query at its first blocking neighbour, so it tests fewer still)
    lens = (plan.cols[..., 1] - plan.cols[..., 0])[plan.cell_of.long()]
    stencil = int(lens.sum())
    kept = int((lens * cg.near_columns(plan, r2)).sum())
    # K2: integer counts, exact; the reciprocal weights are the same IEEE
    # float32 quotient in the kernel and in PyTorch, bit for bit
    (c_k, inv_k), (c_p, inv_p) = cg.iss_count_cuda(plan, r2), cg.iss_count_plain(plan, r2)
    assert torch.equal(c_k, c_p), "K2 counts differ"
    assert torch.equal(inv_k, inv_p), "K2 reciprocal weights differ"
    records.append(dict(
        name="iss_count" + suffix, route="cuda", source=src + "iss.cu",
        replaces=pallas + "1322",
        max_abs_err=max(float((c_k - c_p).abs().max()), float((inv_k - inv_p).abs().max())),
        ms=cuda_ms(lambda: cg.iss_count_cuda(plan, r2), 5),
        plain_ms=cuda_ms(lambda: cg.iss_count_plain(plan, r2), 1),
        **stencil_bound("iss_count", plan, c_p.sum(), tbytes(
            plan.pts, plan.cell_of, plan.cols, c_k, inv_k)), library_ms=None))
    log(f"# K2 iss_count{suffix} ok: n={n} r={r_iss:.4f} cell={plan.cell:.4f} "
        f"mean count {float(c_p.float().mean()):.1f}, inv bit-equal")
    s_k, ok_k, nb_k = cg.iss_saliency_cuda(plan, r2, inv_p, 0.975, 0.975)
    s_p, ok_p, nb_p = cg.iss_saliency_plain(plan, r2, inv_p, 0.975, 0.975)
    err, flips = saliency_err((s_k, ok_k, nb_k), (s_p, ok_p, nb_p), r2, "iss_saliency" + suffix)
    records.append(dict(
        name="iss_saliency" + suffix, route="cuda", source=src + "iss.cu",
        replaces=pallas + "1344", max_abs_err=err, ok_flips=flips, stencil_candidates=stencil,
        ms=cuda_ms(lambda: cg.iss_saliency_cuda(plan, r2, inv_p, 0.975, 0.975), 5),
        plain_ms=cuda_ms(lambda: cg.iss_saliency_plain(plan, r2, inv_p, 0.975, 0.975), 1),
        **stencil_bound("iss_saliency", plan, nb_p.sum(), tbytes(
            plan.pts, plan.cell_of, plan.cols, inv_p, s_k, ok_k, nb_k)), library_ms=None))
    log(f"# K3 iss_saliency{suffix} ok: {int(ok_p.sum())} of {n} pass the gates, {flips} flips, "
        f"max_abs_err={err:.3g}; {stencil} stencil candidates")
    # K4 on one saliency input: any difference is the kernel's own
    kp_k = cg.iss_nms_cuda(plan, r2, s_p, ok_p, 4)
    kp_p = cg.iss_nms_plain(plan, r2, s_p, ok_p, 4)
    assert torch.equal(kp_k, kp_p), "K4 keypoint masks differ"
    records.append(dict(
        name="iss_nms" + suffix, route="cuda", source=src + "iss.cu", replaces=pallas + "1410",
        max_abs_err=float((kp_k != kp_p).sum()), queries_ok=int(ok_p.sum()),
        stencil_candidates=stencil, kept_candidates=kept,
        ms=cuda_ms(lambda: cg.iss_nms_cuda(plan, r2, s_p, ok_p, 4), 5),
        plain_ms=cuda_ms(lambda: cg.iss_nms_plain(plan, r2, s_p, ok_p, 4), 1),
        **stencil_bound("iss_nms", plan, nb_p.sum(), tbytes(
            plan.pts, plan.cell_of, plan.cols, s_p, ok_p, kp_k)), library_ms=None))
    log(f"# K4 iss_nms{suffix} ok: {int(kp_p.sum())} keypoints; its walk keeps {kept} of "
        f"{stencil} stencil candidates")
    return records


def check_iss_edges(dev):
    """K3 and K4 where their walks have edges (K4 leaves out stencil columns
    beyond the radius, ends a query at its first blocking neighbour and lets
    the warp finish its last open queries together), each against its plain
    version (neighbour counts and keypoint masks exact, saliencies within
    saliency_err's bounds), on plans whose cell is r, 1.545 r and 4 r:
    points on the faces, edges and corners of their cells, pairs at exactly
    d2 == r2 across a cell corner, groups of 1 to 10 points alone in their
    cells (stencil columns of 0 to 10 rows), terrain; K3's gates shut for
    every query, open for every query, and as shipped; K4 on saliencies
    with exact ties, rising and falling with the slot, with the only
    blocker the last neighbour it visits, with min_neighbors above every
    count; a one-point plan."""
    import torch

    from lidar_global_registration_tpu_torch.ops import cellgrid as cg

    rng = np.random.default_rng(23)
    r = 0.625  # 5/8: the offset (3/8, 4/8, 0) has float32 d2 == r2 exactly
    r2 = cg._f32_square(r)
    assert r2 == 0.390625
    skipped = []
    for cell_over_r in (1.0, 1.545, 4.0):
        cell = r * cell_over_r
        w = cell * (1.0 + cg._CELL_MARGIN)  # the plan's faces: (k + 1/2) w above the lowest point
        k = rng.integers(0, 6, (2500, 3))
        faces = np.where(rng.random((2500, 3)) < 0.5, (k + 0.5) * w,
                         rng.uniform(0, 6 * w, (2500, 3))) * [1, 1, 0.3]
        faces[0] = 0.0
        a = rng.integers(0, 6 * 1024, (700, 3)) / 1024.0 * [1, 1, 0.1] + [0, 16, 0]
        xy = rng.uniform(0.0, 10.0, size=(2500, 2))
        terrain = np.column_stack([xy + [16, 0], 0.3 * np.sin(xy[:, 0]) * np.cos(0.7 * xy[:, 1])
                                   + rng.normal(size=2500) * 0.01])
        parts = [faces, a, a + [0.375, 0.5, 0.0], terrain]
        parts += [rng.normal(size=(g, 3)) * 0.01 + [(round(40.0 / w) + 3 * g) * w, 0.0, 0.0]
                  for g in range(1, 11)]  # each group at the middle of a cell in x and y
        X = torch.from_numpy(np.concatenate(parts).astype(np.float32)).to(dev)
        plan = cg.plan_grid(X, torch.ones(X.shape[0], dtype=torch.bool, device=dev), cell)
        n = plan.n_valid
        col_len = set((plan.cols[:, :, 1] - plan.cols[:, :, 0]).flatten().tolist())
        assert set(range(0, 11)) <= col_len, f"column lengths {sorted(col_len)[:14]}"
        keep = cg.near_columns(plan, r2)
        skipped.append(1.0 - float(keep.float().mean()))
        count, inv = cg.iss_count_plain(plan, r2)
        c_k, inv_k = cg.iss_count_cuda(plan, r2)
        assert torch.equal(c_k, count) and torch.equal(inv_k, inv), \
            f"K2 edges: cell {cell_over_r} r"
        assert int(count.min()) >= 1  # every query counts itself
        for g21, g32, expect in ((0.975, 0.975, None), (1e9, 1e9, True), (0.0, 0.0, False)):
            got = cg.iss_saliency_cuda(plan, r2, inv, g21, g32)
            want = cg.iss_saliency_plain(plan, r2, inv, g21, g32)
            # thin or flat neighbourhoods (under 4 neighbours; points snapped
            # to one face) have l3 = 0 up to rounding, and `l3 > 0` is a coin:
            # a flip counts where the side that passed has l3 above the
            # saliency's absolute bound
            well = (want[2] >= 4) & (torch.maximum(got[0], want[0]) > 1e-5 * r2)
            saliency_err(got, want, r2, f"edges cell {cell_over_r} r gates {g21}", well)
            if expect is False:
                assert not bool(got[1].any()) and not bool(got[0].any())
            if expect is True:
                dense = want[2] >= 8
                assert bool(got[1][dense].float().mean() > 0.99)
            if expect is not False:
                sal, okq = want[0], want[1]
                assert torch.equal(cg.iss_nms_cuda(plan, r2, sal, okq, 4),
                                   cg.iss_nms_plain(plan, r2, sal, okq, 4))
        ties = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)).to(dev)
        ties[:7 * (n // 7):7] = ties[1:7 * (n // 7):7]  # exact ties must not survive
        some = torch.from_numpy(rng.random(n) < 0.8).to(dev)
        every = torch.ones_like(some)
        rising = torch.arange(n, dtype=torch.float32, device=dev)
        # a saliency whose only blocker, for many of 1 % of the queries, is
        # the last neighbour K4 visits (its own column first, then the four
        # beside it, then the corners): the picked queries at 1, their last
        # neighbours at 2, everything else at 0
        ids, okc = cg.candidates(plan, 0, n)
        d2 = cg._pair_d2(plan, torch.arange(n, device=dev), ids)[3]
        hit = okc & (d2 > 0) & (d2 <= r2)
        cols = plan.cols[plan.cell_of.long()].long()
        pos = torch.arange(ids.shape[1], device=dev)[None, :].expand_as(ids).contiguous()
        col = torch.searchsorted((cols[..., 1] - cols[..., 0]).cumsum(1), pos,
                                 right=True).clamp_max(8)
        rank = torch.tensor([5, 1, 6, 2, 0, 3, 7, 4, 8], device=dev)  # visit rank of a column
        when = torch.where(hit, rank[col] * ids.shape[1] + pos, -1)  # visit time of a hit
        last_nb = ids.gather(1, when.argmax(1, keepdim=True)).squeeze(1)
        picked = torch.from_numpy(rng.random(n) < 0.01).to(dev) & hit.any(1)
        late = torch.zeros(n, device=dev)
        late[picked] = 1.0
        late[last_nb[picked]] = 2.0
        blocks = hit & (late[ids] >= late[:, None])
        only_last = picked & (late == 1.0) & (blocks.sum(1) == 1) \
            & (blocks & (when == when.amax(1, keepdim=True))).any(1)
        assert int(only_last.sum()) >= 10, int(only_last.sum())
        n_kp = []
        for sal, okq, min_nb in ((ties, some, 4), (ties, every, 0), (rising, every, 4),
                                 (-rising, every, 4), (ties, every, 10**6),
                                 (ties, torch.zeros_like(some), 4), (late, every, 0)):
            got = cg.iss_nms_cuda(plan, r2, sal, okq, min_nb)
            assert torch.equal(got, cg.iss_nms_plain(plan, r2, sal, okq, min_nb)), \
                f"K4 edges: cell {cell_over_r} r, min_neighbors {min_nb}"
            n_kp.append(int(got.sum()))
        assert n_kp[0] > 10 and n_kp[2] > 0 and n_kp[4] == 0 and n_kp[5] == 0, n_kp
        assert not bool(got[only_last].any())
        log(f"# K3/K4 edges ok at cell = {cell_over_r} r: {n} points, the walk leaves out "
            f"{skipped[-1]:.3f} of the columns, keypoints {n_kp}, "
            f"{int(only_last.sum())} queries blocked by the last neighbour visited only")
    assert skipped[0] > 0.02 and skipped[1] > 0.2 and skipped[2] > 0.5, skipped
    X1 = torch.tensor([[1.0, 2.0, 3.0]], device=dev)
    one = cg.plan_grid(X1, torch.ones(1, dtype=torch.bool, device=dev), r)
    c1, inv1 = cg.iss_count_cuda(one, r2)
    assert c1.tolist() == [1] and inv1.tolist() == [1.0], "one-point plan: K2"
    got = cg.iss_saliency_cuda(one, r2, inv1, 0.975, 0.975)
    want = cg.iss_saliency_plain(one, r2, inv1, 0.975, 0.975)
    assert all(torch.equal(a, b) for a, b in zip(got, want)), "one-point plan: K3"
    assert torch.equal(cg.iss_nms_cuda(one, r2, got[0], torch.ones_like(got[1]), 0),
                       cg.iss_nms_plain(one, r2, got[0], torch.ones_like(got[1]), 0))
    log("# K3/K4 edges ok: one-point plan")


def check_iss_kernels(sx, sv, radii):
    """K2, K3, K4 on the pre-downsampled working cloud of one side and K1
    and the K5 / K6 subset forms on its feature-scale surface (the shapes
    of the ISS route), each against its plain version."""
    import torch

    from lidar_global_registration_tpu_torch.ops import cellgrid as cg

    r_iss = radii["iss_src"]
    plan = cg.plan_grid(sx, sv, r_iss)
    records = iss_records(plan, r_iss)
    kp, _sal = cg.iss_pass(plan, r_iss)
    rows = torch.nonzero(kp).squeeze(1)
    return records + surface_records(sx, sv, rows, torch.ones_like(rows, dtype=torch.bool),
                                     radii["feature"], ("surface_fs", "spfh_at", "combine_at"))


def surface_records(sx, sv, rows, in_level, rf: float, names):
    """K1 on the voxel surface of the working cloud (sx, sv) for the feature
    radius rf (voxel sqrt(pi rf^2 / 352), normals at sqrt(30 / pi) voxels)
    and the K5 `kp` / K6 `kp_rows` forms there, each against its plain
    version: the combine at the surface rows of the keypoints `rows` (input
    rows of sx), SPFH around those `in_level` (all on the feature-scale
    route; on a pyramid level those whose bucket is at most the level).
    names: the three records' names."""
    import math

    import torch

    from lidar_global_registration_tpu_torch.ops import cellgrid as cg
    from lidar_global_registration_tpu_torch.ops.downsample import voxel_centroids_map
    from lidar_global_registration_tpu_torch.types import FEATURE_NR_POINTS, NORMAL_NR_POINTS

    src = "lidar_global_registration_tpu_torch/csrc/"
    pallas = "lidar_global_registration_tpu/ops/pallas/cellgrid.py:"
    records = []

    def plain(fn):
        fn()  # warm-up; the timed call's result is the one compared
        return timed_once(fn)

    voxel_f = math.sqrt(math.pi * rf**2 / FEATURE_NR_POINTS)
    normal_f = math.sqrt(NORMAL_NR_POINTS / math.pi) * voxel_f
    sm, smv, row_of, _n_sm = voxel_centroids_map(sx, sv, voxel_f)
    # K1's full pass on the voxel surface at normal_f
    pns = cg.plan_grid(sm, smv, normal_f)
    r2s = cg._f32_square(normal_f)
    k1 = cg.surface_cuda(pns, r2s)
    k1_p, k1_plain_ms = plain(lambda: cg.surface_plain(pns, r2s))
    records.append(dict(
        name=names[0], route="cuda", source=src + "surface.cu", replaces=pallas + "1241",
        max_abs_err=surface_err(*k1, *k1_p, f"K1 ({names[0]})"), queries=int(pns.n_valid),
        ms=cuda_ms(lambda: cg.surface_cuda(pns, r2s), 10), plain_ms=k1_plain_ms,
        **stencil_bound("surface", pns, k1_p[0][:, 7].sum(), tbytes(
            pns.pts, pns.cell_of, pns.cols, pns.oid, *k1)), library_ms=None))
    log(f"# K1 {names[0]} ok: {pns.n_valid} surface rows (voxel {voxel_f:.4f}), "
        f"{records[-1]['ms']:.4f} ms")
    normal = cg.surface_pass(pns, normal_f)[0]
    pf = cg.set_normals(cg.plan_grid(sm, smv, rf), normal)
    r2f = cg._f32_square(rf)
    cen = cg.aabb_centre(pf)
    N = sm.shape[0]
    rows_small = torch.cat([row_of[rows], torch.full((5,), N, device=sm.device)])  # padding
    kp_small = torch.zeros((N,), dtype=torch.bool, device=sm.device)
    kp_small[row_of[rows[in_level]]] = True
    slots = cg.stencil_slots(pf, torch.nonzero(kp_small[pf.order[:pf.n_valid]]).squeeze(1))
    # K5 subset: the same kernel over the keypoints' stencil, so its rows
    # equal the full pass's exactly; against the plain subset, the pair
    # counts are equal and only bin-edge pairs may move (atan2f)
    s_full, c_full = cg.spfh_cuda(pf, r2f, cen)
    s_at, c_at = cg.spfh_at_cuda(pf, r2f, cen, slots)
    assert torch.equal(c_at[slots], c_full[slots]), "K5 subset counts differ from K5"
    assert torch.equal(s_at[slots], s_full[slots]), "K5 subset rows differ from K5"
    (s_at_p, c_at_p), k5_plain_ms = plain(lambda: cg.spfh_plain(pf, r2f, cen, slots))
    assert torch.equal(c_at, c_at_p), "K5 subset counts differ from the plain version"
    f5 = frac_off(s_at[slots], s_at_p[slots])
    assert f5 < 1e-3, f"K5 subset ({names[1]}): {f5:.2e} off by > 0.5"
    records.append(dict(
        name=names[1], route="cuda", source=src + "fpfh.cu", replaces=pallas + "1554",
        max_abs_err=float((s_at - s_at_p).abs().max()), queries=int(slots.numel()),
        ms=cuda_ms(lambda: cg.spfh_at_cuda(pf, r2f, cen, slots), 5), plain_ms=k5_plain_ms,
        **stencil_bound("spfh", pf, c_at[slots].sum(), tbytes(
            pf.pts, pf.nrm, pf.cell_of, pf.cols, slots) + slots.numel() * 4 * 34, slots),
        library_ms=None))
    log(f"# K5 {names[1]} ok: {slots.numel()} of {pf.n_valid} surface points, "
        f"frac_off={f5:.2e}, {records[-1]['ms']:.4f} ms")
    # K6 at kp_rows against the full K6 gathered there (exact), and against
    # its plain version on the same SPFH input
    inv = cg.slot_of(pf)
    srt = torch.where(rows_small < N, inv[rows_small.clamp_max(N - 1)], -1)
    f_at, k_at = cg.combine_at_cuda(pf, r2f, s_full, srt)
    f_full, k_full = cg.combine_cuda(pf, r2f, s_full)
    real = srt >= 0
    assert torch.equal(f_at[real], f_full[srt[real]]), "K6 kp_rows differ from K6"
    assert torch.equal(k_at[real], k_full[srt[real]]) and not bool(k_at[~real].any())
    (f_at_p, k_at_p), k6_plain_ms = plain(lambda: cg.combine_plain(pf, r2f, s_full, srt))
    assert torch.equal(k_at, k_at_p), "K6 kp_rows counts differ from the plain version"
    f6 = frac_off(f_at, f_at_p)
    assert f6 < 1e-3, f"K6 kp_rows ({names[2]}): {f6:.2e} off by > 0.5"
    records.append(dict(
        name=names[2], route="cuda", source=src + "fpfh.cu", replaces=pallas + "1608",
        max_abs_err=float((f_at - f_at_p).abs().max()), queries=int(srt.numel()),
        ms=cuda_ms(lambda: cg.combine_at_cuda(pf, r2f, s_full, srt), 5), plain_ms=k6_plain_ms,
        **stencil_bound("combine", pf, k_at.sum(), tbytes(
            pf.pts, pf.cell_of, pf.cols, s_full, srt, f_at, k_at), srt), library_ms=None))
    log(f"# K6 {names[2]} ok: {int(real.sum())} rows, "
        f"max_abs_err={records[-1]['max_abs_err']:.3g}, {records[-1]['ms']:.4f} ms")
    return records


def check_shot_kernels(S):
    """K1's slot-list form on the classic masked route's working cloud (its
    need slots around the ISS keypoints) and K7 at D = 33 and D = 352 on the
    FPFH and SHOT descriptors of the 10M pair's keypoints, each against its
    plain version."""
    import math

    import torch

    from lidar_global_registration_tpu_torch.ops import cellgrid as cg
    from lidar_global_registration_tpu_torch.ops import nn_l2
    from lidar_global_registration_tpu_torch.ops.downsample import voxel_centroids_map
    from lidar_global_registration_tpu_torch.ops.lrf import gravity_lrf
    from lidar_global_registration_tpu_torch.ops.shot import shot
    from lidar_global_registration_tpu_torch.types import FEATURE_NR_POINTS, NORMAL_NR_POINTS

    src = "lidar_global_registration_tpu_torch/csrc/"
    radii = S["radii"]
    rn, rf = radii["normal_cell"], radii["feature"]
    records = []
    # K1 slot form: the classic route's plans of the source working cloud
    sx, sv = S["sx"], S["sv"]
    r_iss = radii["iss_src"]
    pn = cg.plan_grid(sx, sv, max(rn, r_iss))
    pf = cg.plan_grid(sx, sv, rf)
    # K2-K4 on that route's plan: its cell holds the normal radius too
    records += iss_records(pn, r_iss, "_pn")
    kp, _sal = cg.iss_pass(pn, r_iss)
    need = cg.point_need(pf, kp, 2)
    slots = cg.stencil_slots(pn, torch.nonzero(need[pn.order[:pn.n_valid]]).squeeze(1))
    r2n = cg._f32_square(rn)
    out_k, d_k, id_k = cg.surface_at_cuda(pn, r2n, slots)
    out_f, d_f, id_f = cg.surface_cuda(pn, r2n)
    # the slot form is the same thread code at the listed slots: equal to
    # the full kernel there, and untouched elsewhere
    assert torch.equal(out_k[slots], out_f[slots]) and torch.equal(id_k[slots], id_f[slots])
    rest = torch.ones(pn.n_valid, dtype=torch.bool, device=sx.device)
    rest[slots] = False
    assert not bool(out_k[rest].any()) and bool((id_k[rest] == -1).all())
    out_p, d_p, id_p = cg.surface_plain(pn, r2n, slots)
    assert torch.equal(out_k[:, 7], out_p[:, 7]), "K1 slot form: neighbour counts differ"
    assert torch.equal(id_k, id_p), "K1 slot form: nearest-neighbour ids differ"
    # tolerances of the K1 check above (normals up to sign where the eigen
    # gap is clear, curvature and distances to float32 summation order)
    o_k, o_p = out_k[slots], out_p[slots]
    dots = (o_k[:, :3] * o_p[:, :3]).sum(1).abs()
    ok = o_p[:, 7] >= 3
    well = ok & (o_p[:, 5] - o_p[:, 4] >= 1e-2 * o_p[:, 6])
    assert bool((dots[well] > 1 - 1e-5).all()), f"K1 slot normals: {float(dots[well].min())}"
    torch.testing.assert_close(o_k[:, 3], o_p[:, 3], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(d_k, d_p, rtol=1e-4, atol=0.0)
    sign = torch.where((o_k[:, :3] * o_p[:, :3]).sum(1, keepdim=True) < 0, -1.0, 1.0)
    err = torch.cat([(o_k[:, :3] * sign - o_p[:, :3]).abs().flatten(),
                     (o_k[:, 3:7] - o_p[:, 3:7]).abs().flatten(), (d_k - d_p).abs()])
    records.append(dict(
        name="surface_at", route="cuda", source=src + "surface.cu",
        replaces="lidar_global_registration_tpu/ops/pallas/cellgrid.py:1241",
        max_abs_err=float(err.max()), queries=int(slots.numel()),
        ms=cuda_ms(lambda: cg.surface_at_cuda(pn, r2n, slots), 10),
        plain_ms=cuda_ms(lambda: cg.surface_plain(pn, r2n, slots), 1),
        **stencil_bound("surface", pn, o_p[:, 7].sum(), tbytes(
            pn.pts, pn.cell_of, pn.cols, pn.oid, slots) + slots.numel() * 4 * 10, slots),
        library_ms=None))
    log(f"# K1 slot form ok: {slots.numel()} of {pn.n_valid} working points "
        f"({int(need.sum())} needed, {int(kp.sum())} keypoints), "
        f"max_abs_err={records[-1]['max_abs_err']:.3g}")

    # K7 at D = 352: SHOT of each side's ISS keypoints on its feature-scale
    # surface, as the shipped regime computes them
    voxel_f = math.sqrt(math.pi * rf**2 / FEATURE_NR_POINTS)
    normal_f = math.sqrt(NORMAL_NR_POINTS / math.pi) * voxel_f
    desc, fpfh = [], []
    for x, v, r_i, vp in ((sx, sv, radii["iss_src"], S["vp_a"]),
                          (S["tx"], S["tv"], radii["iss_tgt"], S["vp_b"])):
        kp_i, _ = cg.iss_pass(cg.plan_grid(x, v, r_i), r_i)
        sm, smv, row_of, _n = voxel_centroids_map(x, v, voxel_f)
        normal = cg.surface_pass(cg.plan_grid(sm, smv, normal_f), normal_f, vp)[0]
        rows = torch.nonzero(kp_i).squeeze(1)
        frames, fb = gravity_lrf(normal[row_of[rows]])
        ones = torch.ones(rows.shape[0], dtype=torch.bool, device=x.device)
        desc.append(shot(x[rows], ones, sm, normal, smv, rf, frames=frames, fallback_mask=fb))
        # and FPFH at the same keypoints, as the flagship route computes it
        kp_sm = torch.zeros((sm.shape[0],), dtype=torch.bool, device=x.device)
        kp_sm[row_of[rows]] = True
        fpfh.append(cg.fpfh_pass(cg.set_normals(cg.plan_grid(sm, smv, rf), normal), rf,
                                 kp=kp_sm, kp_rows=row_of[rows]))
    (fs, _fvs), (ft33, fv33) = fpfh
    d2k, ik = nn_l2.nn_l2_cuda(fs, ft33, fv33)
    d2p, ip = nn_l2.nn_l2_plain(fs, ft33, fv33)
    dk, dp = d2k.clamp_min(0).sqrt(), d2p.clamp_min(0).sqrt()
    torch.testing.assert_close(dk, dp, rtol=1e-5, atol=1e-5)
    same = (dk - dp).abs() <= 1e-6
    assert torch.equal(ik[same], ip[same]), "K7 (ISS FPFH) indices differ where distances agree"
    records.append(dict(
        name="nn_l2_iss", route="cuda", source=src + "nn_l2.cu",
        replaces="lidar_global_registration_tpu/ops/pallas/topk_l2.py:26",
        max_abs_err=float((dk - dp).abs().max()), idx_mismatch=int((ik != ip).sum()),
        shape=[int(fs.shape[0]), int(ft33.shape[0]), 33],
        ms=cuda_ms(lambda: nn_l2.nn_l2_cuda(fs, ft33, fv33), 10),
        plain_ms=cuda_ms(lambda: nn_l2.nn_l2_plain(fs, ft33, fv33), 2),
        **nn_bound(fs, ft33, fv33, d2k, ik),
        library_ms=cuda_ms(lambda: library_nn(fs, ft33, fv33), 2)))
    log(f"# K7 D=33 ok: {fs.shape[0]} x {ft33.shape[0]} keypoint FPFH rows, "
        f"max_abs_err={records[-1]['max_abs_err']:.3g}")
    (fq, _okq), (ft, okt) = desc
    d2k, ik = nn_l2.nn_l2_cuda(fq, ft, okt)
    d2p, ip = nn_l2.nn_l2_plain(fq, ft, okt)
    # plain fp32 q @ t.T sums in another order: equal indices, or a d2
    # within 1e-6 relatively where they differ (a near tie)
    diff = ik != ip
    near = (d2k - d2p).abs() <= 1e-6 * d2p.abs().clamp_min(1e-30)
    assert bool(near[diff].all()), "K7 D=352: an index differs beyond a near tie"
    torch.testing.assert_close(d2k, d2p, rtol=1e-5, atol=1e-6)
    records.append(dict(
        name="nn_l2_d352", route="cuda", source=src + "nn_l2.cu",
        replaces="lidar_global_registration_tpu/ops/pallas/topk_l2.py:26",
        max_abs_err=float((d2k - d2p).abs().max()), idx_mismatch=int(diff.sum()),
        shape=[int(fq.shape[0]), int(ft.shape[0]), int(fq.shape[1])],
        ms=cuda_ms(lambda: nn_l2.nn_l2_cuda(fq, ft, okt), 5),
        plain_ms=cuda_ms(lambda: nn_l2.nn_l2_plain(fq, ft, okt), 2),
        **nn_bound(fq, ft, okt, d2k, ik),
        library_ms=cuda_ms(lambda: library_nn(fq, ft, okt), 2)))
    log(f"# K7 D=352 ok: {fq.shape[0]} x {ft.shape[0]} SHOT rows, {int(diff.sum())} index "
        f"differences (near ties), max d2 err {records[-1]['max_abs_err']:.3g}")
    return records


def check_classic_fpfh(S):
    """The K5 subset and K6 `kp_rows` forms at the classic masked route's
    shapes (flagship._masked_route, FPFH): the source working cloud at the
    feature radius, its masked normals, the keypoints' compacted rows; each
    against its plain version."""
    import torch

    from lidar_global_registration_tpu_torch.models.flagship import _compact_rows, _pad_quantum
    from lidar_global_registration_tpu_torch.ops import cellgrid as cg

    src = "lidar_global_registration_tpu_torch/csrc/"
    pallas = "lidar_global_registration_tpu/ops/pallas/cellgrid.py:"
    radii = S["radii"]
    sx, sv, r_iss, rf = S["sx"], S["sv"], radii["iss_src"], radii["feature"]
    pn = cg.plan_grid(sx, sv, max(radii["normal_cell"], r_iss))
    pf = cg.plan_grid(sx, sv, rf)
    normal, kp, _dens, _sal = cg.surface_iss_masked(pn, pf, radii["normal_cell"], r_iss,
                                                    S["vp_a"])
    pf = cg.set_normals(pf, normal)
    r2f = cg._f32_square(rf)
    cen = cg.aabb_centre(pf)
    n = int(kp.sum())
    sj = _compact_rows(kp, n, _pad_quantum(n))
    N = sx.shape[0]
    slots = cg.stencil_slots(pf, torch.nonzero(kp[pf.order[:pf.n_valid]]).squeeze(1))
    sp_k, c_k = cg.spfh_at_cuda(pf, r2f, cen, slots)
    sp_p, c_p = cg.spfh_plain(pf, r2f, cen, slots)
    assert torch.equal(c_k, c_p), "K5 subset (classic) counts differ"
    f5 = frac_off(sp_k[slots], sp_p[slots])
    assert f5 < 1e-3, f"K5 subset (classic): {f5:.2e} off by > 0.5"
    records = [dict(
        name="spfh_at_classic", route="cuda", source=src + "fpfh.cu", replaces=pallas + "1554",
        max_abs_err=float((sp_k - sp_p).abs().max()), queries=int(slots.numel()),
        ms=cuda_ms(lambda: cg.spfh_at_cuda(pf, r2f, cen, slots), 5),
        plain_ms=cuda_ms(lambda: cg.spfh_plain(pf, r2f, cen, slots), 1),
        **stencil_bound("spfh", pf, c_p[slots].sum(), tbytes(
            pf.pts, pf.nrm, pf.cell_of, pf.cols, slots) + slots.numel() * 4 * 34, slots),
        library_ms=None)]
    log(f"# K5 subset (classic) ok: {slots.numel()} of {pf.n_valid} working points, "
        f"frac_off={f5:.2e}")
    inv = cg.slot_of(pf)
    srt = torch.where(sj < N, inv[sj.clamp_max(N - 1)], -1)
    f_k, k_k = cg.combine_at_cuda(pf, r2f, sp_k, srt)
    f_p, k_p = cg.combine_plain(pf, r2f, sp_k, srt)
    assert torch.equal(k_k, k_p), "K6 kp_rows (classic) counts differ"
    f6 = frac_off(f_k, f_p)
    assert f6 < 1e-3, f"K6 kp_rows (classic): {f6:.2e} off by > 0.5"
    records.append(dict(
        name="combine_at_classic", route="cuda", source=src + "fpfh.cu",
        replaces=pallas + "1608", max_abs_err=float((f_k - f_p).abs().max()),
        queries=int(srt.numel()),
        ms=cuda_ms(lambda: cg.combine_at_cuda(pf, r2f, sp_k, srt), 5),
        plain_ms=cuda_ms(lambda: cg.combine_plain(pf, r2f, sp_k, srt), 1),
        **stencil_bound("combine", pf, k_p.sum(), tbytes(
            pf.pts, pf.cell_of, pf.cols, sp_k, srt, f_k, k_k), srt),
        library_ms=None))
    log(f"# K6 kp_rows (classic) ok: {n} rows of {srt.numel()}, "
        f"max_abs_err={records[-1]['max_abs_err']:.3g}")

    # the route's fpfh stage as flagship._masked_route runs it (normals into
    # the plan, compacted rows, fpfh_pass(kp=, kp_rows=)), split into the
    # stencil slots, K5, K6 and the rest (copies, slot maps, host reads)
    def stage():
        return cg.fpfh_pass(cg.set_normals(pf, normal), rf, kp=kp,
                            kp_rows=_compact_rows(kp, n, _pad_quantum(n)))

    split = {"stage": cuda_ms(stage, 3),
             "stencil_slots": cuda_ms(lambda: cg.stencil_slots(
                 pf, torch.nonzero(kp[pf.order[:pf.n_valid]]).squeeze(1)), 3),
             "spfh_at": records[0]["ms"], "combine_at": records[1]["ms"]}
    split["rest"] = split["stage"] - sum(v for k, v in split.items() if k != "stage")
    records[0]["fpfh_stage_ms"] = split
    log("# classic fpfh stage (ms): " + " ".join(f"{k}={v:.4f}" for k, v in split.items()))
    return records


def check_unmasked(S):
    """K1's, K5's and K6's full forms at the unmasked ISS route's shapes
    (flagship._unmasked_route on the source working cloud: K1 over every row
    of the plan at max(normal cell, ISS radius), K5 and K6 over every row at
    the feature radius), each against its plain version, which is timed in
    the one call that is compared; then the route's values against the
    classic masked route's: the same keypoints, the same normals at every
    row a later stage reads, the same densities and FPFH at the keypoints."""
    import torch

    from lidar_global_registration_tpu_torch.models.flagship import _compact_rows, _pad_quantum
    from lidar_global_registration_tpu_torch.ops import cellgrid as cg

    src = "lidar_global_registration_tpu_torch/csrc/"
    pallas = "lidar_global_registration_tpu/ops/pallas/cellgrid.py:"
    radii = S["radii"]
    sx, sv = S["sx"], S["sv"]
    rn, rf, r_iss = radii["normal_cell"], radii["feature"], radii["iss_src"]
    pn = cg.plan_grid(sx, sv, max(rn, r_iss))
    pf = cg.plan_grid(sx, sv, rf)
    r2n, r2f = cg._f32_square(rn), cg._f32_square(rf)
    k1 = cg.surface_cuda(pn, r2n)
    k1_p, plain_ms = timed_once(lambda: cg.surface_plain(pn, r2n))
    records = [dict(
        name="surface_pn", route="cuda", source=src + "surface.cu", replaces=pallas + "1241",
        max_abs_err=surface_err(*k1, *k1_p, "K1 (working cloud, pn plan)"),
        queries=int(pn.n_valid), ms=cuda_ms(lambda: cg.surface_cuda(pn, r2n), 10),
        plain_ms=plain_ms,
        **stencil_bound("surface", pn, k1_p[0][:, 7].sum(), tbytes(
            pn.pts, pn.cell_of, pn.cols, pn.oid, *k1)), library_ms=None)]
    log(f"# K1 full on the pn plan ok: {pn.n_valid} rows, cell {pn.cell:.4f} for r {rn:.4f}, "
        f"{records[-1]['ms']:.4f} ms, plain {plain_ms:.0f} ms")

    # the route's side stage against the classic route's
    out = cg.surface_iss_cells(pn, rn, r_iss, S["vp_a"])
    normal_m, kp_m, dens_m, _sal = cg.surface_iss_masked(pn, pf, rn, r_iss, S["vp_a"])
    need = cg.point_need(pf, kp_m, 2)
    assert torch.equal(out["kp"], kp_m), "unmasked route: keypoints differ from the classic route's"
    assert torch.equal(out["normal"][need], normal_m[need]), "unmasked route: normals differ"
    assert torch.equal(out["density"][kp_m], dens_m[kp_m]), "unmasked route: densities differ"

    pfn = cg.set_normals(pf, out["normal"])
    cen = cg.aabb_centre(pfn)
    sp_k, c_k = cg.spfh_cuda(pfn, r2f, cen)
    (sp_p, c_p), plain_ms = timed_once(lambda: cg.spfh_plain(pfn, r2f, cen))
    f5 = frac_off(sp_k, sp_p)
    assert torch.equal(c_k, c_p) and f5 < 1e-3, f"K5 full (working cloud): {f5:.2e} off by > 0.5"
    records.append(dict(
        name="spfh_work_full", route="cuda", source=src + "fpfh.cu", replaces=pallas + "1554",
        max_abs_err=float((sp_k - sp_p).abs().max()), queries=int(pfn.n_valid),
        ms=cuda_ms(lambda: cg.spfh_cuda(pfn, r2f, cen), 3), plain_ms=plain_ms,
        **stencil_bound("spfh", pfn, c_p.sum(), tbytes(
            pfn.pts, pfn.nrm, pfn.cell_of, pfn.cols, sp_k, c_k)), library_ms=None))
    log(f"# K5 full at {pfn.n_valid} rows ok: {records[-1]['ms']:.3f} ms, plain {plain_ms:.0f} ms, "
        f"frac_off={f5:.2e}")
    f_k, k_k = cg.combine_cuda(pfn, r2f, sp_k)
    (f_p, k_p), plain_ms = timed_once(lambda: cg.combine_plain(pfn, r2f, sp_k))
    f6 = frac_off(f_k, f_p)
    assert torch.equal(k_k, k_p), "K6 full (working cloud) neighbour counts differ"
    assert f6 < 1e-3 and float((f_k - f_p).abs().median()) < 1e-3, f"K6 full: {f6:.2e}"
    records.append(dict(
        name="combine_work_full", route="cuda", source=src + "fpfh.cu", replaces=pallas + "1608",
        max_abs_err=float((f_k - f_p).abs().max()), queries=int(pfn.n_valid),
        ms=cuda_ms(lambda: cg.combine_cuda(pfn, r2f, sp_k), 3), plain_ms=plain_ms,
        **stencil_bound("combine", pfn, k_p.sum(), tbytes(
            pfn.pts, pfn.cell_of, pfn.cols, sp_k, f_k, k_k)), library_ms=None))
    log(f"# K6 full at {pfn.n_valid} rows ok: {records[-1]['ms']:.3f} ms, plain {plain_ms:.0f} ms, "
        f"max_abs_err={records[-1]['max_abs_err']:.3g}")

    # FPFH at the keypoints: every row in full against the classic route's
    # compacted pass (the same K5 rows; K6 one thread a query against one
    # warp a query, whose sums run in the same order)
    feat_u, fv_u = cg.fpfh_pass(pfn, rf)
    n = int(kp_m.sum())
    sj = _compact_rows(kp_m, n, _pad_quantum(n))
    feat_c, fv_c = cg.fpfh_pass(cg.set_normals(pf, normal_m), rf, kp=kp_m, kp_rows=sj)
    rows = sj[:n]
    assert torch.equal(fv_u[rows], fv_c[:n]), "unmasked route: FPFH validity differs"
    err = float((feat_u[rows] - feat_c[:n]).abs().max())
    # histograms that sum to 100 a block: 1e-4 is a few float32 roundings
    assert err <= 1e-4, f"unmasked route: FPFH at the keypoints differs by {err:.3g}"
    log(f"# unmasked route = classic route at {n} keypoints: masks equal, normals equal at "
        f"{int(need.sum())} needed rows, FPFH max abs diff {err:.3g}")
    return records


def register_iss(S, cfg, seed, av=None, times=None, debug=None):
    """pre-downsample + register_pair_staged on an ISS route (bench.py:275-290)."""
    import torch

    from lidar_global_registration_tpu_torch.models.flagship import (
        pre_downsample_pair,
        register_pair_staged,
    )

    a = S["a"] if av is None else av
    t0 = time.perf_counter()
    sx, sv, tx, tv = pre_downsample_pair(a, S["ones"], S["b"], S["ones"], *S["vox"],
                                         aabb=S["aabb"])
    if times is not None:
        torch.cuda.synchronize()
        times["pre_downsample"] = time.perf_counter() - t0
    gen = torch.Generator(device=a.device).manual_seed(seed)
    return register_pair_staged(sx, sv, tx, tv, gen, *(S["radii"][k] for k in RADII_KEYS),
                                vp_src=S["vp_a"], vp_tgt=S["vp_b"], cfg=cfg,
                                return_correspondences=True, stage_times=times,
                                pyramid_debug=debug)


def iss_setup(dev, n: int, graded: bool = False):
    """An ISS pair sampled on `dev`: raw radii, the pre-downsample voxels
    and bounds, the pre-downsampled working clouds and their radii."""
    import torch

    from lidar_global_registration_tpu_torch.models.flagship import (
        _aabb_pair,
        pre_downsample_pair,
    )
    from lidar_global_registration_tpu_torch.ops.density import derive_radii

    a, b, vp_a, vp_b, T_gt = iss_scene(n, dev, graded)
    ones = torch.ones((n,), dtype=torch.bool, device=dev)
    raw = derive_radii(a, b)
    vox = (2.0 * raw["density_src"], 2.0 * raw["density_tgt"])
    aabb = _aabb_pair(a, ones, b, ones).cpu().numpy()
    sx, sv, tx, tv = pre_downsample_pair(a, ones, b, ones, vox[0], vox[1], aabb=aabb)
    radii = derive_radii(sx, tx, sv, tv)
    return dict(a=a, b=b, ones=ones, vp_a=vp_a, vp_b=vp_b, T_gt=T_gt, raw=raw, vox=vox,
                aabb=aabb, sx=sx, sv=sv, tx=tx, tv=tv, radii=radii)


def iss_runs(S, cfg, counters, label, repeats: int, rule: bool):
    """One warm-up (a first run pays for the allocator's growth: on an
    H100 the classic SHOT route took 0.6-0.8 s cold, 0.28-0.34 s warm) and
    `repeats` timed runs of pre-downsample + register_pair_staged under
    `cfg`, with every launch counter set to 0 just before the timed runs and
    read just after; those of `counters` must have risen.  rule: hold each
    run to the bench's success rule, else to a finite pose.  Returns every
    wrapper's launch count."""
    import torch

    from lidar_global_registration_tpu_torch.types import SEED

    dev = S["a"].device
    torch.cuda.reset_peak_memory_stats(dev)
    register_iss(S, cfg, SEED)  # warm-up
    torch.cuda.synchronize()
    zero_counters()
    levels = 0
    for r in range(repeats):
        av = S["a"] + 1e-5 * (r + 1)  # vary the input per repeat, as bench.py:313
        torch.cuda.synchronize()
        times, debug = {}, {}
        t0 = time.perf_counter()
        out = register_iss(S, cfg, SEED + r, av, times, debug)
        out["transformation"].cpu()  # waits for the device
        dt = time.perf_counter() - t0
        if cfg.pyramid:
            levels = pyramid_record(debug, times, f"{label} repeat {r}")
        r_err, t_err, finite = pose_error(out, S["T_gt"].cpu().numpy())
        conv = bool(out["converged"])
        ok = conv and r_err < R_ERR_MAX and t_err < S["radii"]["thr"] and finite
        log(f"# {label} repeat {r} n={S['a'].shape[0]}: {dt:.4f} s converged={conv} "
            f"r_err={r_err:.5f} t_err={t_err:.4f} corr={float(out['n_correspondences']):.0f} "
            f"inliers={int(out['inliers'])} metric={float(out['metric']):.4f} "
            f"iterations={float(out['iterations']):.0f} ok={ok}")
        log("#   stages (s): " + " ".join(f"{k}={v:.4f}" for k, v in times.items()))
        assert finite, f"{label} repeat {r}: non-finite pose"
        assert ok or not rule, f"{label} repeat {r} failed the bench's success rule"
    launches = read_counters()
    need = [c.__name__ for c in counters]
    log(f"# launches in the {label} runs: {launches}")
    check_counts(label, launches, need, off=())
    # the pyramid launches K1 (and for FPFH K5, K6) once per level per side
    per_level = [launches[k] for k in need if k.split("_")[0] in ("surface", "spfh", "combine")]
    assert all(n >= levels for n in per_level), f"{label}: fewer launches than levels ({levels})"
    log(f"#   peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return launches


def pyramid_record(debug, times, label: str) -> int:
    """Log one pyramid run's record (level ranges, matched window,
    keypoints per bucket, surface rows per level) and require that the
    pyramid ran to its end (a failed gate leaves the record empty) over at
    least 2 matched levels.  Returns the levels of both sides together."""
    assert debug and "match_pyramid" in times, f"{label}: a pyramid gate failed"
    lo, hi = debug["match"]
    s, t = debug["side_src"], debug["side_tgt"]
    log(f"#   pyramid levels src [{s['min_log2']},{s['max_log2']}] tgt [{t['min_log2']},"
        f"{t['max_log2']}] match [{lo},{hi}]; kp per bucket src {s['kp_per_bucket']} tgt "
        f"{t['kp_per_bucket']}; surface rows src {s['surface_rows']} tgt {t['surface_rows']}")
    assert hi - lo + 1 >= 2, f"{label}: only {hi - lo + 1} matched level"
    return len(s["surface_rows"]) + len(t["surface_rows"])


def default_pyramid_cfg(S):
    """The reference's default configuration (nothing named but the shipped
    gravity frames and the bench's hypothesis batch: ISS, SHOT, cluster
    matching, uniformity, no feature radius) through the port's front:
    Config -> expand_parameters -> staged_envelope.  Returns (parameters,
    FlagshipConfig)."""
    from lidar_global_registration_tpu_torch.models.pipeline import staged_envelope
    from lidar_global_registration_tpu_torch.utils.config import Config, expand_parameters

    radii = S["radii"]
    (params,) = expand_parameters(Config({"lrf": "gravity", "hypothesis_batch": 1024}),
                                  radii["density_src"], radii["density_tgt"], False,
                                  S["vp_a"].cpu().numpy(), S["vp_b"].cpu().numpy())
    cfg, reason = staged_envelope(params)
    assert cfg is not None, f"the default configuration left the staged envelope: {reason}"
    assert params.feature_radius is None and cfg.pyramid and cfg.use_iss and cfg.cluster_matching
    assert (cfg.descriptor, cfg.lrf, cfg.metric, cfg.rounds) == ("shot", "gravity", "uniformity", 64)
    assert abs(params.iss_radius_src - radii["iss_src"]) < 1e-9
    assert abs(params.distance_thr - radii["thr"]) < 1e-9
    return params, cfg


def check_front(S, params):
    """align_point_clouds on the working clouds of S under the default
    configuration: the pyramid through the port's own entry point, held to
    the bench's success rule."""
    import torch

    from lidar_global_registration_tpu_torch.models.pipeline import align_point_clouds
    from lidar_global_registration_tpu_torch.types import Cloud

    def cloud(x, v):
        z = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
        return Cloud(x, torch.zeros_like(x), v.to(torch.float32), z, v)

    radii = S["radii"]
    t0 = time.perf_counter()
    res = align_point_clouds(cloud(S["sx"], S["sv"]), cloud(S["tx"], S["tv"]), params,
                             save_artifacts=False, density_src=radii["density_src"],
                             density_tgt=radii["density_tgt"], device=S["sx"].device)
    dt = time.perf_counter() - t0
    r_err, t_err, finite = pose_error({"transformation": torch.from_numpy(res.transformation)},
                                      S["T_gt"].cpu().numpy())
    n_c = int(res.correspondences.valid.sum())
    log(f"# align_point_clouds (default configuration, n={S['a'].shape[0]}): {dt:.4f} s "
        f"converged={res.converged} r_err={r_err:.5f} t_err={t_err:.4f} corr={n_c} "
        f"metric={res.metric:.4f} iterations={res.iterations}")
    assert res.converged and finite and r_err < R_ERR_MAX and t_err < radii["thr"], \
        "align_point_clouds failed the bench's success rule"
    assert res.correspondences.query.is_cuda and n_c > 0


def check_pyramid_kernels(S, cfg):
    """K1 and the K5 `kp` / K6 `kp_rows` forms on the finest and the
    coarsest level's surface of the source side, and K7 on the lowest
    matched level's descriptor rows, as one FPFH pyramid run of S gives
    them; each against its plain version."""
    import torch

    from lidar_global_registration_tpu_torch.ops import nn_l2
    from lidar_global_registration_tpu_torch.types import SEED

    debug = {}
    register_iss(S, cfg, SEED, debug=debug)
    side = debug["side_src"]
    rows, bucket = side["kp_indices"], side["log2_radii"]
    records = []
    for tag, l in (("fine", side["min_log2"]), ("coarse", side["max_log2"])):
        log(f"# pyramid level {l} ({tag}), r = {cfg.scale_factor ** l:.4f}: "
            f"{int((bucket <= l).sum())} of {rows.numel()} keypoints")
        records += surface_records(S["sx"], S["sv"], rows, bucket <= l,
                                   float(cfg.scale_factor) ** l,
                                   tuple(f"{k}_pyr_{tag}" for k in ("surface", "spfh_at",
                                                                    "combine_at")))
    lo = debug["match"][0]
    (fa, va), (fb, vb) = (debug[s]["levels"][lo - debug[s]["min_log2"]]
                          for s in ("side_src", "side_tgt"))
    d2k, ik = nn_l2.nn_l2_cuda(fa, fb, vb)
    d2p, ip = nn_l2.nn_l2_plain(fa, fb, vb)
    dk, dp = d2k.clamp_min(0).sqrt(), d2p.clamp_min(0).sqrt()
    torch.testing.assert_close(dk, dp, rtol=1e-5, atol=1e-5)
    same = (dk - dp).abs() <= 1e-6
    assert torch.equal(ik[same], ip[same]), "K7 (pyramid level) indices differ where distances agree"
    records.append(dict(
        name="nn_l2_pyr", route="cuda", source="lidar_global_registration_tpu_torch/csrc/nn_l2.cu",
        replaces="lidar_global_registration_tpu/ops/pallas/topk_l2.py:26",
        max_abs_err=float((dk - dp).abs().max()), idx_mismatch=int((ik != ip).sum()),
        shape=[int(fa.shape[0]), int(fb.shape[0]), int(fa.shape[1])],
        valid_rows=[int(va.sum()), int(vb.sum())],
        ms=cuda_ms(lambda: nn_l2.nn_l2_cuda(fa, fb, vb), 10),
        plain_ms=cuda_ms(lambda: nn_l2.nn_l2_plain(fa, fb, vb), 2),
        **nn_bound(fa, fb, vb, d2k, ik),
        library_ms=cuda_ms(lambda: library_nn(fa, fb, vb), 2)))
    log(f"# K7 on level {lo}: {fa.shape[0]} x {fb.shape[0]} rows ({int(va.sum())} / "
        f"{int(vb.sum())} valid), max_abs_err={records[-1]['max_abs_err']:.3g}")
    return records


def check_vote_and_buckets(S, cfg):
    """The cross-level vote and the bucket query on the card against the
    CPU on one exported input: the same winners, the same buckets."""
    import torch

    from lidar_global_registration_tpu_torch.models.flagship import _bucket_rows
    from lidar_global_registration_tpu_torch.models.pyramid import _consensus_vote
    from lidar_global_registration_tpu_torch.types import SEED

    debug = {}
    register_iss(S, cfg, SEED, debug=debug)
    ci, cd, cm = debug["candidates_st"]
    train = S["tx"][debug["side_tgt"]["kp_indices"]]
    r_iss = S["radii"]["iss_tgt"]
    on_card = _consensus_vote(ci, cd, cm, train, r_iss)
    on_cpu = _consensus_vote(ci.cpu(), cd.cpu(), cm.cpu(), train.cpu(), r_iss)
    for name, g, c in zip(("b_idx", "b_dist", "b_mask", "s_dist", "s_mask"), on_card, on_cpu):
        assert torch.equal(g.cpu(), c), f"_consensus_vote, card against CPU: {name} differs"
    log(f"# _consensus_vote on {tuple(ci.shape)} candidates, card = CPU in all five outputs; "
        f"{int(on_cpu[2].sum())} winners, {int(on_cpu[4].sum())} with a runner-up")
    kp = torch.zeros_like(S["sv"])
    kp[debug["side_src"]["kp_indices"]] = True
    dcell = S["radii"]["density_src"]
    t0 = time.perf_counter()
    li_g, hist_g, found_g = _bucket_rows(S["sx"], S["sv"], kp, dcell, cfg.scale_factor)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    li_c, hist_c, found_c = _bucket_rows(S["sx"].cpu(), S["sv"].cpu(), kp.cpu(), dcell,
                                         cfg.scale_factor)
    # the distances are the same float32 sums; sqrt and log2 may round
    # another way on the two devices, which moves a radius on a bucket edge
    valid = S["sv"].cpu()
    off = int((li_g.cpu() != li_c)[valid].sum())
    assert torch.equal(found_g.cpu(), found_c), "bucket query: the windows found differ"
    assert off <= 1e-5 * int(valid.sum()) + 1, f"bucket query: {off} buckets differ"
    assert int((hist_g.cpu() - hist_c).abs().sum()) <= 2
    log(f"# bucket query on {int(valid.sum())} rows: card = CPU but {off} buckets, "
        f"{int(found_c[valid].sum())} rows with their 5th neighbour in the window; "
        f"{t_card:.4f} s on the card")


def pyramid_phase(dev):
    """The staged pyramid on the graded bench scene (bench.py with
    LGR_BENCH_ISS=1 LGR_BENCH_GRADED=1 LGR_BENCH_PYRAMID=1): at 1,048,576
    points a side pre-downsample + registration with FPFH and with the
    reference's default configuration (SHOT, gravity frames; reached
    through Config -> expand_parameters -> staged_envelope), a warm-up and 3
    repeats each under the bench's success rule, and the default
    configuration once through align_point_clouds; at N_PYR_LARGE points
    once per descriptor, held to a finite pose, after the kernels were
    checked at that pair's level shapes.  Returns the kernel records and
    each run's launch counts."""
    import torch

    from lidar_global_registration_tpu_torch.ops import cellgrid as cg
    from lidar_global_registration_tpu_torch.ops import nn_l2

    iss_k = (cg.iss_count_cuda, cg.iss_saliency_cuda, cg.iss_nms_cuda)
    fpfh_k = (cg.surface_cuda, *iss_k, cg.spfh_at_cuda, cg.combine_at_cuda, nn_l2.nn_l2_cuda)
    shot_k = (cg.surface_cuda, *iss_k, nn_l2.nn_l2_cuda)
    records, launches = [], {}
    for n, tag, repeats, rule in ((N_PYR, "1m", REPEATS, True), (N_PYR_LARGE, "2m", 1, False)):
        t0 = time.perf_counter()
        S = iss_setup(dev, n, graded=True)
        torch.cuda.synchronize()
        log(f"# graded pair n={n}: set-up {time.perf_counter() - t0:.2f} s; pre-downsample -> "
            f"{S['sx'].shape[0]} rows/side ({int(S['sv'].sum())}/{int(S['tv'].sum())} valid, "
            f"voxel {S['vox'][0]:.4f}/{S['vox'][1]:.4f}); radii {S['radii']}")
        params, shot_cfg = default_pyramid_cfg(S)
        fpfh_cfg = iss_cfg(pyramid=True)
        if rule:
            check_vote_and_buckets(S, fpfh_cfg)
            check_front(S, params)
        else:
            records += check_pyramid_kernels(S, fpfh_cfg)
        launches[f"pyr_fpfh_{tag}"] = iss_runs(S, fpfh_cfg, fpfh_k, f"pyramid FPFH {tag}",
                                               repeats, rule)
        launches[f"pyr_shot_{tag}"] = iss_runs(S, shot_cfg, shot_k, f"pyramid SHOT {tag}",
                                               repeats, rule)
        # the same pair through the single feature-scale route, for the cost
        # of the pyramid beside it
        launches[f"fs_fpfh_{tag}"] = iss_runs(S, iss_cfg(), fpfh_k, f"feature-scale FPFH {tag}",
                                              1, False)
        del S
        torch.cuda.empty_cache()
    return records, launches


# the wrapper (launch counter) of the kernel form that each record holds
WRAPPER_OF = {
    **dict.fromkeys(("surface", "surface_fs", "surface_pn", "surface_pyr_fine",
                     "surface_pyr_coarse"), "surface_cuda"),
    "surface_at": "surface_at_cuda",
    **{k + s: k + "_cuda" for k in ("iss_count", "iss_saliency", "iss_nms")
       for s in ("", "_pn", "_gror")},
    **dict.fromkeys(("spfh", "spfh_262k", "spfh_work_full", "spfh_gror"), "spfh_cuda"),
    **dict.fromkeys(("spfh_at", "spfh_at_classic", "spfh_at_pyr_fine", "spfh_at_pyr_coarse"),
                    "spfh_at_cuda"),
    **dict.fromkeys(("combine", "combine_262k", "combine_work_full"), "combine_cuda"),
    **dict.fromkeys(("combine_at", "combine_at_classic", "combine_at_pyr_fine",
                     "combine_at_pyr_coarse"), "combine_at_cuda"),
    **dict.fromkeys(("nn_l2", "nn_l2_262k", "nn_l2_d352_64k", "nn_l2_iss", "nn_l2_d352",
                     "nn_l2_pyr", "nn_l2_host_d33", "nn_l2_host_d352", "nn_l2_host_d135",
                     "nn_l2_host_d1960", "nn_l2_gror"), "nn_l2_cuda"),
    "nn_l2_bf16_host": "nn_l2_bf16_cuda",
    **{k + "_host": k + "_cuda" for k in ("iss_count", "iss_saliency", "iss_nms")},
    "iss_count_r5": "iss_count_cuda",
    "spfh_host": "spfh_cuda",
    **{f"iss_{k}_at_{s}": f"iss_{k}_at_cuda" for k in ("count", "saliency", "nms")
       for s in ("1m", "64k")},
    "spfh_at_tp": "spfh_at_cuda",
    **dict.fromkeys(("nn_l2_tp_shard0", "nn_l2_tp_shard1"), "nn_l2_cuda"),
}
# every kernel wrapper of the port (each its own launch counter), as the
# CLI's `# device` line lists them
WRAPPERS = ("surface_cuda", "surface_at_cuda", "iss_count_cuda", "iss_saliency_cuda",
            "iss_nms_cuda", "iss_count_at_cuda", "iss_saliency_at_cuda", "iss_nms_at_cuda",
            "spfh_cuda", "spfh_at_cuda", "combine_cuda", "combine_at_cuda", "nn_l2_cuda",
            "nn_l2_bf16_cuda")


def _wrapper(name: str):
    """The wrapper now bound under `name` in its module (a recorder's hook
    while one is in force: the wrapper's body then counts into the hook)."""
    from lidar_global_registration_tpu_torch.ops import cellgrid, nn_l2

    return getattr(nn_l2 if name.startswith("nn_l2") else cellgrid, name)


def zero_counters() -> None:
    for name in WRAPPERS:
        _wrapper(name).launches = 0


def read_counters() -> dict:
    """Every wrapper's launches since zero_counters."""
    return {name: _wrapper(name).launches for name in WRAPPERS}


def check_counts(label: str, got: dict, need, off=None) -> None:
    """The forms in `need` rose; every other form (or those in `off`) did
    not run."""
    assert all(got[w] > 0 for w in need), f"{label}: a kernel never ran: {got}"
    off = [w for w in WRAPPERS if w not in need] if off is None else off
    assert all(got[w] == 0 for w in off), f"{label}: a form off its path ran: {got}"


@contextlib.contextmanager
def recorder(got: dict, specs):
    """While in force, each wrapper of specs = [(module, name, key or
    None)] is replaced by a hook that keeps its first call's arguments in
    got[key(*args) if key else name] and then calls it.  The wrapper's body
    counts into `<module>.<name>.launches`, that is the hook's, so
    zero_counters / read_counters see these launches and the wrapper's own
    count does not; the wrappers are restored on exit."""
    originals = []
    try:
        for mod, name, key in specs:
            fn = getattr(mod, name)
            originals.append((mod, name, fn))

            def hook(*args, fn=fn, name=name, key=key):
                got.setdefault(key(*args) if key else name, args)
                return fn(*args)
            hook.launches = 0
            setattr(mod, name, hook)
        yield got
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)

CLI_DIR = ROOT / "chiprun_out" / "cli"
CLI_TIMEOUT = 600  # seconds for one command of the CLI phase
# the wrappers of K1-K7 on the CLI path (K1 full, K5 `kp`, K6 `kp_rows`), and
# the forms it never runs (K1's slot list, K5's and K6's full passes)
CLI_WRAPPERS = (("surface", "surface_cuda"), ("iss_count", "iss_count_cuda"),
                ("iss_saliency", "iss_saliency_cuda"), ("iss_nms", "iss_nms_cuda"),
                ("spfh", "spfh_at_cuda"), ("combine", "combine_at_cuda"), ("nn_l2", "nn_l2_cuda"))
CLI_OFF = ("surface_at_cuda", "spfh_cuda", "combine_cuda", "nn_l2_bf16_cuda")


def write_cli_scene(dev, n: int, tag: str) -> Path:
    """The graded bench pair of n points a side as the loader reads it: two
    binary PLY scans, ground_truth.csv (pose_tgt = inv(T_gt), pose_src = I,
    so GT = inv(pose_tgt) @ pose_src = T_gt) and viewpoints.csv, written by
    the port's own writers into a fresh directory.  Returns it."""
    import shutil

    from lidar_global_registration_tpu_torch.utils.io import save_transformation, write_ply

    a, b, vp_a, vp_b, T_gt = iss_scene(n, dev, graded=True)
    d = CLI_DIR / tag
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    write_ply(str(d / "scanA.ply"), a.cpu().numpy())
    write_ply(str(d / "scanB.ply"), b.cpu().numpy())
    T = T_gt.cpu().numpy().astype(np.float64)
    save_transformation(str(d / "ground_truth.csv"), "scanA.ply", np.eye(4, dtype=np.float32))
    save_transformation(str(d / "ground_truth.csv"), "scanB.ply",
                        np.linalg.inv(T).astype(np.float32))
    with open(d / "viewpoints.csv", "w") as f:
        f.write("reading,x,y,z\n")
        for name, vp in (("scanA.ply", vp_a), ("scanB.ply", vp_b)):
            x, y, z = (float(v) for v in vp.cpu())
            f.write(f"{name},{x!r},{y!r},{z!r}\n")
    return d


CLI_SCENE = ("source: scanA.ply\ntarget: scanB.ply\nground_truth: ground_truth.csv\n"
             "viewpoints: viewpoints.csv\nhypothesis_batch: 1024\n")


def cli_config(d: Path, name: str, body: str, tests: str | None = None) -> str:
    """Write d/name.yaml: the scene's keys plus `body`, or a `tests:` list
    with one entry of type `tests` holding them.  Returns the file name."""
    text = CLI_SCENE + body
    if tests is not None:
        text = f"tests:\n    - {tests}:\n" + "".join(f"        {ln}\n"
                                                    for ln in text.strip().splitlines())
    (d / f"{name}.yaml").write_text(text)
    return f"{name}.yaml"


def run_cli(d: Path, command: str, config: str, label: str, env_extra=None) -> dict:
    """`python -m lidar_global_registration_tpu_torch <command> <config>` in
    d, as a user runs it (with env_extra added to its environment).  Its
    whole output goes to d/<label>.log; its step lines are echoed.  A
    non-zero exit fails the phase.  Returns the command's seconds, its
    kernel launches, the preprocessed densities and rows it printed and its
    standard output."""
    import os

    env = dict(os.environ, **(env_extra or {}))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "lidar_global_registration_tpu_torch", command,
                           config], cwd=d, env=env, capture_output=True, text=True,
                          timeout=CLI_TIMEOUT)
    dt = time.perf_counter() - t0
    (d / f"{label}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        log(proc.stdout[-3000:] + proc.stderr[-3000:])
        raise AssertionError(f"CLI {label}: exit code {proc.returncode}")
    launches, densities, rows = {}, [], []
    for line in proc.stdout.splitlines():
        if line.startswith("# "):
            log(f"#   {label}: {line[2:]}")
        m = re.match(r"# device: .* launches (\{.*\})$", line)
        if m:
            launches = json.loads(m.group(1))
        m = re.match(r"# load .* density [\d.]+ s \(([\d.e+-]+)\)$", line)
        if m:
            densities.append(float(m.group(1)))
            rows.append(int(re.search(r"downsample [\d.]+ s \((\d+) rows\)", line).group(1)))
    log(f"#   {label}: {dt:.2f} s command")
    return dict(seconds=dt, launches=launches, densities=densities, rows=rows, out=proc.stdout)


def cli_results(d: Path, n_rows: int) -> list[dict]:
    """The last n_rows rows of d's test_results.csv, each held to the
    bench's success rule and the reference's overlap rule: converged,
    r_err < 0.05 rad, t_err < distance_thr, overlap_rmse < distance_thr."""
    lines = (d / "data/debug/test_results.csv").read_text().strip().splitlines()
    header = lines[0].split(",")
    assert len(header) == 38, header
    rows = [dict(zip(header, ln.split(","))) for ln in lines[1:]][-n_rows:]
    for r in rows:
        thr = float(r["distance_thr"])
        log(f"#   result {r['descriptor']} fr={r['feature_radius'] or 'auto'} {r['metric_type']} "
            f"{r['matching_type']} {r['alignment_type']}: converged="
            f"{r['converged']} r_err={r['r_err']} t_err={r['t_err']} overlap_rmse="
            f"{r['overlap_rmse']} thr={thr:g} inliers={r['inliers']}/{r['correspondences']} "
            f"overlap={r['overlap']} time_cs={r['time_cs']} time_te={r['time_te']}")
        assert r["converged"] == "1" and float(r["r_err"]) < R_ERR_MAX, r
        assert float(r["t_err"]) < thr and float(r["overlap_rmse"]) < thr, r
    return rows


# The host path (align_point_clouds outside the staged envelope: host ISS,
# the host pyramid, align_ransac / align_gror): H1 is the reference's default
# configuration with the AlignmentParameters default metric (combination),
# H2 FPFH at a fixed radius with lr matching and the weighted closest-plane
# metric, solved by RANSAC and by GROR; H3 RoPS with its own frames (the
# default lrf), H4 USC with ground-truth frames, H5 FPFH with ground-truth
# frames (which FPFH does not read) and one_sided matching, each with the
# config's defaults otherwise (ISS, cluster or one_sided, uniformity, the
# AUTO radius); H6 the bf16 matcher on the reference's default SHOT
# configuration, which stays in the staged envelope (the staged pyramid).
HOST_H1 = "lrf: gravity\nmetric: combination\n"
HOST_H2 = ("descriptor: fpfh\nkeypoint: iss\nmatching: lr\nmetric: weighted_closest_plane\n"
           "weight: exp_curvature\n")
HOST_H3 = "descriptor: rops\n"
HOST_H4 = "descriptor: usc\nlrf: gt\n"
HOST_H5 = "descriptor: fpfh\nlrf: gt\nmatching: one_sided\n"
HOST_H6 = "lrf: gravity\nbf16_matching: true\n"
# the forms the host process launches (K2-K4, K5's full pass, K7 in both
# forms; K1 in H6's staged pyramid) and those it never runs (K1's slot list:
# the loader's and the host levels' normals are kNN; K5's subset form: H6 is
# SHOT; K6: the host keypoints are not rows of a level surface)
HOST_ON = ("iss_count_cuda", "iss_saliency_cuda", "iss_nms_cuda", "spfh_cuda", "nn_l2_cuda",
           "nn_l2_bf16_cuda", "surface_cuda")
HOST_OFF = ("surface_at_cuda", "spfh_at_cuda", "combine_cuda", "combine_at_cuda")
HOST_ROWS = [("shot", "ransac"), ("fpfh", "ransac"), ("fpfh", "gror"), ("rops", "ransac"),
             ("usc", "ransac"), ("fpfh", "ransac"), ("shot", "ransac")]


def host_run(d: Path, fr: float) -> dict:
    """H1-H6 (H2 with RANSAC and GROR) as one `alignment` process over a
    `tests:` list on the scans in d; every result row held to the success
    rules.  Returns the run (seconds, launches, densities)."""
    h2 = HOST_H2 + f"feature_radius: {fr!r}\n"
    (d / "host.yaml").write_text("tests:\n" + "".join(
        "    - test:\n" + "".join(f"        {ln}\n" for ln in (CLI_SCENE + body).strip().splitlines())
        for body in (HOST_H1, h2 + "alignment: [ransac, gror]\n", HOST_H3, HOST_H4, HOST_H5,
                     HOST_H6)))
    run = run_cli(d, "alignment", "host.yaml", "alignment_host_1m")
    rows = cli_results(d, len(HOST_ROWS))
    assert [(r["descriptor"], r["alignment_type"]) for r in rows] == HOST_ROWS, rows
    assert [r["lrf_type"] for r in rows[3:]] == ["default", "gt", "gt", "gravity"], rows
    assert rows[5]["matching_type"] == "one_sided", rows[5]
    got = run["launches"]
    assert all(got.get(w, 0) > 0 for w in HOST_ON), f"host path: a kernel never ran: {got}"
    assert all(got[w] == 0 for w in HOST_OFF), f"host path: a form off its path ran: {got}"
    return run


HOST_CONFIGS = (("host_h1", HOST_H1), ("host_h2", HOST_H2), ("host_h3", HOST_H3),
                ("host_h4", HOST_H4), ("host_h6", HOST_H6))


def host_captures(d: Path, fr: float, dev):
    """One launch each of K2 (with its plan, for K3 and K4), K2 on the r / 5
    plan of a level surface (RoPS's counts), K5's full pass and K7 at D =
    33, 135, 352 and 1,960 and in its bf16 form, captured at the shapes the
    host path gives them: the loader, then the correspondence search of H1
    (SHOT), H2 (FPFH at radius fr), H3 (RoPS) and H4 (USC) and the staged
    registration of H6 (bf16) run in this process on the scans in d, with
    each wrapper wrapped by a recorder.  Returns ({wrapper or nn_l2_d<D> or
    radius_counts: its first call's arguments}, the source's ISS radius,
    the loaded pair (src, tgt, its loader outputs) for host_extras)."""
    from lidar_global_registration_tpu_torch.models import pipeline as tp
    from lidar_global_registration_tpu_torch.models.pyramid import (
        feature_based_correspondence_search,
    )
    from lidar_global_registration_tpu_torch.ops import cellgrid, nn_l2
    from lidar_global_registration_tpu_torch.utils.config import Config

    for name, body in HOST_CONFIGS:
        cli_config(d, name, body + (f"feature_radius: {fr!r}\n" if name == "host_h2" else ""))
    got = {}
    specs = [(cellgrid, "iss_count_cuda", None), (cellgrid, "spfh_cuda", None),
             (cellgrid, "radius_counts", None),
             (nn_l2, "nn_l2_cuda", lambda q, *_a: f"nn_l2_d{q.shape[1]}"),
             (nn_l2, "nn_l2_bf16_cuda", None)]
    with recorder(got, specs), contextlib.chdir(d):
        loaded = tp.load_point_clouds(Config.load("host_h1.yaml"), dev)
        (_tn, src, tgt, _fs, _ft, ds, dt, na, vps, vpt) = loaded
        radii = []
        for name, _body in HOST_CONFIGS:
            config = Config.load(f"{name}.yaml")
            (params,) = tp.parameters_from_config(config, ds, dt, na, vps, vpt)
            params = params.replace(ground_truth=np.asarray(tp.ground_truth(config)))
            radii.append(float(params.iss_radius_src))  # K2's first launch: H1's source
            if name == "host_h6":
                res = tp.align_point_clouds(src, tgt, params, save_artifacts=False, device=dev)
                log(f"#   {name} staged in this process: converged={res.converged}, "
                    f"{int(res.correspondences.count())} correspondences")
                continue
            c = feature_based_correspondence_search(src, tgt, params)
            log(f"#   {name} search in this process: {int(c.count())} correspondences")
    want = {"iss_count_cuda", "spfh_cuda", "radius_counts", "nn_l2_d33", "nn_l2_d135",
            "nn_l2_d352", "nn_l2_d1960", "nn_l2_bf16_cuda"}
    assert want <= got.keys(), got.keys()
    return got, radii[0], (src, tgt, ds, dt, na, vps, vpt)


def spfh_record(name: str, plan_f, r2f, cen) -> dict:
    """K5's full pass on one captured plan against its plain version: equal
    pair counts, bin-edge moves only."""
    import torch

    from lidar_global_registration_tpu_torch.ops import cellgrid as cg

    sp_k, c_k = cg.spfh_cuda(plan_f, r2f, cen)
    (sp_p, c_p), k5_plain_ms = timed_once(lambda: cg.spfh_plain(plan_f, r2f, cen))
    assert torch.equal(c_k, c_p), f"K5 ({name}) pair counts differ"
    f5 = frac_off(sp_k, sp_p)
    assert f5 < 1e-3, f"K5 ({name}): {f5:.2e} off by > 0.5"
    rec = dict(
        name=name, route="cuda", source="lidar_global_registration_tpu_torch/csrc/fpfh.cu",
        replaces="lidar_global_registration_tpu/ops/pallas/cellgrid.py:1554",
        max_abs_err=float((sp_k - sp_p).abs().max()), queries=int(plan_f.n_valid),
        ms=cuda_ms(lambda: cg.spfh_cuda(plan_f, r2f, cen), 5), plain_ms=k5_plain_ms,
        **stencil_bound("spfh", plan_f, c_p.sum(), tbytes(
            plan_f.pts, plan_f.nrm, plan_f.cell_of, plan_f.cols, sp_k, c_k)), library_ms=None)
    log(f"# K5 {name} ok: {plan_f.n_valid} surface rows, frac_off={f5:.2e}, {rec['ms']:.4f} ms")
    return rec


def nn_record(name: str, q, t, tv, bf16: bool = False) -> dict:
    """K7 (or its bf16 form) on one captured input against its plain
    version: equal indices, equal distances at D = 33 and 352 in float32
    (wider products and the rounded copies: d2 to a few float32 roundings
    of the expansion)."""
    import torch

    from lidar_global_registration_tpu_torch.ops import nn_l2

    D = int(q.shape[1])
    kernel = nn_l2.nn_l2_bf16_cuda if bf16 else nn_l2.nn_l2_cuda
    d2k, ik = kernel(q, t, tv)
    d2p, ip = nn_l2.nn_l2_plain(q, t, tv, bf16=bf16)
    assert torch.equal(ik, ip), f"K7 ({name}) indices differ"
    if D in (33, 352) and not bf16:
        assert torch.equal(d2k, d2p), f"K7 ({name}) distances differ"
    torch.testing.assert_close(d2k, d2p, rtol=1e-5, atol=1e-5)
    ql, tl = (nn_l2.bf16_round(q), nn_l2.bf16_round(t)) if bf16 else (q, t)
    rec = dict(
        name=name, route="cuda", source="lidar_global_registration_tpu_torch/csrc/nn_l2.cu",
        replaces="lidar_global_registration_tpu/ops/pallas/topk_l2.py:26",
        max_abs_err=float((d2k - d2p).abs().max()),
        shape=[int(q.shape[0]), int(t.shape[0]), D], valid_train=int(tv.sum()),
        ms=cuda_ms(lambda: kernel(q, t, tv), 10),
        plain_ms=cuda_ms(lambda: nn_l2.nn_l2_plain(q, t, tv, bf16=bf16), 2),
        **nn_bound(q, t, tv, d2k, ik), library_ms=cuda_ms(lambda: library_nn(ql, tl, tv), 2))
    log(f"# K7 {name} ok: {q.shape[0]} x {t.shape[0]} rows, D = {D}, indices exact, "
        f"{rec['ms']:.4f} ms")
    return rec


def host_records(got: dict, r_iss: float) -> list[dict]:
    """The host path's captured launches against their plain versions: K2
    and K4 exact (K2 also on the r / 5 plan), K3 within saliency_err's
    bounds (on the same plan), K5's full pass with equal pair counts and
    bin-edge moves only, K7 with equal indices at every width and in its
    bf16 form (equal distances too at D = 33 and 352)."""
    import torch

    from lidar_global_registration_tpu_torch.ops import cellgrid as cg

    pallas = "lidar_global_registration_tpu/ops/pallas/cellgrid.py:"
    plan, _r2 = got["iss_count_cuda"]
    records = iss_records(plan, r_iss, "_host")
    records.append(spfh_record("spfh_host", *got["spfh_cuda"]))
    # K2 on the r / 5 plan of a level surface (the RoPS / USC weights):
    # integer counts and their reciprocals, exact
    xyz5, valid5, r5 = got["radius_counts"]
    plan5 = cg.plan_grid(xyz5, valid5, r5)
    r25 = cg._f32_square(r5)
    (c_k, inv_k), (c_p, inv_p) = cg.iss_count_cuda(plan5, r25), cg.iss_count_plain(plan5, r25)
    assert torch.equal(c_k, c_p) and torch.equal(inv_k, inv_p), "K2 (r / 5 plan) differs"
    records.append(dict(
        name="iss_count_r5", route="cuda", source="lidar_global_registration_tpu_torch/csrc/iss.cu",
        replaces=pallas + "1322", max_abs_err=float((c_k - c_p).abs().max()),
        queries=int(plan5.n_valid), radius=float(r5),
        ms=cuda_ms(lambda: cg.iss_count_cuda(plan5, r25), 5),
        plain_ms=cuda_ms(lambda: cg.iss_count_plain(plan5, r25), 1),
        **stencil_bound("iss_count", plan5, c_p.sum(), tbytes(
            plan5.pts, plan5.cell_of, plan5.cols, c_k, inv_k)), library_ms=None))
    log(f"# K2 iss_count_r5 ok: {plan5.n_valid} level-surface rows at r/5 = {r5:.4f}, mean count "
        f"{float(c_p.float().mean()):.2f}, exact, {records[-1]['ms']:.4f} ms")
    for D in (33, 135, 352, 1960):
        records.append(nn_record(f"nn_l2_host_d{D}", *got[f"nn_l2_d{D}"]))
    records.append(nn_record("nn_l2_bf16_host", *got["nn_l2_bf16_cuda"], bf16=True))
    return records


def held_to_rules(label: str, src, tgt, T, T_gt, thr: float, converged: bool) -> dict:
    """A host result held to the success rules (main.cpp:312-382):
    converged, r_err < 0.05 rad, t_err and overlap_rmse < distance_thr."""
    import torch

    from lidar_global_registration_tpu_torch.analysis import overlap_rmse
    from lidar_global_registration_tpu_torch.ops.transform import rotation_translation_error

    r, t = (float(v) for v in rotation_translation_error(
        torch.as_tensor(np.asarray(T, np.float32)), torch.as_tensor(np.asarray(T_gt, np.float32))))
    ov = overlap_rmse(src, tgt, T, T_gt, thr)
    log(f"#   {label}: converged={converged} r_err={r:.5f} t_err={t:.4f} overlap_rmse={ov:.4f} "
        f"thr={thr:g}")
    assert converged and r < R_ERR_MAX and t < thr and ov < thr, label
    return dict(r_err=r, t_err=t, overlap_rmse=ov)


def _turn_z(T, degrees: float, shift) -> np.ndarray:
    c, s = np.cos(np.deg2rad(degrees)), np.sin(np.deg2rad(degrees))
    D = np.eye(4)
    D[:2, :2] = [[c, -s], [s, c]]
    D[:3, 3] = shift
    return (D @ np.asarray(T, np.float64)).astype(np.float32)


HOST_GUESS = "descriptor: fpfh\nkeypoint: iss\nmatching: lr\nmetric: uniformity\n"


def host_extras(d: Path, fr: float, dev, loaded) -> dict:
    """Three more host-path phases on the loaded 1M pair, in this process,
    each with its launch counters set to 0 before it and required to rise:
    (1) align_point_clouds with an initial guess (the ground truth turned
    by 2 degrees about z and moved by distance_thr along x; FPFH at the
    fixed radius fr, lr matching, uniformity): the local matcher with a
    search radius 1.25 x the guess's largest displacement of a source point;
    (2) GROR's own preparation (voxel, kNN-30 normals, ISS, FPFH, mutual
    1-NN) at resolution = the larger density the loader printed (the
    preprocessed clouds' spacing), then align_gror at distance_thr; (3) the
    hypothesis pool: choose_best_hypothesis over the prepared
    correspondences and a pool of two turned poses and the ground truth,
    which must win (it runs no kernel: its overlap queries are PyTorch).
    Each phase reads every wrapper's counter: the forms it needs must rise,
    every other form must stay at 0.  GROR's preparation runs under the
    recorder, which keeps the first call of K2 (its plan, for K3 and K4),
    K5's full pass and K7 for gror_records.  Each pose is held to the
    success rules.  Returns (each phase's launches and seconds, the
    captured calls, the ISS radius of GROR's preparation)."""
    import torch

    from lidar_global_registration_tpu_torch.models import pipeline as tp
    from lidar_global_registration_tpu_torch.models.gror import align_gror, gror_preparation
    from lidar_global_registration_tpu_torch.models.hypotheses import choose_best_hypothesis
    from lidar_global_registration_tpu_torch.ops import cellgrid, nn_l2
    from lidar_global_registration_tpu_torch.utils.config import Config

    src, tgt, ds, dt, na, vps, vpt = loaded
    iss = ("iss_count_cuda", "iss_saliency_cuda", "iss_nms_cuda")
    out, captured = {}, {}

    def phase(label, need, fn):
        zero_counters()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        dt_s = time.perf_counter() - t0
        got = read_counters()
        log(f"#   {label}: {dt_s:.3f} s, launches {got}")
        check_counts(label, got, need)
        out[label] = dict(seconds=dt_s, launches=got)
        return result

    cli_config(d, "host_guess", HOST_GUESS + f"feature_radius: {fr!r}\n")
    with contextlib.chdir(d):
        config = Config.load("host_guess.yaml")
        (params,) = tp.parameters_from_config(config, ds, dt, na, vps, vpt)
        T_gt = np.asarray(tp.ground_truth(config), np.float32)
        thr = float(params.distance_thr)
        G = _turn_z(T_gt, 2.0, [thr, 0.0, 0.0])
        moved = lambda T: torch.stack(  # noqa: E731
            [sum(float(T[i, j]) * src.xyz[:, j] for j in range(3)) + float(T[i, 3])
             for i in range(3)], 1)[src.valid]
        reach = float((moved(G) - moved(T_gt)).norm(dim=1).max())
        params = params.replace(guess=G, match_search_radius=1.25 * reach, ground_truth=T_gt)
        log(f"# guess: the GT turned 2 deg about z and moved by {thr:g}; moves a source point "
            f"by up to {reach:.4f}, match_search_radius {1.25 * reach:.4f}")
        # the host path with FPFH at a fixed radius: ISS (K2-K4) and K5's
        # full pass; both directions' matches are the local matcher's (no K7)
        res = phase("host_guess", (*iss, "spfh_cuda"), lambda: tp.align_point_clouds(
            src, tgt, params, save_artifacts=False, device=dev))
        out["host_guess"].update(held_to_rules("guess", src, tgt, res.transformation, T_gt, thr,
                                               res.converged),
                                 correspondences=int(res.correspondences.count()),
                                 time_cs=res.time_cs, time_te=res.time_te)

        def prep():
            sd, td, corrs = gror_preparation(src, tgt, max(ds, dt))
            return sd, td, corrs, align_gror(sd, td, corrs, params)

        specs = [(cellgrid, "iss_count_cuda", None), (cellgrid, "spfh_cuda", None),
                 (nn_l2, "nn_l2_cuda", None)]
        with recorder(captured, specs):
            sd, td, corrs, gres = phase("gror_prep", (*iss, "spfh_cuda", "nn_l2_cuda"), prep)
        out["gror_prep"].update(held_to_rules("gror_preparation + align_gror", sd, td,
                                              gres.transformation, T_gt, thr, gres.converged),
                                rows=[int(sd.count()), int(td.count())],
                                correspondences=int(corrs.count()))
        pool = [_turn_z(T_gt, 3.0, [2 * thr, 0, 0]), T_gt, _turn_z(T_gt, -4.0, [0, 2 * thr, 0])]
        best = phase("hypotheses", (), lambda: choose_best_hypothesis(
            sd, td, corrs, params.replace(testname="host_pool"), pool))
        assert np.array_equal(np.asarray(best), T_gt), "the hypothesis pool: the GT lost"
        rows = (d / "data/debug/test_hypotheses.csv").read_text().strip().splitlines()
        for ln in rows[-4:]:
            log(f"#   hypothesis {ln}")
    return out, captured, 2.0 * max(ds, dt)


def gror_records(got: dict, r_iss: float) -> list[dict]:
    """GROR's preparation's first launches on the voxel-downsampled 1M
    clouds against their plain versions: K2-K4 on its ISS plan at 2 x
    resolution (iss_records' checks), K5's full pass at 8 x resolution, K7
    on the keypoints' FPFH-33 (equal indices and distances)."""
    plan, _r2 = got["iss_count_cuda"]
    records = iss_records(plan, r_iss, "_gror")
    records.append(spfh_record("spfh_gror", *got["spfh_cuda"]))
    records.append(nn_record("nn_l2_gror", *got["nn_l2_cuda"]))
    return records


def one_graph_phase(dev, a, b, vp_a, vp_b, T_gt, radii) -> dict:
    """The JAX package's one-graph entry points on the bench's 65,536-point
    keypoint-any pair (bench.py:177-190, its settings bench.py:238-256):
    register_pair_step, register_pair_two_stage and register_pair_staged's
    grid-hash route (use_cell_fpfh=False), each a warm-up and 3 repeats
    held to the bench's rule (bench.py:327), every counter set to 0 before
    and read after: K5's full pass and K7 must rise, every other form (K1,
    ISS with use_iss=False, K6, the bf16 form) stay at 0.  Returns each
    entry's launches and seconds."""
    import dataclasses

    import torch

    from lidar_global_registration_tpu_torch.models import flagship as fl
    from lidar_global_registration_tpu_torch.types import SEED

    cfg = fl.FlagshipConfig(rounds=8, hypothesis_batch=1024, use_iss=False, match_tile=4096,
                            metric="correspondences")
    A, B = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    ones = torch.ones(A.shape[0], dtype=torch.bool, device=dev)
    args = [radii[k] for k in RADII_KEYS]
    vps = dict(vp_src=torch.from_numpy(vp_a).to(dev), vp_tgt=torch.from_numpy(vp_b).to(dev))
    entries = {
        "step": lambda X, g: fl.register_pair_step(X, ones, B, ones, g, *args, cfg=cfg, **vps),
        "two_stage": lambda X, g: fl.register_pair_two_stage(X, ones, B, ones, g, *args, cfg=cfg,
                                                             **vps),
        "grid_hash": lambda X, g: fl.register_pair_staged(
            X, ones, B, ones, g, *args, cfg=dataclasses.replace(cfg, use_cell_fpfh=False),
            **vps),
    }
    out = {}
    for name, run in entries.items():
        zero_counters()
        run(A, torch.Generator(device=dev).manual_seed(SEED))  # warm-up
        secs = []
        for r in range(REPEATS):
            t0 = time.perf_counter()
            o = run(A + 1e-5 * (r + 1), torch.Generator(device=dev).manual_seed(SEED + r))
            o["transformation"].cpu()
            secs.append(time.perf_counter() - t0)
            r_err, t_err, finite = pose_error(o, T_gt)
            conv = bool(o["converged"])
            ok = conv and r_err < R_ERR_MAX and t_err < radii["thr"] and finite
            log(f"# {name} repeat {r} n={A.shape[0]}: {secs[-1]:.4f} s converged={conv} "
                f"r_err={r_err:.5f} t_err={t_err:.4f} corr={float(o['n_correspondences']):.0f} "
                f"inliers={int(o['inliers'])} ok={ok}")
            assert ok, f"{name} repeat {r} failed the bench's success rule"
        got = read_counters()
        check_counts(name, got, ("spfh_cuda", "nn_l2_cuda"))
        out[name] = dict(seconds=secs, launches=got)
    log(f"# one-graph entry points: {out}")
    return out


TURNS = [(0.0, [0.0, 0.0, 0.0]), (30.0, [5.0, -3.0, 1.0]), (-45.0, [-8.0, 2.0, 0.5]),
         (90.0, [0.0, 10.0, -2.0])]


def batch_pairs(dev, a, b, vp_a, vp_b, radii):
    """The batch of four pairs on `dev`: copies of the pair (a, b), the
    target of each turned about z and shifted by its own known transform
    M_b of TURNS (so its ground truth is M_b T_gt), seeds SEED + b.  Returns
    (src, valid, tgt, scalars, vps, seeds, Ms)."""
    import torch

    from lidar_global_registration_tpu_torch.types import SEED

    Ms = [_turn_z(np.eye(4), deg, shift).astype(np.float64) for deg, shift in TURNS]
    n = a.shape[0]
    src = torch.from_numpy(np.stack([a] * 4)).to(dev)
    tgt = torch.from_numpy(np.stack([(b @ M[:3, :3].T + M[:3, 3]).astype(np.float32)
                                     for M in Ms])).to(dev)
    valid = torch.ones((4, n), dtype=torch.bool, device=dev)
    scalars = torch.tensor([[radii[k] for k in RADII_KEYS]] * 4, dtype=torch.float32,
                           device=dev)
    vps = torch.from_numpy(np.stack([
        np.stack([vp_a, (M[:3, :3] @ vp_b + M[:3, 3]).astype(np.float32)]) for M in Ms])).to(dev)
    return src, valid, tgt, scalars, vps, [SEED + i for i in range(4)], Ms


def batch_phase(dev, a, b, vp_a, vp_b, T_gt, radii) -> dict:
    """The batched-pairs API (parallel/batch.make_register_batch) at B = 4 on
    the bench's 65,536-point keypoint-any pair with one_graph_phase's
    settings: four copies of the pair, the target of each turned about z and
    shifted by its own known transform M_b (so its ground truth is M_b
    T_gt), seeds SEED + b, after a warm-up of one pair.  Every counter is
    set to 0 before the batch and read after it: K5's full pass and K7 must
    rise, every other form stay at 0.  Each pair's (T, inliers,
    n_correspondences) must be torch.equal to register_pair_step's on the
    same pair and seed, and each pair must meet the bench's rule
    (bench.py:327; `converged` from the step).  Returns the batch's
    launches and its seconds a pair beside the step's."""
    import torch

    from lidar_global_registration_tpu_torch.models import flagship as fl
    from lidar_global_registration_tpu_torch.parallel.batch import make_register_batch

    cfg = fl.FlagshipConfig(rounds=8, hypothesis_batch=1024, use_iss=False, match_tile=4096,
                            metric="correspondences")
    src, valid, tgt, scalars, vps, seeds, Ms = batch_pairs(dev, a, b, vp_a, vp_b, radii)
    n = a.shape[0]
    step = make_register_batch(None, cfg)
    step(src[:1], valid[:1], tgt[:1], valid[:1], seeds[:1], scalars[:1], vps[:1])  # warm-up
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    T, inl, nc = step(src, valid, tgt, valid, seeds, scalars, vps)
    T.cpu()
    batch_s = (time.perf_counter() - t0) / 4
    got = read_counters()
    check_counts("batch", got, ("spfh_cuda", "nn_l2_cuda"))
    step_s = []
    for i in range(4):
        t0 = time.perf_counter()
        o = fl.register_pair_step(src[i], valid[i], tgt[i], valid[i],
                                  torch.Generator(device=dev).manual_seed(seeds[i]),
                                  *scalars[i].tolist(), vp_src=vps[i, 0], vp_tgt=vps[i, 1],
                                  cfg=cfg)
        o["transformation"].cpu()
        step_s.append(time.perf_counter() - t0)
        same = (torch.equal(T[i], o["transformation"]) and torch.equal(inl[i], o["inliers"])
                and torch.equal(nc[i], o["n_correspondences"]))
        r_err, t_err, finite = pose_error({"transformation": T[i]}, (Ms[i] @ T_gt).astype(
            np.float32))
        conv = bool(o["converged"])
        ok = conv and r_err < R_ERR_MAX and t_err < radii["thr"] and finite
        log(f"# batch pair {i} (turn {TURNS[i][0]:g} deg): converged={conv} r_err={r_err:.5f} "
            f"t_err={t_err:.4f} inliers={int(inl[i])} corr={float(nc[i]):.0f} "
            f"equal to the step: {same}; step {step_s[-1]:.4f} s")
        assert same, f"batch pair {i}: not torch.equal to register_pair_step"
        assert ok, f"batch pair {i} failed the bench's success rule"
    log(f"# batch B=4 n={n}: {batch_s:.4f} s a pair (register_pair_step "
        f"{np.mean(step_s):.4f} s a pair); launches {got}")
    return dict(launches=got, seconds_per_pair=batch_s,
                step_seconds_per_pair=float(np.mean(step_s)))


# the mesh phase: the ('dp', 'tp') batch step (parallel/mesh.py, batch.py)
MESH_DIR = ROOT / "chiprun_out" / "mesh"
MESH_TIMEOUT = 600  # seconds for the tp = 2 ranks' whole run
AT_FORMS = ("iss_count_at_cuda", "iss_saliency_at_cuda", "iss_nms_at_cuda")


def mesh_cfgs() -> dict:
    """The mesh phase's configurations, batch_phase's settings: FPFH with
    ISS keypoints and cluster matching (K2-K4 and K5 at the shard's rows, K7
    on train shards, the keypoint kNN with the self row left out), and
    batch_phase's keypoint-any FPFH with mutual matching."""
    from lidar_global_registration_tpu_torch.models.flagship import FlagshipConfig

    base = dict(rounds=8, hypothesis_batch=1024, match_tile=4096, metric="correspondences")
    return {"iss": FlagshipConfig(use_iss=True, **base),
            "any": FlagshipConfig(use_iss=False, **base)}


# the forms each configuration's tp step launches; every other stays at 0
MESH_NEED = {"iss": AT_FORMS + ("spfh_at_cuda", "nn_l2_cuda"),
             "any": ("spfh_at_cuda", "nn_l2_cuda")}


def mesh_batches(mesh, dev, inp: dict, label: str) -> dict:
    """Each configuration's batch over `mesh` on the pairs of `inp`: a
    warm-up of one pair, then the 4 pairs with every counter set to 0 just
    before and read just after; first iss_split_ms.  Returns {config: T,
    inliers, n_corr (on the CPU), seconds a pair, launches} and iss_ms."""
    import torch
    import torch.distributed as dist

    from lidar_global_registration_tpu_torch.parallel.batch import make_register_batch

    src, valid, tgt, scalars, vps = (inp[k].to(dev) for k in ("src", "valid", "tgt", "scalars",
                                                               "vps"))
    seeds = inp["seeds"]
    out = {"iss_ms": iss_split_ms(mesh.get_group("tp"), dev, inp)}
    log(f"# mesh {label} ISS of one side: {out['iss_ms']}")
    for name, cfg in mesh_cfgs().items():
        step = make_register_batch(mesh, cfg)
        step(src[:1], valid[:1], tgt[:1], valid[:1], seeds[:1], scalars[:1], vps[:1])  # warm-up
        torch.cuda.synchronize()
        dist.barrier()
        zero_counters()
        t0 = time.perf_counter()
        T, inl, nc = step(src, valid, tgt, valid, seeds, scalars, vps)
        T = T.cpu()
        secs = (time.perf_counter() - t0) / len(seeds)
        out[name] = dict(T=T, inliers=inl.cpu(), n_corr=nc.cpu(), seconds_per_pair=secs,
                         launches=read_counters())
        log(f"# mesh {label} {name}: {secs:.4f} s a pair; launches {out[name]['launches']}")
    return out


def mesh_worker(rank: int, world: int, store: str, out: str) -> int:
    """One rank of the tp = `world` batch on the card (`python3
    chip_smoke.py --mesh-rank RANK WORLD STORE DIR`): the processes share
    cuda:0 over gloo (NCCL refuses two ranks on one device), rendezvous at
    the FileStore `store`, read the batch from DIR/batch.pt and write their
    results to DIR/rank<RANK>.pt."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from lidar_global_registration_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT))
    try:
        res = mesh_batches(make_mesh(world, tp=world), dev,
                           torch.load(Path(out) / "batch.pt"), f"tp={world} rank {rank}")
        torch.save(res, Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def run_ranks(world: int, d: Path) -> list[dict]:
    """The tp = `world` ranks as processes of this script; fails when one
    exits non-zero or they outlast MESH_TIMEOUT, and stops every rank
    left.  Returns each rank's results."""
    import torch

    store = d / "store"
    store.unlink(missing_ok=True)
    procs = []
    try:
        for r in range(world):
            log_f = open(d / f"rank{r}.log", "w")
            procs.append((log_f, subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank", str(r), str(world),
                 str(store), str(d)], stdout=log_f, stderr=subprocess.STDOUT, cwd=str(ROOT))))
        deadline = time.monotonic() + MESH_TIMEOUT
        while any(p.poll() is None for _f, p in procs):
            failed = [r for r, (_f, p) in enumerate(procs) if p.poll() not in (None, 0)]
            assert not failed and time.monotonic() < deadline, (
                f"mesh ranks {failed or 'timed out'}: "
                + " | ".join((d / f"rank{r}.log").read_text()[-3000:] for r in range(world)))
            time.sleep(0.2)
        assert all(p.returncode == 0 for _f, p in procs), "a mesh rank failed"
    finally:
        for log_f, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log_f.close()
    for r in range(world):
        log(f"# mesh rank {r} log: " + " / ".join(
            ln for ln in (d / f"rank{r}.log").read_text().splitlines() if ln.startswith("# mesh")))
    return [torch.load(d / f"rank{r}.pt") for r in range(world)]


def at_records(plan, r_iss: float, suffix: str) -> list[dict]:
    """K2-K4's slot-list forms on one plan at each half of its input rows
    (their slots ascending, as cellgrid.iss_pass launches them): against
    the full forms' rows at those slots (bit for bit: the tp step
    rests on it) and against the slot-list plain versions (K2 and K4 exact,
    K3 within saliency_err's bounds); each record's times and bound are the
    mean over the two halves' launches."""
    import torch

    from lidar_global_registration_tpu_torch.ops import cellgrid as cg

    r2 = cg._f32_square(r_iss)
    N = plan.order.shape[0]
    slot = cg.slot_of(plan)
    halves = [torch.sort(h[h >= 0]).values for h in (slot[:N // 2], slot[N // 2:])]
    c_f, inv_f = cg.iss_count_cuda(plan, r2)
    s_f, ok_f, nb_f = cg.iss_saliency_cuda(plan, r2, inv_f, 0.975, 0.975)
    kp_f = cg.iss_nms_cuda(plan, r2, s_f, ok_f, 4)
    acc = {k: dict(ms=[], plain_ms=[], bound=[], err=[]) for k in ("count", "saliency", "nms")}
    for sl in halves:
        sl32 = sl.to(torch.int32)
        out_i = torch.empty(sl.shape, dtype=torch.int32, device=sl.device)
        # K2
        c_k, inv_k = cg.iss_count_at_cuda(plan, r2, sl)
        assert torch.equal(c_k, c_f[sl]) and torch.equal(inv_k, inv_f[sl]), "K2 at != full"
        (c_p, inv_p), p_ms = timed_once(lambda: cg.iss_count_at_plain(plan, r2, sl))
        assert torch.equal(c_k, c_p) and torch.equal(inv_k, inv_p), "K2 at != its plain version"
        a = acc["count"]
        a["ms"].append(cuda_ms(lambda: cg.iss_count_at_cuda(plan, r2, sl), 5))
        a["plain_ms"].append(p_ms)
        a["err"].append(float((c_k - c_p).abs().max()) if sl.numel() else 0.0)
        a["bound"].append(stencil_bound("iss_count", plan, c_p.sum(), tbytes(
            plan.pts, plan.cell_of, plan.cols, sl32, out_i, c_k, inv_k), slots=sl))
        # K3 on the full pass's weights
        got = cg.iss_saliency_at_cuda(plan, r2, inv_f, 0.975, 0.975, sl)
        assert all(torch.equal(g, f[sl]) for g, f in zip(got, (s_f, ok_f, nb_f))), "K3 at != full"
        want, p_ms = timed_once(lambda: cg.iss_saliency_at_plain(plan, r2, inv_f, 0.975, 0.975,
                                                                 sl))
        err, _flips = saliency_err(got, want, r2, "iss_saliency_at" + suffix)
        a = acc["saliency"]
        a["ms"].append(cuda_ms(lambda: cg.iss_saliency_at_cuda(plan, r2, inv_f, 0.975, 0.975, sl),
                               5))
        a["plain_ms"].append(p_ms)
        a["err"].append(err)
        a["bound"].append(stencil_bound("iss_saliency", plan, want[2].sum(), tbytes(
            plan.pts, plan.cell_of, plan.cols, inv_f, sl32, out_i, *got), slots=sl))
        # K4 on the full pass's saliency
        kp_k = cg.iss_nms_at_cuda(plan, r2, s_f, ok_f[sl], 4, sl)
        assert torch.equal(kp_k, kp_f[sl]), "K4 at != full"
        kp_p, p_ms = timed_once(lambda: cg.iss_nms_at_plain(plan, r2, s_f, ok_f[sl], 4, sl))
        assert torch.equal(kp_k, kp_p), "K4 at != its plain version"
        a = acc["nms"]
        a["ms"].append(cuda_ms(lambda: cg.iss_nms_at_cuda(plan, r2, s_f, ok_f[sl], 4, sl), 5))
        a["plain_ms"].append(p_ms)
        a["err"].append(float((kp_k != kp_p).sum()))
        a["bound"].append(stencil_bound("iss_nms", plan, nb_f[sl].sum(), tbytes(
            plan.pts, plan.cell_of, plan.cols, s_f, ok_f[sl], sl32, out_i, kp_k), slots=sl))
    records = []
    for kind, line in (("count", "1322"), ("saliency", "1344"), ("nms", "1410")):
        a = acc[kind]
        bound_ms = [b["bound_ms"] for b in a["bound"]]
        records.append(dict(
            name=f"iss_{kind}_at{suffix}", route="cuda",
            source="lidar_global_registration_tpu_torch/csrc/iss.cu",
            replaces="lidar_global_registration_tpu/ops/pallas/cellgrid.py:" + line,
            max_abs_err=max(a["err"]), queries=[int(h.numel()) for h in halves],
            ms=float(np.mean(a["ms"])), ms_halves=a["ms"], plain_ms=float(np.mean(a["plain_ms"])),
            bound_ms=float(np.mean(bound_ms)), bound_by=a["bound"][0]["bound_by"],
            library_ms=None))
        log(f"# K{dict(count=2, saliency=3, nms=4)[kind]} iss_{kind}_at{suffix} ok: halves of "
            f"{N} rows ({records[-1]['queries']} slots), = the full pass's rows, "
            f"{records[-1]['ms']:.4f} ms (bound {records[-1]['bound_ms']:.4f})")
    return records


def shard_records(src, tgt, valid, scalars, vps) -> list[dict]:
    """The tp = 2 step's K5 and K7 launches on the 64k pair (src, tgt) at
    their own shapes, against their plain versions: K5's slot-list form at
    each half's slots of the feature-radius plan (as ops/fpfh.spfh_rows
    launches it: equal pair counts, the full pass's rows, bin-edge moves
    only against the plain version) and K7 from the keypoint-any features,
    65,536 queries against each 32,768-row train shard (equal indices and
    distances).  K5's times and bound are the mean over the two halves."""
    import torch

    from lidar_global_registration_tpu_torch.models import flagship as fl
    from lidar_global_registration_tpu_torch.ops import cellgrid as cg
    from lidar_global_registration_tpu_torch.ops import fpfh

    normal_cell, _ds, _dt, iss_s, iss_t, fr, _thr = fl._radii(*scalars.tolist())
    cfg = mesh_cfgs()["any"]
    N = src.shape[0]
    halves = (slice(0, N // 2), slice(N // 2, N))
    normals, feats = [], []
    for xyz, iss_r, vp in ((src, iss_s, vps[0]), (tgt, iss_t, vps[1])):
        normal, kp, _dens = fl._side_stage(xyz, valid, normal_cell, iss_r, cfg, vp)
        normals.append(normal)
        feats.append(fl._fpfh_fixed(xyz, normal, valid, kp, fr))
    plan = fpfh.surface_plan(src, valid, normals[0], fr)
    r2, cen = cg._f32_square(fr), cg.aabb_centre(plan)
    s_full, c_full = cg.spfh_cuda(plan, r2, cen)
    slot = cg.slot_of(plan)
    acc = dict(ms=[], plain_ms=[], bound=[], err=[], queries=[])
    for h in halves:
        sl = torch.sort(slot[h][slot[h] >= 0]).values
        s_k, c_k = cg.spfh_at_cuda(plan, r2, cen, sl)
        assert torch.equal(c_k[sl], c_full[sl]) and torch.equal(s_k[sl], s_full[sl]), (
            "K5 at (tp half) != its full pass")
        (s_p, c_p), p_ms = timed_once(lambda: cg.spfh_plain(plan, r2, cen, sl))
        assert torch.equal(c_k, c_p), "K5 at (tp half): pair counts differ"
        f5 = frac_off(s_k[sl], s_p[sl])
        assert f5 < 1e-3, f"K5 at (tp half): {f5:.2e} off by > 0.5"
        acc["ms"].append(cuda_ms(lambda: cg.spfh_at_cuda(plan, r2, cen, sl), 5))
        acc["plain_ms"].append(p_ms)
        acc["err"].append(float((s_k - s_p).abs().max()))
        acc["queries"].append(int(sl.numel()))
        acc["bound"].append(stencil_bound("spfh", plan, c_p[sl].sum(), tbytes(
            plan.pts, plan.nrm, plan.cell_of, plan.cols, sl) + sl.numel() * 4 * 34, sl))
    records = [dict(
        name="spfh_at_tp", route="cuda", source="lidar_global_registration_tpu_torch/csrc/fpfh.cu",
        replaces="lidar_global_registration_tpu/ops/pallas/cellgrid.py:1554",
        max_abs_err=max(acc["err"]), queries=acc["queries"], ms=float(np.mean(acc["ms"])),
        ms_halves=acc["ms"], plain_ms=float(np.mean(acc["plain_ms"])),
        bound_ms=float(np.mean([x["bound_ms"] for x in acc["bound"]])),
        bound_by=acc["bound"][0]["bound_by"], library_ms=None)]
    log(f"# K5 spfh_at_tp ok: halves of {N} rows ({acc['queries']} slots) = the full pass's "
        f"rows, {records[0]['ms']:.4f} ms (bound {records[0]['bound_ms']:.4f})")
    (fq, fqv), (ft, ftv) = feats
    for i, h in enumerate(halves):
        records.append(nn_record(f"nn_l2_tp_shard{i}", fq, ft[h].contiguous(), ftv[h]))
    return records


def iss_split_ms(group, dev, inp: dict) -> dict:
    """One side's ISS keypoints (the batch's first source cloud, its ISS
    radius) as this peer of `group` computes them in the tp step
    (cellgrid.iss_pass at its rows: the slot-list forms and the gathers),
    against the full forms over the whole cloud on this peer alone: the
    same keypoints and saliency; the median ms of 5 after a warm-up, the
    peers set off together, the plan built once outside."""
    import torch
    import torch.distributed as dist

    from lidar_global_registration_tpu_torch.ops import cellgrid as cg
    from lidar_global_registration_tpu_torch.parallel.mesh import gather_rows

    xyz, valid = inp["src"][0].to(dev), inp["valid"][0].to(dev)
    r = float(inp["scalars"][0, 3])
    plan = cg.plan_grid(xyz, valid, r)
    tp, ti = dist.get_world_size(group), dist.get_rank(group)
    shard = xyz.shape[0] // tp
    rows = slice(ti * shard, (ti + 1) * shard)
    forms = {"full_ms": lambda: cg.iss_pass(plan, r),
             "split_ms": lambda: cg.iss_pass(plan, r, rows=rows,
                                             gather=lambda x: gather_rows(x, group))}
    want, got = forms["full_ms"](), forms["split_ms"]()
    assert all(torch.equal(g, w) for g, w in zip(got, want)), "ISS at the tp rows != full"
    out = {}
    for name, fn in forms.items():
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            dist.barrier(group)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        out[name] = float(np.median(ts))
    return out


def mesh_phase(dev, a, b, vp_a, vp_b, T_gt, radii, host_plan) -> tuple[list, dict]:
    """The ('dp', 'tp') batch step on the card: K2-K4's slot-list forms
    checked at each half of two plans (the 1M graded scan's preprocessed
    rows on the host path's ISS plan, `host_plan` = (plan, r_iss), and the
    bench's 65,536-point pair on its ISS plan), and the tp step's K5 and K7
    launches at their shapes on that pair (shard_records); then
    batch_phase's four
    pairs through make_register_batch(make_mesh(2, tp=2)), two ranks on this
    card over gloo, and through make_register_batch(make_mesh(1, tp=1)) on
    NCCL at world size 1 in this process, each with mesh_cfgs(): every pair
    torch.equal to register_pair_step (run here) and under the bench's rule,
    each rank's counters set to 0 before its batch and risen after it (K2-K4
    and K5 at the shard's rows and K7 for ISS, K5 and K7 for keypoint-any,
    no other form).  Prints the seconds a pair of tp = 2, tp = 1 and the
    one-process loop (make_register_batch(None, cfg)), and iss_split_ms of
    each rank.  Returns the kernel records and each run's launches."""
    import datetime

    import torch
    import torch.distributed as dist

    from lidar_global_registration_tpu_torch.models import flagship as fl
    from lidar_global_registration_tpu_torch.ops import cellgrid as cg
    from lidar_global_registration_tpu_torch.parallel.batch import make_register_batch
    from lidar_global_registration_tpu_torch.parallel.mesh import make_mesh

    records = at_records(*host_plan, "_1m")
    A = torch.from_numpy(a).to(dev)
    records += at_records(cg.plan_grid(A, torch.ones_like(A[:, 0], dtype=torch.bool),
                                       radii["iss_src"]), radii["iss_src"], "_64k")
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    src, valid, tgt, scalars, vps, seeds, Ms = batch_pairs(dev, a, b, vp_a, vp_b, radii)
    inp = dict(src=src.cpu(), valid=valid.cpu(), tgt=tgt.cpu(), scalars=scalars.cpu(),
               vps=vps.cpu(), seeds=seeds)
    torch.save(inp, MESH_DIR / "batch.pt")
    records += shard_records(src[0], tgt[0], valid[0], scalars[0], vps[0])
    ref, loop_s = {}, {}
    for name, cfg in mesh_cfgs().items():
        ref[name] = [fl.register_pair_step(src[i], valid[i], tgt[i], valid[i],
                                           torch.Generator(device=dev).manual_seed(seeds[i]),
                                           *scalars[i].tolist(), vp_src=vps[i, 0],
                                           vp_tgt=vps[i, 1], cfg=cfg) for i in range(4)]
        loop = make_register_batch(None, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop(src, valid, tgt, valid, seeds, scalars, vps)[0].cpu()
        loop_s[name] = (time.perf_counter() - t0) / 4
    t0 = time.perf_counter()
    runs = {f"tp2_rank{r}": res for r, res in enumerate(run_ranks(2, MESH_DIR))}
    log(f"# mesh tp=2: two ranks on one card over gloo, {time.perf_counter() - t0:.1f} s "
        f"with their start-up")
    store = MESH_DIR / "store_nccl"
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT))
    try:
        runs["tp1_nccl"] = mesh_batches(make_mesh(1, tp=1), dev, inp, "tp=1 nccl")
    finally:
        dist.destroy_process_group()
    launches = {}
    for run, res in runs.items():
        for name in mesh_cfgs():
            got = res[name]
            check_counts(f"mesh {run} {name}", got["launches"], MESH_NEED[name])
            launches[f"mesh_{run}_{name}"] = dict(launches=got["launches"])
            for i, o in enumerate(ref[name]):
                same = (torch.equal(got["T"][i], o["transformation"].cpu())
                        and torch.equal(got["inliers"][i], o["inliers"].cpu())
                        and torch.equal(got["n_corr"][i], o["n_correspondences"].cpu()))
                r_err, t_err, finite = pose_error({"transformation": got["T"][i]},
                                                  (Ms[i] @ T_gt).astype(np.float32))
                ok = bool(o["converged"]) and r_err < R_ERR_MAX and t_err < radii["thr"] and finite
                log(f"# mesh {run} {name} pair {i}: r_err={r_err:.5f} t_err={t_err:.4f} "
                    f"inliers={int(got['inliers'][i])} corr={float(got['n_corr'][i]):.0f} "
                    f"equal to the step: {same}")
                assert same, f"mesh {run} {name} pair {i}: not torch.equal to register_pair_step"
                assert ok, f"mesh {run} {name} pair {i} failed the bench's success rule"
    gpu = gpu_line()
    for name in mesh_cfgs():
        log(f"# mesh {name} seconds a pair on {gpu}: tp=2 (gloo, two ranks on one card; not "
            f"an NCCL time) {runs['tp2_rank0'][name]['seconds_per_pair']:.4f} / "
            f"{runs['tp2_rank1'][name]['seconds_per_pair']:.4f}, tp=1 (nccl) "
            f"{runs['tp1_nccl'][name]['seconds_per_pair']:.4f}, one-process loop "
            f"{loop_s[name]:.4f}")
    log(f"# mesh ISS of one side, ms on {gpu}: full forms on the whole cloud / slot-list forms "
        f"at the peer's rows with the gathers: tp=2 (gloo, two ranks on one card) "
        + ", ".join(f"rank {r} {runs[f'tp2_rank{r}']['iss_ms']['full_ms']:.4f} / "
                    f"{runs[f'tp2_rank{r}']['iss_ms']['split_ms']:.4f}" for r in range(2))
        + f"; tp=1 (nccl) {runs['tp1_nccl']['iss_ms']['full_ms']:.4f} / "
        f"{runs['tp1_nccl']['iss_ms']['split_ms']:.4f}")
    for rec in records:  # each form's launches in both configurations' batches
        form = WRAPPER_OF[rec["name"]]
        rec["launches"] = sum(runs[f"tp2_rank{r}"][name]["launches"][form]
                              for r in range(2) for name in mesh_cfgs())
        rec["launches_tp1"] = sum(runs["tp1_nccl"][name]["launches"][form] for name in mesh_cfgs())
    return records, launches


# the debug side of the command line on the 1M scans: the artifacts each
# command writes, by name (those of the JAX package's debug surface); the
# histogram PNGs are written where matplotlib is installed, else skipped
# with one printed line each
MAPS = [f"temperature_{k}_{s}" for k in ("dists", "normal_diffs") for s in ("src", "tgt")]
DISTS = [f"temperature_distances_{s}" for s in ("src", "tgt")]
DEBUG_STEMS = ["downsampled_src", "downsampled_tgt", "iss_saliency_src", "iss_saliency_tgt"] + (
    MAPS + DISTS)
ISS_FORMS = ("iss_count_cuda", "iss_saliency_cuda", "iss_nms_cuda")
FPFH_CLI = "descriptor: fpfh\nkeypoint: iss\nmatching: cluster\nmetric: uniformity\n"


def _written(d: Path, before: dict) -> dict:
    """The files of d/data/debug/scanA_scanB new or rewritten since the
    `before` snapshot ({path: mtime}), by stem (the artifact's name between
    the test name and the settings)."""
    out = {}
    for p, t in _snapshot(d).items():
        if before.get(p) != t:
            out.setdefault(p.name.removeprefix("scanA_scanB_").split("_352_")[0], []).append(p)
    return out


def _snapshot(d: Path) -> dict:
    return {p: p.stat().st_mtime_ns for p in (d / "data/debug/scanA_scanB").iterdir()}


def _vertices(path: Path) -> int:
    from lidar_global_registration_tpu_torch.utils.io import read_ply

    fields = read_ply(str(path))[0]
    assert all(np.isfinite(fields[k]).all() for k in ("x", "y", "z")), path
    return len(fields["x"])


def _check_artifacts(label: str, new: dict, run: dict, stems, each: int, n_hist: int) -> None:
    """Every stem written `each` times; every cloud PLY of a side (..._src /
    _tgt, not the sub-voxel keypoints) with one vertex per preprocessed row
    of that side, as the command's `# load` lines printed; n_hist histogram
    PNGs written or their skips printed."""
    missing = [st for st in stems if len(new.get(st, [])) != each]
    assert not missing, f"{label}: artifacts missing or extra: {missing} of {sorted(new)}"
    rows = dict(zip(("src", "tgt"), run["rows"]))
    for st in stems:
        side = st.rsplit("_", 1)[-1]
        for p in new[st]:
            if p.suffix == ".ply" and side in rows and not st.startswith("subvoxel"):
                assert _vertices(p) == rows[side], f"{label}: {p.name} rows"
    n_png = sum(len(v) for st, v in new.items() if "histogram_" in st)
    n_skip = run["out"].count("no matplotlib, histogram PNG skipped")
    assert n_png + n_skip == n_hist, (label, n_png, n_skip)
    log(f"#   {label}: {sum(len(v) for v in new.values())} artifacts, {n_png} PNGs, "
        f"{n_skip} skipped; rows {run['rows']}")


def trace_summary(trace_dir: Path, category: str = "kernel") -> None:
    """The one Chrome trace LGR_PROFILE wrote into trace_dir: it must hold
    device operations (events of `category`); prints their count, summed
    time and the ten longest, then deletes the trace."""
    (trace,) = trace_dir.glob("trace_*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    ops = sorted((e for e in events if e.get("cat") == category), key=lambda e: -e["dur"])
    assert ops, "LGR_PROFILE: the trace holds no device operation"
    busy = sum(e["dur"] for e in ops) / 1e6
    log(f"#   LGR_PROFILE trace {trace.name}: {trace.stat().st_size / 2**20:.1f} MiB, "
        f"{len(ops)} device operations, {busy:.3f} s busy; the ten longest:")
    for e in ops[:10]:
        log(f"#     {e['dur'] / 1e3:9.3f} ms  {e['name'][:110]}")
    trace.unlink()


def debug_phase(d: Path, fr: float):
    """The debug side of the port's command line on the 1M scans, after the
    `alignment` runs whose caches it reads, each command its own process:
    `debug` over both.yaml (the default SHOT and the FPFH configuration),
    `debug` over H2 (FPFH, lr, the weighted closest-plane metric, RANSAC
    and GROR: the weights dump) with LGR_PROFILE set (the trace must be
    written; its ten longest device operations are printed), and one
    `alignment` over a `tests:` list of a `keypoint` and a `compare` entry
    on the FPFH configuration, a `measure` entry of it with save_features
    (n_times 1) and a `test` entry of H2 (RANSAC) with save_features.  Each
    artifact of the JAX package's names must be written, each PLY of a side
    with one vertex per preprocessed row of it; the keypoint entry must
    print a positive count a side and refine its sub-voxel keypoints to
    finite points within the ISS radius, compare must print both
    hypotheses, the results held to the success rules.  K2-K4 must rise in
    each process, and in the debug processes every other form stay at 0;
    the tests list must also raise K5's full pass and K7 (save_features
    sends its rows to the host path) and leave the rest at 0.  Returns
    ({label: launches}, the histograms CSVs the tests list wrote)."""
    fpfh = FPFH_CLI + f"feature_radius: {fr!r}\n"
    h2 = HOST_H2 + f"feature_radius: {fr!r}\n"
    launches, seconds = {}, {}

    before = _snapshot(d)
    run = run_cli(d, "debug", "both.yaml", "debug_1m")
    _check_artifacts("debug_1m", _written(d, before), run, DEBUG_STEMS, 2, 4)
    assert run["out"].count("debug artifacts written") == 2
    check_counts("debug_1m", run["launches"], ISS_FORMS)
    launches["cli_debug_1m"], seconds["debug_1m"] = run["launches"], run["seconds"]

    trace_dir = d / "trace"
    before = _snapshot(d)
    run = run_cli(d, "debug", cli_config(d, "h2_debug", h2 + "alignment: [ransac, gror]\n"),
                  "debug_h2_1m", env_extra={"LGR_PROFILE": str(trace_dir)})
    _check_artifacts("debug_h2_1m", _written(d, before), run, DEBUG_STEMS + ["weights"], 2, 4)
    check_counts("debug_h2_1m", run["launches"], ISS_FORMS)
    launches["cli_debug_h2_1m"], seconds["debug_h2_1m"] = run["launches"], run["seconds"]
    trace_summary(trace_dir)

    body = "".join(
        f"    - {kind}:\n" + "".join(f"        {ln}\n"
                                    for ln in (CLI_SCENE + cfg).strip().splitlines())
        for kind, cfg in (("keypoint", fpfh), ("compare", fpfh),
                          ("measure", fpfh + "save_features: true\nn_times: 1\n"),
                          ("test", h2 + "save_features: true\n")))
    (d / "debug_tests.yaml").write_text("tests:\n" + body)
    before = _snapshot(d)
    run = run_cli(d, "alignment", "debug_tests.yaml", "debug_tests_1m")
    new = _written(d, before)
    gt_maps = [st.replace("temperature_", "temperature_gt_") for st in MAPS + DISTS]
    _check_artifacts("debug_tests_1m", new, run, [
        "downsampled_src", "downsampled_tgt", "subvoxel_kps_src", "subvoxel_kps_tgt"]
        + MAPS + DISTS + gt_maps + ["ids"], 1, 4)
    assert len(new.get("histograms_src", [])) == len(new.get("histograms_tgt", [])) == 2, new
    out = run["out"]
    m = re.search(r"(\d+) src / (\d+) tgt keypoints", out)
    assert m and int(m.group(1)) > 0 and int(m.group(2)) > 0, "keypoint: no keypoints"
    for side in ("src", "tgt"):
        m = re.search(rf"# keypoint subvoxel {side}: (\d+) keypoints, (\d+) refined, largest "
                      rf"shift ([\d.e+-]+) \(iss radius ([\d.e+-]+)\)", out)
        assert m and int(m.group(1)) > 0 and float(m.group(3)) < float(m.group(4)), side
        (ply,) = new[f"subvoxel_kps_{side}"]
        assert _vertices(ply) == int(m.group(1)), ply.name
    for label in ("incorrect", "correct"):
        assert re.search(rf"\t{label} hypothesis: \d+ points, [\d.e+-]+ weighted points",
                         out), label
    cli_measure(d)
    cli_results(d, 1)
    check_counts("debug_tests_1m", run["launches"], ISS_FORMS + ("spfh_cuda", "nn_l2_cuda"))
    launches["cli_debug_tests_1m"], seconds["debug_tests_1m"] = run["launches"], run["seconds"]
    log(f"# debug phase: {seconds}")
    return launches, {k: new[k] for k in ("histograms_src", "histograms_tgt")}


def save_features_check(d: Path, fr: float, loaded, written: dict) -> None:
    """Each histograms*_src / _tgt.csv the debug phase's save_features rows
    wrote holds one row per valid descriptor of its level, with the
    keypoint's index, as this process computes the level on the same loaded
    pair (host ISS, then the level surface and FPFH: initialize_side)."""
    from lidar_global_registration_tpu_torch.models import pipeline as tp
    from lidar_global_registration_tpu_torch.models.pyramid import initialize_side
    from lidar_global_registration_tpu_torch.ops.iss import detect_keypoints
    from lidar_global_registration_tpu_torch.utils.config import Config
    from lidar_global_registration_tpu_torch.utils.naming import construct_path

    src, tgt, ds, dt, na, vps, vpt = loaded
    with contextlib.chdir(d):
        for name, body in (("sf_fpfh", FPFH_CLI), ("sf_h2", HOST_H2)):
            (params,) = tp.parameters_from_config(Config.load(cli_config(
                d, name, body + f"feature_radius: {fr!r}\n")), ds, dt, na, vps, vpt)
            params = params.replace(testname="scanA_scanB")
            for cloud, vp, r, side in ((src, vps, params.iss_radius_src, "src"),
                                       (tgt, vpt, params.iss_radius_tgt, "tgt")):
                path = Path(construct_path(params, f"histograms_{side}", "csv")).resolve()
                assert path in [p.resolve() for p in written[f"histograms_{side}"]], path
                idx = detect_keypoints(cloud, params.keypoint_id, r)
                lvl = initialize_side(cloud, idx, params, vp, r, side == "src")
                rows = lvl.level_kp_rows[0]
                ok = lvl.level_feat_valid[0][:rows.shape[0]]
                want = rows[ok].cpu().numpy()
                got = np.loadtxt(path, delimiter=",", ndmin=2)
                log(f"#   save_features {name} {side}: {len(got)} rows of {rows.shape[0]} "
                    f"keypoints ({len(want)} valid descriptors)")
                assert got.shape == (len(want), 34), (path.name, got.shape, len(want))
                assert np.array_equal(got[:, 0].astype(np.int64), want), path.name


def lone_runs(label: str, cloud, voxel: float) -> None:
    """voxel_downsample of `cloud` (on the card) at `voxel` on the card and on
    the CPU: every voxel of one point must be torch.equal on both (xyz,
    normal, weight) and its xyz equal to (x * w) / w in float32 of its input
    row, the JAX package's arithmetic.  Prints the counts of lone rows and of
    those that differ from their input point, and the device ms of the
    centroids with the packed routes' arithmetic for a lone row and with
    the segment-sum route's (voxel_downsample's), in turns: packed, segment
    sum, segment sum, packed."""
    import torch

    from lidar_global_registration_tpu_torch.ops.downsample import (
        _centroids,
        masked_min,
        voxel_centroids_map,
        voxel_downsample,
    )
    from lidar_global_registration_tpu_torch.types import Cloud

    cpu = Cloud(*(getattr(cloud, f).cpu() for f in ("xyz", "normal", "weight", "curvature",
                                                    "valid")))
    card = voxel_downsample(cloud, voxel)
    host = voxel_downsample(cpu, voxel)
    origin = masked_min(cloud.xyz, cloud.valid) - 0.5 * torch.tensor(
        voxel, dtype=torch.float32, device=cloud.xyz.device)
    ms = {True: [], False: []}
    for packed in (True, False, False, True):
        ms[packed].append(cuda_ms(lambda: _centroids(
            cloud.xyz, cloud.valid, voxel, origin, cloud.weight, cloud.normal,
            packed=packed), 5))
    _x, _v, row_of, n = voxel_centroids_map(cpu.xyz, cpu.valid, voxel)
    rows = torch.nonzero(cpu.valid).squeeze(1)
    runs = torch.bincount(row_of[rows], minlength=int(n))
    lone_in = rows[runs[row_of[rows]] == 1]  # input rows alone in their voxel
    lone = row_of[lone_in]
    assert int(n) == int(host.valid.sum()) == int(card.valid.sum())
    for f in ("xyz", "normal", "weight"):
        got, want = getattr(card, f).cpu()[lone], getattr(host, f)[lone]
        assert torch.equal(got, want), f"{label}: lone {f} differ card / CPU"
    x, w = cpu.xyz[lone_in].numpy(), cpu.weight[lone_in].numpy()[:, None]
    assert np.array_equal(card.xyz.cpu()[lone].numpy(), (x * w) / w), label
    moved = int(np.any(card.xyz.cpu()[lone].numpy() != x, axis=1).sum())
    weights = np.unique(w)
    log(f"# lone runs {label}: voxel {voxel:.6g}, {int(rows.shape[0])} rows -> {int(n)} voxels, "
        f"{int(lone.shape[0])} lone, {moved} of them not their input point (weights "
        f"{weights.min():g}-{weights.max():g}); card == CPU == (x * w) / w; centroids ms "
        f"with a lone row's packed / segment-sum arithmetic {ms[True][0]:.4f} "
        f"{ms[False][0]:.4f} {ms[False][1]:.4f} {ms[True][1]:.4f}")
    assert lone.shape[0] > 0, f"{label}: no voxel of one point"


def lone_run_check(d: Path, dev, loaded, fr: float) -> None:
    """The lone-voxel rows of the loader's downsample of the 1M graded scan
    (unit weights, the loader's voxel) and of one host level's
    voxel_downsample of the loaded source (accumulated counts), the first
    level of radius 2^k <= fr whose voxel is below the source's spacing."""
    import math

    from lidar_global_registration_tpu_torch.models.pipeline import cloud_from_ply
    from lidar_global_registration_tpu_torch.ops.density import cloud_density
    from lidar_global_registration_tpu_torch.types import (
        FEATURE_NR_POINTS,
        FINE_VOXEL_SIZE_COEFFICIENT,
    )

    raw, _names = cloud_from_ply(str(d / "scanA.ply"), dev)
    lone_runs("loader 1m", raw, FINE_VOXEL_SIZE_COEFFICIENT * cloud_density(raw.xyz, raw.valid))
    del raw
    src, ds = loaded[0], loaded[2]
    r = 2.0 ** math.floor(math.log2(fr))
    while math.sqrt(math.pi * r * r / FEATURE_NR_POINTS) >= ds:
        r /= 2
    lone_runs(f"host level r={r:g} (spacing {ds:.6g})", src,
              math.sqrt(math.pi * r * r / FEATURE_NR_POINTS))


def cli_phase(dev):
    """The port's command line on the graded bench pair, as a user runs it
    (`python -m lidar_global_registration_tpu_torch`, one process a
    command, in a fresh directory under chiprun_out/cli): at 1,048,576
    points a side `alignment` with the reference's default configuration
    (SHOT, the AUTO radius: the staged pyramid) and with FPFH at the fixed
    feature radius that the printed density gives (the feature-scale
    route), `metric` on both caches, and a `measure` test of the FPFH
    setting, n_times 3, then the host path (host_run: H1-H6 in one
    process), the debug side (debug_phase, save_features_check) and the
    host path's kernels at their shapes (host_captures, host_records);
    at 10,485,760 points `alignment` with FPFH and the AUTO radius.  Every
    result row is held to the success rules, `metric`'s cached inliers to
    the alignment's, `measure` to a success rate of 1.  The scans are
    deleted afterwards.  Then, in this process on the loaded 1M pair, the
    guess, GROR's preparation and the hypothesis pool (host_extras) and
    GROR's preparation's kernels at their shapes (gror_records).  Returns
    (each run's kernel launches, the host path's kernel records,
    host_extras' phases, (the host path's ISS plan of the 1M source scan,
    its radius))."""
    import torch

    from lidar_global_registration_tpu_torch.types import FEATURE_NR_POINTS

    launches, host, extras, host_plan = {}, [], {}, None
    need = {"shot": [w for k, w in CLI_WRAPPERS if k not in ("spfh", "combine")],
            "fpfh": [w for _k, w in CLI_WRAPPERS]}
    for n, tag in ((N_PYR, "1m"), (N_ISS, "10m")):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        d = write_cli_scene(dev, n, tag)
        log(f"# CLI pair n={n}: scans written in {time.perf_counter() - t0:.2f} s "
            f"({(d / 'scanA.ply').stat().st_size / 2**20:.0f} MiB a scan)")
        try:
            runs = []
            if tag == "1m":
                shot = cli_config(d, "shot", "lrf: gravity\n")
                runs.append(("shot", run_cli(d, "alignment", shot, "alignment_shot_1m")))
                dmax = max(runs[-1][1]["densities"])
                fr = float(np.sqrt(FEATURE_NR_POINTS * dmax * dmax / np.pi))
                log(f"#   feature radius {fr:.6g} from the printed density {dmax:.6g}")
                body = FPFH_CLI + f"feature_radius: {fr!r}\n"
                runs.append(("fpfh", run_cli(d, "alignment", cli_config(d, "fpfh", body),
                                             "alignment_fpfh_1m")))
                rows = cli_results(d, 2)
                (d / "both.yaml").write_text("tests:\n" + "".join(
                    "    - test:\n" + "".join(f"        {ln}\n" for ln in
                                              (d / c).read_text().strip().splitlines())
                    for c in (shot, "fpfh.yaml")))
                run_cli(d, "metric", "both.yaml", "metric_1m")
                cli_metrics(d, rows)
                runs.append(("fpfh", run_cli(d, "alignment",
                                             cli_config(d, "measure", body + "n_times: 3\n",
                                                        tests="measure"), "measure_1m")))
                cli_measure(d)
                launches["cli_host_1m"] = host_run(d, fr)["launches"]
                debug_launches, written = debug_phase(d, fr)
                launches.update(debug_launches)
                got, r_iss, loaded = host_captures(d, fr, dev)
                save_features_check(d, fr, loaded, written)
                lone_run_check(d, dev, loaded, fr)
                host = host_records(got, r_iss)
                host_plan = (got["iss_count_cuda"][0], r_iss)
                del got
                extras, got, r_gror = host_extras(d, fr, dev, loaded)
                del loaded
                host += gror_records(got, r_gror)
                del got
            else:
                runs.append(("fpfh", run_cli(d, "alignment", cli_config(d, "fpfh_auto", FPFH_CLI),
                                             "alignment_fpfh_10m")))
                cli_results(d, 1)
        finally:  # the scans, the debug clouds and the point ids: too large to keep
            for f in [*d.rglob("*.ply"), *d.rglob("*_ids_*.csv")]:
                f.unlink()
        for kind, run in runs:
            label = f"cli_{kind}_{tag}" + ("_measure" if f"cli_{kind}_{tag}" in launches else "")
            got = run["launches"]
            assert all(got.get(w, 0) > 0 for w in need[kind]), f"{label}: a kernel never ran: {got}"
            assert all(got[w] == 0 for w in CLI_OFF), f"{label}: a form off the CLI path ran: {got}"
            launches[label] = got
    log(f"# launches in the CLI runs: {launches}")
    return launches, host, extras, host_plan


def cli_metrics(d: Path, rows: list[dict]) -> None:
    """`metric` re-scored each cached transform with the correspondence and
    closest-plane metrics (the runs used uniformity): the cached transform's
    correspondence inliers within 1 % of the alignment's inliers (the cache
    prints the thresholds with %g, which can move a pair at the boundary),
    positive closest-plane inliers for the transform and for the GT."""
    lines = (d / "data/debug/test_metrics.csv").read_text().strip().splitlines()
    header = lines[0].split(",")
    got = [dict(zip(header, ln.split(","))) for ln in lines[1:]]
    assert len(got) == len(rows) == 2
    for m, r in zip(got, rows):
        log(f"#   metric {r['descriptor']}: inliers_corr={m['inliers_corr']} (alignment "
            f"{r['inliers']}) inliers_icp={m['inliers_icp']} inliers_corr_gt="
            f"{m['inliers_corr_gt']} inliers_icp_gt={m['inliers_icp_gt']}")
        assert abs(int(m["inliers_corr"]) - int(r["inliers"])) <= 0.01 * int(r["inliers"]), m
        assert int(m["inliers_icp"]) > 0 and int(m["inliers_icp_gt"]) > 0, m


def cli_measure(d: Path) -> None:
    lines = (d / "data/debug/test_measurements.csv").read_text().strip().splitlines()
    row = dict(zip(lines[0].split(","), lines[-1].split(",")))
    log(f"#   measure: success_rate={row['success_rate']} mae={row['mae']} mte={row['mte']} "
        f"mrmse={row['mrmse']} mtime={row['mtime']} stime={row['stime']}")
    assert float(row["success_rate"]) == 1.0, row


DATASET_DIR = ROOT / "chiprun_out" / "datasets"
DATASET_VOXEL = 0.1  # the tool's voxel (m): ~208k rows a 1M scan, overlap radius 0.2 m
N_ETH = 65536  # the ETH CSV scans' rows (np.genfromtxt is slow at 1M)
LAS_SCALE = 0.001
PERTURB_SEED = 16
# the raw scans' poses (local -> global, the source's frame): scanB's is the
# scene's own (scene.scene_pair: b = (b_world - t) R), scanC's a _turn_z
DATASET_TURN = (30.0, [5.0, -3.0, 1.0])


def _z_pose(degrees: float, t) -> np.ndarray:
    c, s = np.cos(np.deg2rad(degrees)), np.sin(np.deg2rad(degrees))
    P = np.eye(4)
    P[:2, :2] = [[c, -s], [s, c]]
    P[:3, 3] = t
    return P


def write_las(path: Path, xyz: np.ndarray) -> None:
    """A LAS 1.2 file of point format 0 (20-byte records: XYZ as i32 at
    LAS_SCALE from an offset at the cloud's floor, then zeros)."""
    import struct

    n = len(xyz)
    offset = np.floor(xyz.min(0).astype(np.float64))
    header = bytearray(227)
    header[0:4] = b"LASF"
    header[24], header[25] = 1, 2
    struct.pack_into("<HI", header, 94, 227, 227)
    struct.pack_into("<BHI", header, 104, 0, 20, n)
    struct.pack_into("<3d", header, 131, LAS_SCALE, LAS_SCALE, LAS_SCALE)
    struct.pack_into("<3d", header, 155, *offset)
    rec = np.zeros(n, np.dtype([("xyz", "<i4", (3,)), ("rest", "u1", (8,))]))
    rec["xyz"] = np.round((xyz.astype(np.float64) - offset) / LAS_SCALE)
    path.write_bytes(bytes(header) + rec.tobytes())


def _gt_rows(path: Path) -> dict:
    """A ground-truth CSV's rows as float64 4 x 4 matrices."""
    rows = [ln.split(",") for ln in path.read_text().strip().splitlines()[1:]]
    return {r[0]: np.array(r[1:17], np.float64).reshape(4, 4) for r in rows}


def _ply_xyz(path: Path) -> np.ndarray:
    from lidar_global_registration_tpu_torch.utils.io import read_ply

    fields = read_ply(str(path))[0]
    return np.stack([fields["x"], fields["y"], fields["z"]], axis=1)


def dataset_phase(dev) -> dict:
    """The port's dataset tool (tools/datasets_torch.py, each command through
    its main(argv, device), as `python tools/datasets_torch.py` runs it) from
    raw scans to a registration on the card, in chiprun_out/datasets: the
    graded 1M pair and the source in a third frame (a _turn_z pose) written
    as a Stanford directory with a .conf of their poses, the source once more
    as LAS, 65,536 rows of two scans as ETH CSV with a .tfm; then `stanford`,
    `las`, `eth`, `eth_gt`, `transform` to the global frame, `overlap` of the
    1M scans there, `transform` back, `downsample` on the card and on the
    CPU, `overlap` of the downsampled scans on the card and on the CPU, and
    for the pair `perturb --seed`, `downsample --without-transformation` and
    `python -m lidar_global_registration_tpu_torch alignment` (FPFH at the
    fixed radius that the loader's density gives), held to the success
    rules.  Each result is checked (GT rows against the poses, LAS rows
    within half the scale, the round trip, card against CPU, the overlap
    against the scene, the perturbed pose); the tool launches no kernel of
    K1-K7.  The clouds are deleted afterwards.  Returns the alignment's
    run (run_cli)."""
    import importlib.util
    import io
    import shutil

    import torch

    from lidar_global_registration_tpu_torch.models.pipeline import (
        cloud_from_ply,
        preprocess_cloud,
    )
    from lidar_global_registration_tpu_torch.ops.density import cloud_density
    from lidar_global_registration_tpu_torch.scene import ANGLE, OFFSET
    from lidar_global_registration_tpu_torch.types import FEATURE_NR_POINTS
    from lidar_global_registration_tpu_torch.utils.io import write_ply

    spec = importlib.util.spec_from_file_location("datasets_torch",
                                                  ROOT / "tools" / "datasets_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    d = DATASET_DIR
    shutil.rmtree(d, ignore_errors=True)
    raw, scan, pair, las, eth = (d / k for k in ("raw", "scan", "pair", "las", "eth"))
    for p in (raw, las, eth / "csv", pair):
        p.mkdir(parents=True)
    cpu = torch.device("cpu")
    peak = [0]  # `overlap` resets the peak: read it after each command

    def run(*argv, device=dev, label=""):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            tool.main([str(a) for a in argv], device=device)
        log(f"# dataset {argv[0]} {time.perf_counter() - t0:.3f} s" + (f" ({label})" if label
                                                                     else ""))
        peak[0] = max(peak[0], torch.cuda.max_memory_allocated(dev))
        lines = buf.getvalue().splitlines()
        for ln in lines:
            log(f"#   {ln}")
        return lines

    def config(file: Path, **kv) -> Path:
        file.write_text("".join(f"{k}: {v}\n" for k, v in kv.items()))
        return file

    try:
        a, b, vp_a, vp_b, _T = iss_scene(N_PYR, dev, graded=True)
        poses = {"scanA.ply": np.eye(4), "scanB.ply": _z_pose(np.rad2deg(ANGLE), OFFSET),
                 "scanC.ply": _turn_z(np.eye(4), *DATASET_TURN).astype(np.float64)}
        P_c = torch.as_tensor(poses["scanC.ply"], dtype=torch.float32, device=dev)
        local = {"scanA.ply": a.cpu().numpy(), "scanB.ply": b.cpu().numpy(),
                 "scanC.ply": ((a - P_c[:3, 3]) @ P_c[:3, :3]).cpu().numpy()}
        vp_a, vp_b = vp_a.cpu().numpy().astype(np.float64), vp_b.cpu().numpy().astype(np.float64)
        del a, b
        t0 = time.perf_counter()
        conf = ["camera 0 0 0 0 0 0 1"]
        for name, xyz in local.items():
            write_ply(str(raw / name), xyz)
            theta = np.arctan2(poses[name][1, 0], poses[name][0, 0])
            q = (0.0, 0.0, np.sin(-theta / 2), np.cos(-theta / 2))  # R(q) = the pose's R^T
            conf.append(f"bmesh {name} " + " ".join(repr(float(v)) for v in
                                                   (*poses[name][:3, 3], *q)))
        (raw / "scan.conf").write_text("\n".join(conf) + "\n")
        write_las(las / "scanA.las", local["scanA.ply"])
        gt = ["reading," + ",".join(f"gT{i}{j}" for i in range(4) for j in range(4))]
        for k, name in enumerate(("scanA.ply", "scanB.ply")):
            np.savetxt(eth / "csv" / f"Hokuyo_{k}.csv", local[name][:N_ETH], fmt="%.9g",
                       delimiter=",", header="x,y,z", comments="")
            gt.append(f"Hokuyo_{k}.csv," + ",".join(repr(float(v)) for v in
                                                    poses[name].reshape(-1)))
        (eth / "csv" / "ground_truth.csv").write_text("\n".join(gt) + "\n")
        log(f"# dataset raw scans written in {time.perf_counter() - t0:.2f} s: 3 x {N_PYR} "
            f"points (PLY), LAS, 2 x {N_ETH} (ETH CSV)")

        # the converters
        zero_counters()
        run("stanford", raw, "-o", scan)
        got = _gt_rows(scan / "ground_truth.csv")
        assert sorted(got) == sorted(poses), got
        for name, P in poses.items():
            assert np.abs(got[name] - P).max() <= 1e-6, (name, got[name], P)
            assert np.array_equal(_ply_xyz(scan / name), local[name]), name
        run("las", las)
        xyz64, _i = tool.read_las(str(las / "scanA.las"))
        las_err = float(np.abs(xyz64 - local["scanA.ply"]).max())
        log(f"#   LAS rows: max error {las_err:.3g} (scale {LAS_SCALE})")
        assert las_err <= 0.5 * LAS_SCALE * (1 + 1e-9), las_err
        assert np.array_equal(_ply_xyz(las / "scanA.ply"), xyz64.astype(np.float32))
        run("eth", eth / "csv", "-o", eth / "out")
        for k, name in enumerate(("scanA.ply", "scanB.ply")):
            assert np.array_equal(_ply_xyz(eth / "out" / f"Hokuyo_{k}.ply"),
                                  local[name][:N_ETH]), k
        (eth / "out" / "groundtruth").mkdir()
        (eth / "out" / "groundtruth" / "Hokuyo_1-Hokuyo_0.tfm").write_text("\n".join(
            " ".join(repr(float(v)) for v in row) for row in poses["scanB.ply"]) + "\n")
        run("eth_gt", eth / "out")
        got = _gt_rows(eth / "out" / "ground_truth.csv")
        assert np.abs(got["Hokuyo_0.ply"] - np.eye(4)).max() <= 1e-6, got
        assert np.abs(got["Hokuyo_1.ply"] - poses["scanB.ply"]).max() <= 1e-6, got

        # the frames: to the global frame (the source's), the 1M overlap there, and back
        frame = config(scan / "scan.yaml", ground_truth=scan / "ground_truth.csv")
        run("transform", frame, "--current", "local", label="to the global frame")
        world = {name: _ply_xyz(scan / name) for name in poses}
        c_err = float(np.abs(world["scanC.ply"] - world["scanA.ply"]).max())
        log(f"#   scanC in the global frame: max {c_err:.3g} from scanA")
        assert c_err <= 1e-4, c_err
        run("overlap", config(scan / "overlap.yaml", path=scan, voxel_size=DATASET_VOXEL),
            label=f"{N_PYR} points a scan")
        run("transform", frame, "--current", "global", label="back")
        trip = max(float(np.abs(_ply_xyz(scan / n) - x).max()) for n, x in local.items())
        log(f"#   round trip: max {trip:.3g}")
        assert trip <= 1e-4, trip
        del world

        # downsample and overlap, on the card and on the CPU
        down = scan / f"downsampled_{DATASET_VOXEL}"
        ds_cfg = config(scan / "downsample.yaml", path=scan, voxel_size=DATASET_VOXEL,
                        ground_truth=scan / "ground_truth.csv")
        lines_cpu = run("downsample", ds_cfg, device=cpu, label="cpu")
        rows_cpu = {name: _ply_xyz(down / name) for name in poses}
        lines = run("downsample", ds_cfg, label="card")
        assert lines == lines_cpu, (lines, lines_cpu)
        for name in poses:
            got, want = _ply_xyz(down / name), rows_cpu[name]
            assert got.shape == want.shape, name
            err = float(np.abs(got - want).max())
            log(f"#   downsample {name}: card against cpu max {err:.3g}, "
                f"{int((got != want).any(1).sum())} of {len(got)} rows not equal")
            assert err <= 1e-5, (name, err)
        del rows_cpu
        ov_cfg = config(down / "overlap.yaml", path=down, voxel_size=DATASET_VOXEL)
        run("overlap", ov_cfg, label="card")
        matrix = (down / "overlapping.csv").read_text()
        run("overlap", ov_cfg, device=cpu, label="cpu")
        assert (down / "overlapping.csv").read_text() == matrix, matrix
        M = {ln.split(",")[0]: [float(v) for v in ln.split(",")[1:]]
             for ln in matrix.strip().splitlines()[1:]}
        log(f"#   overlap: {M}")
        # both scans sample every patch of one scene with the same weights
        # (scene.scene_pair), and scanC is scanA's points
        assert M["scanA.ply"][1] >= 0.99 and M["scanA.ply"][2] >= 0.999, M
        assert not any(read_counters().values()), f"the tool launched a kernel: {read_counters()}"

        # the pair: perturbed, downsampled in its own frames, registered
        for name in ("scanA.ply", "scanB.ply", "ground_truth.csv"):
            shutil.copy(scan / name, pair / name)
        run("perturb", config(pair / "perturb.yaml", transform=pair / "scanA.ply",
                              ground_truth=pair / "ground_truth.csv"), "--seed", PERTURB_SEED)
        moved = "scanA_transformed_r.ply"
        gt = _gt_rows(pair / "ground_truth.csv")
        turned = _ply_xyz(pair / moved).astype(np.float64)
        err = float(np.abs(turned @ gt[moved][:3, :3].T + gt[moved][:3, 3]
                           - _ply_xyz(pair / "scanA.ply")).max())
        log(f"#   perturbed scan under its new GT row: max {err:.3g} from scanA")
        assert err <= 1e-4, err
        (pair / "scanA.ply").unlink()
        run("downsample", config(pair / "downsample.yaml", path=pair, voxel_size=DATASET_VOXEL),
            "--without-transformation", label="card")
        dp = pair / f"downsampled_{DATASET_VOXEL}"
        T = np.linalg.inv(gt[moved]) @ gt["scanA.ply"]
        vps = {moved: T[:3, :3] @ vp_a + T[:3, 3], "scanB.ply": vp_b}
        (dp / "viewpoints.csv").write_text("reading,x,y,z\n" + "".join(
            f"{n}," + ",".join(repr(float(x)) for x in v) + "\n" for n, v in vps.items()))
        dens = [cloud_density(c.xyz, c.valid) for c in
                (preprocess_cloud(cloud_from_ply(str(dp / n), dev)[0]) for n in vps)]
        fr = float(np.sqrt(FEATURE_NR_POINTS * max(dens) ** 2 / np.pi))
        log(f"#   feature radius {fr:.6g} from the loader's density {max(dens):.6g}")
        (dp / "fpfh.yaml").write_text(
            f"source: {moved}\ntarget: scanB.ply\nground_truth: ../ground_truth.csv\n"
            f"viewpoints: viewpoints.csv\nhypothesis_batch: 1024\n{FPFH_CLI}"
            f"feature_radius: {fr!r}\n")
        done = run_cli(dp, "alignment", "fpfh.yaml", "alignment_dataset")
        cli_results(dp, 1)
        got = done["launches"]
        assert all(got.get(w, 0) > 0 for _k, w in CLI_WRAPPERS), f"a kernel never ran: {got}"
        assert all(got[w] == 0 for w in CLI_OFF), f"a form off the CLI path ran: {got}"
    finally:  # the clouds: too large to keep
        for f in [*d.rglob("*.ply"), *d.rglob("*.las"), *(eth / "csv").glob("Hokuyo_*.csv")]:
            f.unlink()
    peak[0] = max(peak[0], torch.cuda.max_memory_allocated(dev))
    log(f"# dataset phase: {time.perf_counter() - t_phase:.1f} s on {gpu_line()}; peak "
        f"device memory {peak[0] / 2**30:.3f} GiB")
    return done


BENCH_TIMEOUT = 900  # seconds for bench_torch.py's two default rows
BENCH_CPU_N = "4096"  # the CPU baselines' size here (the bench's default: 65,536)
# the kernel forms each default row must launch in its timed repeats
BENCH_NEED = {
    "64k keypoint-any": ("surface_cuda", "spfh_cuda", "combine_cuda", "nn_l2_cuda"),
    "10M ISS": ("surface_cuda", "iss_count_cuda", "iss_saliency_cuda", "iss_nms_cuda",
                "spfh_at_cuda", "combine_at_cuda", "nn_l2_cuda"),
}


def bench_phase() -> dict:
    """The port's bench entry as a user runs it: `python3 bench_torch.py` with
    no LGR_BENCH_N, that is bench.py's two default rows (the 65,536-point
    keypoint-any pair and the 10,485,760-point ISS pair, 3 repeats each, each
    in a process of its own, merged into the flagship line), after its CPU
    cache was deleted and with LGR_BENCH_CPU_N=4096, so that both CPU
    baselines run, at a size that keeps the phase short.  Every `# repeat`
    line must say ok=True, each row's timed repeats must have launched the
    kernel forms of its route and no other (the row's `# launches in the
    repeats` line), and the JSON line
    must be the flagship row with value > 0, extra_64k_pairs_per_s > 0,
    three repeats, a vs_baseline and no note or error.  Its stderr is kept
    in chiprun_out/bench.log.  Returns the JSON line."""
    import os
    import signal

    import torch

    torch.cuda.empty_cache()
    (ROOT / ".bench_torch_cpu_cache.json").unlink(missing_ok=True)
    env = {k: v for k, v in os.environ.items() if not k.startswith("LGR_")}
    env["LGR_BENCH_CPU_N"] = BENCH_CPU_N
    t0 = time.perf_counter()
    # a session of its own: a timeout stops the rows' and workers' processes too
    proc = subprocess.Popen([sys.executable, str(ROOT / "bench_torch.py")], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=BENCH_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"bench_torch.py ran past {BENCH_TIMEOUT} s")
    wall = time.perf_counter() - t0
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "bench.log").write_text(err + out)
    lines = err.splitlines()
    for line in lines:
        if line.startswith(("# device", "# pre-downsample", "# repeat", "# launches",
                            "# cpu baseline")):
            log(f"#   {line[2:]}")
    assert proc.returncode == 0, f"bench_torch.py exited {proc.returncode}:\n{err[-3000:]}"
    repeats = [line for line in lines if line.startswith("# repeat")]
    assert len(repeats) == 6 and all(line.endswith(" ok=True") for line in repeats), repeats
    counted = [json.loads(line.split(": ", 1)[1].split("; ")[0]) for line in lines
               if line.startswith("# launches in the repeats: ")]
    assert len(counted) == len(BENCH_NEED), counted
    for (label, need), got in zip(BENCH_NEED.items(), counted):
        check_counts(f"bench {label}", got, need)
    res = json.loads([line for line in out.splitlines() if line.startswith("{")][-1])
    log(f"# bench phase: {wall:.1f} s wall; {json.dumps(res)}")
    assert res["metric"] == "register_10m_pt_pair_e2e_flagship", res
    assert res["value"] > 0 and (res["extra_64k_pairs_per_s"] or 0) > 0, res
    assert len(res["per_repeat_s"]) == REPEATS and res["vs_baseline"] is not None, res
    assert "note" not in res and "error" not in res, res
    return res


def iss_phase(dev):
    """The 10,485,760-point ISS pair through three routes: the bench's
    flagship row (FPFH), the shipped SHOT regime, and the classic masked
    route (feature_scale=False) with each descriptor.  Returns the kernel
    records of these routes and each route's launch counts."""
    import torch

    from lidar_global_registration_tpu_torch.ops import cellgrid as cg
    from lidar_global_registration_tpu_torch.ops import nn_l2
    from lidar_global_registration_tpu_torch.ops.downsample import voxel_centroids_map
    from lidar_global_registration_tpu_torch.types import FEATURE_NR_POINTS

    t0 = time.perf_counter()
    S = iss_setup(dev, N_ISS)
    torch.cuda.synchronize()
    sx, sv, tx, tv, radii = S["sx"], S["sv"], S["tx"], S["tv"], S["radii"]
    log(f"# ISS pair n={N_ISS}: sampled on the card, raw radii, pre-downsample and radii in "
        f"{time.perf_counter() - t0:.2f} s; raw {S['raw']}")
    log(f"# pre-downsample: {N_ISS} -> {sx.shape[0]} rows/side ({int(sv.sum())}/{int(tv.sum())} "
        f"valid, voxel {S['vox'][0]:.4f}/{S['vox'][1]:.4f}); radii {radii}")
    records = (check_iss_kernels(sx, sv, radii) + check_shot_kernels(S) + check_classic_fpfh(S)
               + check_unmasked(S))

    iss_k = (cg.iss_count_cuda, cg.iss_saliency_cuda, cg.iss_nms_cuda)
    launches = {}
    launches["fpfh"] = iss_runs(S, iss_cfg(), (cg.surface_cuda, *iss_k, cg.spfh_at_cuda,
                                               cg.combine_at_cuda, nn_l2.nn_l2_cuda),
                                "ISS", REPEATS, rule=True)
    # sizes of one repeat's working set (outside the timed region)
    voxel_f = float(np.sqrt(np.pi * radii["feature"] ** 2 / FEATURE_NR_POINTS))
    for which, x, v, r_iss in (("src", sx, sv, radii["iss_src"]),
                               ("tgt", tx, tv, radii["iss_tgt"])):
        n_kp = int(cg.iss_pass(cg.plan_grid(x, v, r_iss), r_iss)[0].sum())
        n_sm = int(voxel_centroids_map(x, v, voxel_f)[3])
        log(f"#   {which}: {int(v.sum())} working points, {n_kp} keypoints, "
            f"voxel surface {n_sm} rows (voxel_f {voxel_f:.4f})")
    launches["shot"] = iss_runs(S, iss_cfg(**SHOT_CFG), (cg.surface_cuda, *iss_k,
                                                         nn_l2.nn_l2_cuda),
                                "SHOT", REPEATS, rule=True)
    launches["masked_fpfh"] = iss_runs(
        S, iss_cfg(feature_scale=False), (cg.surface_at_cuda, *iss_k, cg.spfh_at_cuda,
                                          cg.combine_at_cuda, nn_l2.nn_l2_cuda),
        "classic masked FPFH", 1, rule=False)
    launches["masked_shot"] = iss_runs(
        S, iss_cfg(feature_scale=False, **SHOT_CFG), (cg.surface_at_cuda, *iss_k,
                                                      nn_l2.nn_l2_cuda),
        "classic masked SHOT", 1, rule=False)
    launches["unmasked_fpfh"] = iss_runs(
        S, iss_cfg(masked_features=False), (cg.surface_cuda, *iss_k, cg.spfh_cuda,
                                            cg.combine_cuda, nn_l2.nn_l2_cuda),
        "unmasked FPFH", 1, rule=False)
    launches["unmasked_shot"] = iss_runs(
        S, iss_cfg(masked_features=False, **SHOT_CFG), (cg.surface_cuda, *iss_k,
                                                        nn_l2.nn_l2_cuda),
        "unmasked SHOT", 1, rule=False)
    launches["gror"] = iss_runs(S, iss_cfg(alignment="gror"),
                                (cg.surface_cuda, *iss_k, cg.spfh_at_cuda, cg.combine_at_cuda,
                                 nn_l2.nn_l2_cuda), "GROR", REPEATS, rule=True)
    return records, launches


def iss_small_pair(dev, label: str, graded: bool = False, min_share: float = 0.8, **change):
    """A 65,536-point ISS pair through the kernels and through the plain
    versions (CPU), from one sample; `graded`: the range-graded scene."""
    import torch

    from lidar_global_registration_tpu_torch.types import SEED

    cpu = torch.device("cpu")
    S0 = iss_setup(cpu, N_ISS_SMALL, graded)  # one sample, one set of radii for both paths
    outs = []
    for d in (dev, cpu):
        S = {k: v.to(d) if torch.is_tensor(v) else v for k, v in S0.items()}
        outs.append(register_iss(S, iss_cfg(**change), SEED))
    if change.get("alignment") == "gror":
        # GROR draws nothing: on ONE correspondence set (the kernels' path's)
        # the card and the CPU must give the same counts, and the same pose
        # up to float32 summation order in the Umeyama refit
        from lidar_global_registration_tpu_torch.models.gror import gror_solve

        rows, match, _thr, cv = (x.cpu() for x in outs[0]["correspondences"])
        p, q = S0["sx"][rows], S0["tx"][match]
        res = S0["radii"]["thr"]
        g_dev = gror_solve(p.to(dev), q.to(dev), cv.to(dev), res)
        g_cpu = gror_solve(p, q, cv, res)
        for k in ("inliers", "iterations", "converged", "n_correspondences"):
            assert g_dev[k] == g_cpu[k], f"GROR on one set, card against CPU: {k}"
        assert g_dev["inliers"] == int(outs[0]["inliers"])
        torch.testing.assert_close(g_dev["transformation"].cpu(), g_cpu["transformation"],
                                   atol=1e-4, rtol=0)
        log(f"# GROR on the {int(cv.sum())} correspondences of the kernels' path, card and CPU: "
            f"inliers {g_dev['inliers']}, rounds {g_dev['iterations']}, poses within 1e-4; "
            f"the plain path's own set gives {int(outs[1]['inliers'])} inliers")
    T_gt = S0["T_gt"].numpy()
    (rg, tg, _), (rc, tc, _) = (pose_error(o, T_gt) for o in outs)
    share = shared_share(*outs)
    log(f"# small {label} pair n={N_ISS_SMALL}: kernels r_err={rg:.5f} t_err={tg:.4f} "
        f"corr={float(outs[0]['n_correspondences']):.0f}, plain r_err={rc:.5f} t_err={tc:.4f} "
        f"corr={float(outs[1]['n_correspondences']):.0f}, shared cluster correspondences "
        f"{share:.4f}")
    assert bool(outs[0]["converged"]) and bool(outs[1]["converged"])
    assert rg < R_ERR_MAX and rc < R_ERR_MAX
    # the two paths differ by float32 summation order (K3's saliency near the
    # gamma gates, the SHOT frames' covariances) and atan2f (K5's bin
    # edges); the consensus gate and the max_correspondences cap pass such
    # differences on
    assert share >= min_share, share


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

    t_run = time.perf_counter()

    def elapsed(done: str):
        log(f"# elapsed {time.perf_counter() - t_run:.1f} s: {done}")

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
    records[1]["pair_body_sass"] = pair_body_sass()
    log(f"# K5 pair body: {records[1]['pair_body_sass']} SASS instructions (static, probe kernel)")
    check_cell_edges(dev)
    check_iss_edges(dev)
    check_nn_edges(dev)

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
    share = shared_share(gpu_out, cpu_out)
    log(f"# small pair n=4096: kernels r_err={rg:.5f} t_err={tg:.4f}, plain r_err={rc:.5f} "
        f"t_err={tc:.4f}, shared mutual correspondences {share:.4f}")
    assert bool(gpu_out["converged"]) and bool(cpu_out["converged"])
    assert rg < R_ERR_MAX and rc < R_ERR_MAX and share >= 0.9

    # the one-graph entry points on the same 65,536-point pair
    one_graph = {f"one_graph_{k}": v
                 for k, v in one_graph_phase(dev, a, b, vp_a, vp_b, T_gt, radii).items()}
    elapsed("one-graph entry points")
    one_graph["batch"] = batch_phase(dev, a, b, vp_a, vp_b, T_gt, radii)
    elapsed("batched pairs")

    # keypoint-any SHOT on the same 65,536-point pair
    records.append(any_shot_phase(dev, a, b, vp_a, vp_b, T_gt, radii))

    # one large pair: completes with a finite pose (no reference row at this size)
    la, lb, lvp_a, lvp_b, lT = scene(N_LARGE)
    t0 = time.perf_counter()
    lradii = derive_radii(torch.from_numpy(la).to(dev), torch.from_numpy(lb).to(dev))
    log(f"# large radii ({time.perf_counter() - t0:.2f} s set-up): {lradii}")
    large_records = check_large(dev, la, lb, lradii)
    la_dev = torch.from_numpy(la).to(dev)
    for c in counters:
        c.launches = 0
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
    large = {"spfh_262k": cellgrid.spfh_cuda.launches,
             "combine_262k": cellgrid.combine_cuda.launches,
             "nn_l2_262k": nn_l2.nn_l2_cuda.launches}
    log(f"# launches in the large runs: {large}")
    assert all(n > 0 for n in large.values()), "a kernel of the large path was never launched"
    for rec in large_records:
        rec["launches"] = large[rec["name"]]
    records += large_records

    # the ISS routes on the 10M pair, then small pairs via both paths
    elapsed("keypoint-any routes")
    iss_records, iss_launches = iss_phase(dev)
    elapsed("ISS phase")
    for rec in records:  # K1 and K7 run on the ISS routes too
        if rec["name"] in ("surface", "nn_l2"):
            for route, got in iss_launches.items():
                rec[f"launches_{route}"] = got[WRAPPER_OF[rec["name"]]]
    own = {"surface_at": "masked_fpfh", "nn_l2_d352": "shot", "iss_count_pn": "masked_fpfh",
           "iss_saliency_pn": "masked_fpfh", "iss_nms_pn": "masked_fpfh",
           "spfh_at_classic": "masked_fpfh", "combine_at_classic": "masked_fpfh",
           "surface_pn": "unmasked_fpfh", "spfh_work_full": "unmasked_fpfh",
           "combine_work_full": "unmasked_fpfh"}
    for rec in iss_records:
        rec["launches"] = iss_launches[own.get(rec["name"], "fpfh")][WRAPPER_OF[rec["name"]]]
    records += iss_records

    # the staged pyramid on the graded 1M and 10M pairs
    pyr_records, pyr_launches = pyramid_phase(dev)
    elapsed("pyramid phase")
    for rec in pyr_records:
        rec["launches"] = pyr_launches["pyr_fpfh_2m"][WRAPPER_OF[rec["name"]]]
    for rec in records:
        if rec["name"] in ("surface", "nn_l2"):
            for route, got in pyr_launches.items():
                rec[f"launches_{route}"] = got[WRAPPER_OF[rec["name"]]]
    records += pyr_records

    # the command line, as a user runs it, on the graded 1M and 10M pairs:
    # each record reads its own form's counter (0 for the forms off the path)
    cli_launches, host, extras, host_plan = cli_phase(dev)
    elapsed("CLI phase")
    cli_launches["cli_fpfh_dataset"] = dataset_phase(dev)["launches"]
    elapsed("dataset phase")
    bench_phase()
    elapsed("bench phase")
    mesh_records, mesh_launches = mesh_phase(dev, a, b, vp_a, vp_b, T_gt, radii, host_plan)
    del host_plan
    one_graph.update(mesh_launches)
    records += mesh_records
    elapsed("mesh phase")
    for rec in host:  # GROR's preparation runs in its own phase of the host process
        main_run = (extras["gror_prep"]["launches"] if rec["name"].endswith("_gror")
                    else cli_launches["cli_host_1m"])
        rec["launches"] = main_run[WRAPPER_OF[rec["name"]]]
    records += host
    for rec in records:  # every phase here read every counter
        for route, got in cli_launches.items():
            rec[f"launches_{route}"] = got[WRAPPER_OF[rec["name"]]]
        for route, ph in {**extras, **one_graph}.items():
            rec[f"launches_{route}"] = ph["launches"][WRAPPER_OF[rec["name"]]]
    iss_small_pair(dev, "ISS")
    iss_small_pair(dev, "pyramid", graded=True, min_share=0.9, pyramid=True)
    iss_small_pair(dev, "SHOT", **SHOT_CFG)
    iss_small_pair(dev, "GROR", alignment="gror")
    elapsed("small pairs")

    log(f"{gpu}")
    log(json.dumps({"kernels": records}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
    sys.exit(main())

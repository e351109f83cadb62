"""Measure the lone-voxel centroid fault (ROADMAP Queue 3 item 2, closed)
and its repairs on the two 16,000-point CLI scenarios whose fixed-bound
tests move.

    JAX_PLATFORMS=cpu python tests/torch_lone_centroid_probe.py   # a few minutes, 6 processes

Forms of ops/downsample._centroids (each applied to the outputs of the
residual form, so only the centroids, the normals and the summed weights
differ):
  residual  the port before the repair: every run's residuals rounded to
            float32, summed in float64, the corner added in float32 (the
            module's packed=True);
  jax_lone  the port as it is: a one-point run takes the arithmetic of the
            JAX route its caller mirrors, (x * w) / w in voxel_downsample,
            the residual form in the two packed-route forms;
  f64       (1) the residual against the voxel corner in float64, the corner
            added back in float64;
  lone      (2) a one-point run returns its point;
  f32       (3) per-run float32 sums of xyz * w, w and normal * w over the
            sorted rows, as JAX's segment_sum runs on the CPU;
and the JAX package itself (jax).  Scenarios: `cli`, the config of
tests/test_torch_cli.py (`lr`, RANSAC; its test_results_rows_match_jax holds
the correspondences within 5 % of JAX's), and `host`, the config of
tests/test_torch_host_e2e.py::test_cli_runs_a_set_outside_the_envelope
(`one_sided`, RANSAC and GROR).  Prints each run's result rows and, per
scenario, how many correspondences of each form are not in JAX's set (by
position, to 1e-3).  Not a test: pytest does not collect it.
"""
import contextlib
import glob
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FORMS = ("residual", "jax_lone", "f64", "lone", "f32", "jax")
COLS = ("alignment_type", "converged", "r_err", "t_err", "correspondences", "inliers")


def _patched(form: str):
    """_centroids of `form`, from the residual form's outputs and row map."""
    import torch

    from lidar_global_registration_tpu_torch.ops import downsample

    base_fn = downsample._centroids

    def centroids(xyz, valid, voxel, origin, weight=None, normal=None, packed=False):
        if form == "jax_lone":
            return base_fn(xyz, valid, voxel, origin, weight, normal, packed)
        out_xyz, out_valid, row_of, n_out, acc = base_fn(xyz, valid, voxel, origin, weight,
                                                         normal, packed=True)
        N = xyz.shape[0]
        rows = torch.nonzero(valid).squeeze(1)  # in input order: each run's sorted order
        r = row_of[rows]
        w = torch.ones_like(rows, dtype=torch.float32) if weight is None else weight[rows]
        if form == "lone":
            n = torch.zeros((N,), dtype=torch.int64).index_add_(0, r, torch.ones_like(r))
            one = n[r] == 1
            out_xyz = out_xyz.clone()
            out_xyz[r[one]] = xyz[rows[one]]
        elif form == "f64":
            vox = torch.tensor(voxel, dtype=torch.float32)
            c = torch.floor((xyz[rows] - origin[None, :]) / vox.clamp_min(1e-30)).clamp_min(0)
            corner = origin[None, :] + c * vox
            res = (xyz[rows].double() - corner.double()) * w.double()[:, None]
            s = torch.zeros((N, 3), dtype=torch.float64).index_add_(0, r, res)
            cnt = torch.zeros((N,), dtype=torch.float64).index_add_(0, r, w.double())
            base = torch.zeros((N, 3), dtype=torch.float64)
            base[r] = corner.double()
            cent = (base + s / cnt.clamp_min(1e-30)[:, None]).float()
            out_xyz = torch.where(out_valid[:, None], cent, 0.0)
        elif form == "f32":
            order = torch.argsort(r, stable=True)
            cols = [xyz[rows] * w[:, None], w[:, None]]
            if normal is not None:
                cols.append(normal[rows] * w[:, None])
            lengths = torch.zeros((N,), dtype=torch.int64).index_add_(0, r, torch.ones_like(r))
            sums = torch.segment_reduce(torch.cat(cols, 1)[order], "sum", lengths=lengths, axis=0)
            out_xyz = torch.where(out_valid[:, None],
                                  sums[:, :3] / sums[:, 3:4].clamp_min(1e-30), 0.0)
            if weight is not None:
                nrm = None
                if normal is not None:  # renormalised, as _centroids returns it
                    nrm = sums[:, 4:] / sums[:, 3:4].clamp_min(1e-30)
                    nn = nrm.square().sum(1, keepdim=True).sqrt()
                    nrm = nrm / torch.where(nn < 1e-5, 1.0, nn)
                acc = (sums[:, 3], nrm)
        return out_xyz, out_valid, row_of, n_out, acc

    return centroids


def run(form: str, scenario: str, d: str) -> None:
    """One CLI `alignment` of `form` on `scenario` in directory d; prints one
    JSON line of the result rows and the correspondence cache's path."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import torch

    from test_torch_cli import CONFIG, make_scan_pair
    from test_torch_host_e2e import CLI_CONFIG

    torch.set_num_threads(1)
    os.makedirs(d, exist_ok=True)
    os.chdir(d)
    make_scan_pair(d)
    Path("config.yaml").write_text(CONFIG if scenario == "cli" else CLI_CONFIG)
    with contextlib.redirect_stdout(io.StringIO()):
        if form == "jax":
            import jax

            jax.config.update("jax_platforms", "cpu")
            from lidar_global_registration_tpu.cli import main

            main(["alignment", "config.yaml"])
        else:
            from lidar_global_registration_tpu_torch.cli import main
            from lidar_global_registration_tpu_torch.ops import downsample

            downsample._centroids = _patched(form)
            main(["alignment", "config.yaml"], device="cpu")
    lines = Path("data/debug/test_results.csv").read_text().strip().splitlines()
    head = lines[0].split(",")
    rows = [{k: dict(zip(head, ln.split(",")))[k] for k in COLS} for ln in lines[1:]]
    (cache,) = glob.glob("data/debug/**/*_correspondences_*.csv", recursive=True)
    print(json.dumps(dict(form=form, scenario=scenario, rows=rows, cache=str(Path(d) / cache))))


def _pairs(path: str) -> set:
    """A correspondence cache's pairs by their source and target positions
    (the packages number the rows of keypoint-any sets differently)."""
    x = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    return {tuple(r) for r in np.round(x[:, 4:10], 3)}


def main() -> None:
    import tempfile

    tmp = tempfile.mkdtemp(prefix="lone_centroid_")
    for scenario in ("cli", "host"):
        procs = {f: subprocess.Popen([sys.executable, __file__, "run", f, scenario,
                                      os.path.join(tmp, f"{scenario}_{f}")],
                                     stdout=subprocess.PIPE, text=True) for f in FORMS}
        res = {}
        for f, p in procs.items():
            out, _ = p.communicate()
            if p.returncode:
                raise SystemExit(f"{scenario} {f} failed ({p.returncode})")
            res[f] = json.loads(out.strip().splitlines()[-1])
        ref = _pairs(res["jax"]["cache"])
        for f in FORMS:
            print(scenario, f, res[f]["rows"], "correspondences not in JAX's set:",
                  len(_pairs(res[f]["cache"]) - ref))


if __name__ == "__main__":
    if sys.argv[1:2] == ["run"]:
        run(*sys.argv[2:5])
    else:
        main()

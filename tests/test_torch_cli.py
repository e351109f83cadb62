"""The PyTorch port's command surface against the JAX package's:
`cli.main(["alignment" | "metric" | "debug", config.yaml])` on one
synthetic PLY pair in two working directories, the `measure`, `compare` and
`keypoint` test types, the LGR_PROFILE trace, and the device rule (the card
unless the caller names another device).

The pair is the bump terrain of tests/test_cli_e2e.py (copied, with each
scan sampled on an axis-aligned square of its own frame and bumps of at
most 2 units), at 16,000 points a side: the loader's fine downsample
leaves ~1,800 rows a side to register.  On it the JAX package's capped
density grid holds every point (at most 26 a cell of its cap of 32), so
both packages preprocess to the same rows.  The setting is inside the
staged envelope: keypoint any, mutual (lr) matching, FPFH with a fixed
feature radius, RANSAC on the correspondence metric.
"""
import contextlib
import io
import os
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from lidar_global_registration_tpu import cli as jcli
from lidar_global_registration_tpu.analysis import AlignmentAnalysis
from lidar_global_registration_tpu_torch import cli as tcli
from lidar_global_registration_tpu_torch.utils.io import save_transformation, write_ply

torch.set_num_threads(2)

N = 16000
ANG = 0.6
T_B = np.array([12.0, -8.0, 1.0])
CONFIG = ("source: scanA.ply\ntarget: scanB.ply\nground_truth: ground_truth.csv\n"
          "viewpoints: viewpoints.csv\ndescriptor: fpfh\nkeypoint: any\nmatching: lr\n"
          "metric: correspondences\nfeature_radius: 5.0\n")


def make_scan_pair(dirpath, n=N, seed=7):
    """Two overlapping scans of one random-bump terrain (scan B's frame is
    turned by ANG about z and moved by T_B), the ground-truth poses and
    the scanner viewpoints, written with the port's writers."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform([-10, -20], [60, 50], size=(60, 2))
    widths = rng.uniform(1.0, 4.0, size=60)
    heights = rng.uniform(-2.0, 2.0, size=60)

    def height(xy):
        z = np.zeros(len(xy))
        for c, w, h in zip(centers, widths, heights):
            z += h * np.exp(-np.sum((xy - c) ** 2, axis=1) / (2 * w * w))
        return z + 0.02 * rng.normal(size=len(xy))

    R = np.array([[np.cos(ANG), -np.sin(ANG), 0], [np.sin(ANG), np.cos(ANG), 0], [0, 0, 1]])
    xy = rng.uniform(0, 40, size=(n, 2))
    a = np.column_stack([xy, height(xy)])
    uv = rng.uniform(0, 40, size=(n, 2))
    b = np.column_stack([uv, height(uv @ R[:2, :2].T + T_B[:2]) - T_B[2]])
    write_ply(os.path.join(dirpath, "scanA.ply"), a.astype(np.float32))
    write_ply(os.path.join(dirpath, "scanB.ply"), b.astype(np.float32))
    pose_b = np.eye(4, dtype=np.float32)
    pose_b[:3, :3], pose_b[:3, 3] = R, T_B
    gt_csv = os.path.join(dirpath, "ground_truth.csv")
    save_transformation(gt_csv, "scanA.ply", np.eye(4, dtype=np.float32))
    save_transformation(gt_csv, "scanB.ply", pose_b)
    vp_a = np.array([20.0, 20.0, 150.0])
    vp_b = R.T @ (vp_a - T_B)
    with open(os.path.join(dirpath, "viewpoints.csv"), "w") as f:
        f.write("reading,x,y,z\n")
        f.write(f"scanA.ply,{vp_a[0]},{vp_a[1]},{vp_a[2]}\n")
        f.write(f"scanB.ply,{vp_b[0]},{vp_b[1]},{vp_b[2]}\n")


def _csv(path):
    lines = open(path).read().strip().splitlines()
    return lines[0].split(","), [ln.split(",") for ln in lines[1:]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """`alignment` then `metric` through each package, each in its own
    directory holding the same files."""
    out = {}
    for name, main, kw in (("jax", jcli.main, {}), ("port", tcli.main, {"device": "cpu"})):
        d = tmp_path_factory.mktemp(name)
        make_scan_pair(str(d))
        (d / "config.yaml").write_text(CONFIG)
        log = io.StringIO()
        with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(log):
            mp.chdir(d)
            main(["alignment", "config.yaml"], **kw)
            main(["metric", "config.yaml"], **kw)
        out[name] = dict(dir=d, log=log.getvalue(),
                         results=_csv(d / "data/debug/test_results.csv"),
                         metrics=_csv(d / "data/debug/test_metrics.csv"))
    return out


def test_pair_scenes_are_the_same(runs):
    a, b = (open(runs[k]["dir"] / "scanB.ply", "rb").read() for k in ("jax", "port"))
    assert a == b


def test_both_converge_within_the_pose_bounds(runs):
    """tests/test_cli_e2e.py's bounds: 3 degrees, one unit."""
    for name in ("jax", "port"):
        header, (row,) = runs[name]["results"]
        r = dict(zip(header, row))
        assert r["converged"] == "1", name
        assert float(r["r_err"]) < np.deg2rad(3.0) and float(r["t_err"]) < 1.0, (name, r)
        assert float(r["overlap_rmse"]) < float(r["distance_thr"]), (name, r)


SETTING_COLUMNS = ("version", "descriptor", "testname", "nr_points", "edge_thr",
                   "matching_type", "randomness", "lrf_type", "metric_type", "alignment_type",
                   "keypoint_type", "time_cs", "score_type", "normal_nr_points", "reestimate",
                   "scale", "cluster_k", "feature_radius", "converged")


def test_results_rows_match_jax(runs):
    """The same 38-column header, the same setting columns (every column
    that is not a measured float or count); the densities that set the
    radii within 1e-5 relative (the downsamples round xyz in the last bits);
    the correspondence counts within 5 % and the inliers within 25 % (the
    two packages draw other RANSAC samples, and FPFH bin-edge pairs flip a
    few near-tied mutual matches)."""
    (jh, (jr,)), (th, (tr,)) = runs["jax"]["results"], runs["port"]["results"]
    assert th == jh == AlignmentAnalysis.HEADER.strip().split(",")
    assert len(th) == 38
    j, t = dict(zip(jh, jr)), dict(zip(th, tr))
    for col in SETTING_COLUMNS:
        assert t[col] == j[col], col
    for col in ("distance_thr", "iss_radius_src", "iss_radius_tgt"):
        assert float(t[col]) == pytest.approx(float(j[col]), rel=1e-5), col
    assert abs(int(t["correspondences"]) - int(j["correspondences"])) <= 0.05 * int(
        j["correspondences"])
    assert abs(int(t["inliers"]) - int(j["inliers"])) <= 0.25 * int(j["inliers"])
    assert int(t["correct_inliers"]) > 100 and int(t["correct_correspondences"]) > 100
    for col in ("overlap", "normal_diff"):  # under the GT: the same clouds
        assert float(t[col]) == pytest.approx(float(j[col]), rel=0.05, abs=0.02), col


def test_artifacts_have_the_jax_names(runs):
    """The correspondence cache and the transformations.csv rows under the
    JAX package's names (the cache key `metric` reads back): the same
    fields but the ISS radii, which print the densities to six decimals
    (3.016764 here against JAX's 3.016766: the downsamples round xyz in the
    last bits)."""
    names = {}
    for k in ("jax", "port"):
        d = runs[k]["dir"] / "data/debug"
        (sub,) = [p for p in d.iterdir() if p.is_dir()]
        (cache,) = sub.iterdir()
        rows = [ln.split(",")[0] for ln in (d / "transformations.csv").read_text().splitlines()]
        assert rows[0] == "reading" and len(rows) == 3
        assert rows[1].startswith("scanA_scanB_transformation_gt_")
        assert cache.name.startswith("scanA_scanB_correspondences_352_fpfh_bf_any_default_lr_1_30_1_")
        names[k] = [_without_radii(n) for n in [sub.name, cache.name] + rows[1:]]
    assert names["port"] == names["jax"]


def _without_radii(name: str) -> str:
    """A construct_name with its ISS radii (the first two fields printed
    with six decimals) blanked."""
    parts = name.split("_")
    radii = [i for i, p in enumerate(parts) if re.fullmatch(r"\d+\.\d{6}", p)][:2]
    return "_".join("r" if i in radii else p for i, p in enumerate(parts))


def test_metric_rows(runs):
    """`metric` re-scores each package's own cached transform: the same
    header and row name, the cached transform's inliers equal to the
    alignment's (both use the correspondence metric), positive closest-plane
    inliers, and the GT's counts within 25 % of the JAX package's."""
    (jh, (jr,)), (th, (tr,)) = runs["jax"]["metrics"], runs["port"]["metrics"]
    assert th == jh and len(th) == 9
    assert _without_radii(tr[0]) == _without_radii(jr[0])
    t = dict(zip(th, tr))
    header, (row,) = runs["port"]["results"]
    res = dict(zip(header, row))
    assert int(t["inliers_corr"]) == int(res["inliers"])
    assert float(t["metric_corr"]) == pytest.approx(float(res["metric"]), rel=1e-5)
    assert int(t["inliers_icp"]) > 0 and int(t["inliers_icp_gt"]) > 0
    j = dict(zip(jh, jr))
    for col in ("inliers_icp_gt", "inliers_corr_gt"):
        assert abs(int(t[col]) - int(j[col])) <= 0.25 * int(j[col]), col


def test_step_lines_are_printed(runs):
    log = runs["port"]["log"]
    for word in ("# load scanA.ply: read", "dedup", "(16000 / 16000 kept)", "downsample",
                 "normals", "# alignment", "analysis", "converged: true", "appended"):
        assert word in log, word
    assert "# device" not in log  # the device report is the card's


def test_measure_through_the_port(tmp_path, monkeypatch):
    """A `tests:` list with one `measure` entry, n_times 2, reseeded (so
    each run draws other samples): at least one run succeeds under the
    reference's rule (converged and overlap_rmse < distance_thr), as
    tests/test_cli_e2e.py asks of the JAX package."""
    make_scan_pair(str(tmp_path))
    body = "".join(f"        {ln}\n" for ln in CONFIG.strip().splitlines())
    (tmp_path / "multi.yaml").write_text("tests:\n    - measure:\n" + body + "        n_times: 2\n")
    monkeypatch.chdir(tmp_path)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        tcli.main(["alignment", "multi.yaml"], device="cpu")
    header, rows = _csv(tmp_path / "data/debug/test_measurements.csv")
    assert header == ["testname", "success_rate", "mae", "sae", "mte", "ste", "mrmse", "srmse",
                      "mtime", "stime"]
    (row,) = rows
    assert row[0].startswith("scanA_scanB_measure_352_fpfh_bf_ransac_any")
    assert float(row[1]) >= 0.5 and float(row[2]) < np.deg2rad(3.0)
    assert log.getvalue().count("Starting alignment...") == 2
    assert f"# measure: success rate {round(2 * float(row[1]))}/2" in log.getvalue()


def _new_files(d: Path, before: set) -> list[str]:
    """The files written under d/data/debug since `before`, by name with
    the ISS radii blanked."""
    now = {p for p in (d / "data/debug").rglob("*") if p.is_file()}
    return sorted(_without_radii(p.name) for p in now - before)


def _tests_entry(d: Path, entry: str, body: str = CONFIG) -> list[str]:
    lines = "".join(f"        {ln}\n" for ln in body.strip().splitlines())
    (d / "c.yaml").write_text(f"tests:\n    - {entry}:\n" + lines)
    return ["alignment", "c.yaml"]


EXPECTED = {  # the artifacts of each entry, by name (tests/test_cli_e2e.py's command surface)
    "debug": ["downsampled_src", "downsampled_tgt"] + [
        f"temperature_{k}_{s}" for k in ("dists", "distances", "histogram", "normal_diffs")
        for s in ("src", "tgt")],
    "compare": [f"temperature{g}_{k}_{s}" for g in ("", "_gt")
                for k in ("dists", "distances", "histogram", "normal_diffs")
                for s in ("src", "tgt")],
    "keypoint": ["downsampled_src", "downsampled_tgt", "subvoxel_kps_src", "subvoxel_kps_tgt"],
}


@pytest.mark.parametrize("entry", ["debug", "compare", "keypoint"])
def test_unported_commands_raise(runs, tmp_path, entry):
    """(Named when the port refused these.)  `debug` and the `compare` /
    `keypoint` test types run through each package on a copy of its own
    `alignment` directory (its own caches: the ISS radii in the names
    differ in the sixth decimal): the same artifact names, which are those
    the JAX package's command surface writes, the same printed counts
    (keypoint: every preprocessed row a keypoint, keypoint any), and the
    compare lines for both hypotheses."""
    new, logs = {}, {}
    for name, main, kw in (("jax", jcli.main, {}), ("port", tcli.main, {"device": "cpu"})):
        d = tmp_path / name
        shutil.copytree(runs[name]["dir"], d)
        before = {p for p in (d / "data/debug").rglob("*") if p.is_file()}
        argv = ["debug", "config.yaml"] if entry == "debug" else _tests_entry(d, entry)
        log = io.StringIO()
        with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(log):
            mp.chdir(d)
            main(argv, **kw)
        new[name], logs[name] = _new_files(d, before), log.getvalue()
    assert new["port"] == new["jax"]
    stems = sorted(n.split("_352_")[0].removeprefix("scanA_scanB_") for n in new["port"])
    assert stems == sorted(EXPECTED[entry])
    if entry == "debug":
        assert "debug artifacts written" in logs["port"]
    elif entry == "compare":
        for label in ("incorrect", "correct"):
            got = [re.search(rf"\t{label} hypothesis: (\d+) points, ([\d.e+-]+) weighted", logs[k])
                   for k in ("jax", "port")]
            assert all(got), label
            (nj, _wj), (nt, wt) = (g.groups() for g in got)
            assert int(nt) > 1000 and float(wt) > 0
            assert abs(int(nt) - int(nj)) <= 0.01 * int(nj), label
    else:
        counts = [re.search(r"(\d+) src / (\d+) tgt keypoints", logs[k]).groups()
                  for k in ("jax", "port")]
        assert counts[0] == counts[1] == ("1748", "1782")
        assert logs["port"].count("# keypoint subvoxel") == 2


def test_debug_iss_saliency_and_weights(tmp_path):
    """`debug` of an ISS, weighted closest-plane configuration (the host
    path) after the port's `alignment`: the ISS saliency and weights dumps
    beside the other artifacts, under the names the JAX package's `debug`
    gives them on the same caches (re-keyed to its names, whose ISS radii
    differ in the sixth decimal), one vertex a preprocessed row; the
    saliency colours within one level of JAX's on at most 10 rows a side
    (measured: 2 of ~1,750 a side; the saliencies differ in the last float32
    bits, JAX's XLA sums against K3's plain version, and sit on a bin
    edge of the ramp)."""
    import numpy as np

    from lidar_global_registration_tpu.utils import naming as jnaming
    from lidar_global_registration_tpu.utils.config import Config as JConfig
    from lidar_global_registration_tpu_torch.utils.io import read_ply

    body = CONFIG.replace("keypoint: any", "keypoint: iss").replace(
        "metric: correspondences", "metric: weighted_closest_plane\nweight: exp_curvature")
    d = tmp_path / "port"
    d.mkdir()
    make_scan_pair(str(d))
    (d / "config.yaml").write_text(body)
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(io.StringIO()):
        mp.chdir(d)
        tcli.main(["alignment", "config.yaml"], device="cpu")
        shutil.copytree(d, tmp_path / "jax")
        before = {p for p in (d / "data/debug").rglob("*") if p.is_file()}
        tcli.main(["debug", "config.yaml"], device="cpu")
        port = _new_files(d, before)
        # the port's caches under the JAX package's names
        jd = tmp_path / "jax"
        mp.chdir(jd)
        (params,) = jcli._load_common(JConfig.load("config.yaml"))[4]
        (cache,) = (jd / "data/debug/scanA_scanB").glob("*correspondences*.csv")
        shutil.copy(cache, jnaming.construct_path(params, "correspondences", "csv", True, False,
                                                  False))
        tf = jd / "data/debug/transformations.csv"
        row = tf.read_text().strip().splitlines()[-1].split(",")
        with open(tf, "a") as f:
            f.write(",".join([jnaming.construct_name(params, "transformation")] + row[1:]) + "\n")
        before = {p for p in (jd / "data/debug").rglob("*") if p.is_file()}
        jcli.main(["debug", "config.yaml"])
    assert port == _new_files(jd, before)
    stems = sorted(n.split("_352_")[0].removeprefix("scanA_scanB_") for n in port)
    assert stems == sorted(EXPECTED["debug"] + ["iss_saliency_src", "iss_saliency_tgt",
                                                "weights"])
    for side, rows in (("src", 1748), ("tgt", 1782)):
        (tp,), (jp,) = ((x / "data/debug/scanA_scanB").glob(f"*iss_saliency_{side}_*.ply")
                        for x in (d, jd))
        t, j = read_ply(str(tp))[0], read_ply(str(jp))[0]
        assert len(t["x"]) == len(j["x"]) == rows
        diff = np.stack([t[c].astype(int) - j[c].astype(int) for c in ("red", "green", "blue")])
        assert np.abs(diff).max() <= 1 and (diff != 0).any(0).sum() <= 10


def test_profile_hook_writes_a_trace(runs, tmp_path, monkeypatch, capsys):
    """LGR_PROFILE=<dir> traces the whole command with torch.profiler (CPU
    activity on the CPU) and writes a Chrome trace there."""
    import json

    d = tmp_path / "port"
    shutil.copytree(runs["port"]["dir"], d)
    monkeypatch.setenv("LGR_PROFILE", str(tmp_path / "trace"))
    monkeypatch.chdir(d)
    tcli.main(["metric", "config.yaml"], device="cpu")
    (trace,) = (tmp_path / "trace").glob("trace_*.json")
    assert f"[profiler] trace written to {trace}" in capsys.readouterr().out
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"aten::sort", "aten::index"} <= names


def test_unknown_test_type_and_bad_syntax(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "c.yaml").write_text("tests:\n    - frobnicate:\n        source: x.ply\n")
    tcli.main(["alignment", "c.yaml"], device="cpu")
    assert "Test type frobnicate isn't supported!" in capsys.readouterr().out
    for argv in ([], ["align", "c.yaml"], ["alignment"]):
        with pytest.raises(SystemExit):
            tcli.main(argv, device="cpu")
        assert "Syntax is: python -m lidar_global_registration_tpu_torch" in capsys.readouterr().out


def test_default_device_is_the_card(tmp_path, monkeypatch):
    """main() without a device runs on CUDA; with no card it raises, and
    never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    make_scan_pair(str(tmp_path), n=500)
    (tmp_path / "c.yaml").write_text(CONFIG)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["alignment", "c.yaml"])
    from lidar_global_registration_tpu_torch.models import pipeline

    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.cloud_from_ply(str(tmp_path / "scanA.ply"))
    assert not (tmp_path / "data").exists()

"""Parity: the PyTorch port's debug artifact writers (utils/debug_viz.py)
against the JAX package's, on the same clouds, correspondences and
transforms, each package writing into its own directory: the same file
names, vertex counts, coordinates, uint8 colours, CSV rows and face lists.

The scene is one bump terrain of 3,000 points with normals and a turned,
thinned, noisy copy of it.  The JAX package's nearest-point queries keep 64
points a cell (the temperature maps' grid of cell 2 distance_thr, the point
ids' doubling grid); no cell of this scene comes near that (asserted), so
the port's exact queries find the same points.  Positions under a transform
differ in the last float32 bit (JAX's matmul against the port's
elementwise products), which can move a temperature colour by one level
where the float sits on a bin edge: the tests allow one level and count
such rows (measured in each test).
"""
import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_global_registration_tpu import types as jtypes
from lidar_global_registration_tpu.ops.density import _auto_cell_size
from lidar_global_registration_tpu.utils import debug_viz as jdv
from lidar_global_registration_tpu_torch import types as ttypes
from lidar_global_registration_tpu_torch.ops.normals import estimate_normals_knn
from lidar_global_registration_tpu_torch.utils import debug_viz as tdv
from lidar_global_registration_tpu_torch.utils.io import read_ply
from test_torch_analysis import max_bucket

torch.set_num_threads(2)

N = 3000
THR = 0.3


def _turn(deg: float, shift) -> np.ndarray:
    a = np.deg2rad(deg)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
    T[:3, 3] = shift
    return T


@pytest.fixture(scope="module")
def scene():
    """src (3,000 terrain points, kNN normals), tgt = src under T_gt,
    thinned to 2,400 rows with 5 mm of noise (its normals turned with it),
    an estimate 1 degree and 0.1 off the GT, 300 correspondences with
    thresholds, 150 keypoint rows, inlier / correct masks and weights."""
    rng = np.random.default_rng(11)
    centers = rng.uniform(0, 30, (25, 2))
    widths = rng.uniform(1.0, 4.0, 25)
    heights = rng.uniform(-1.5, 1.5, 25)
    xy = rng.uniform(0, 30, (N, 2))
    z = sum(h * np.exp(-((xy - c) ** 2).sum(1) / (2 * w * w))
            for c, w, h in zip(centers, widths, heights))
    src = np.column_stack([xy, z]).astype(np.float32)
    normal = estimate_normals_knn(ttypes.Cloud.from_numpy(src), k=10,
                                  viewpoint=[15.0, 15.0, 50.0]).normal[:N].numpy()
    T_gt = _turn(20.0, [1.0, -2.0, 0.3])
    keep = np.sort(rng.permutation(N)[:2400])
    tgt = (src[keep] @ T_gt[:3, :3].T + T_gt[:3, 3]
           + rng.normal(scale=0.005, size=(2400, 3))).astype(np.float32)
    tgt_normal = (normal[keep] @ T_gt[:3, :3].T).astype(np.float32)
    M = 300
    q = np.sort(rng.choice(len(keep), M, replace=False))
    return dict(src=src, normal=normal, tgt=tgt, tgt_normal=tgt_normal, T_gt=T_gt,
                tn=_turn(1.0, [0.1, 0.0, 0.0]) @ T_gt,
                query=keep[q], match=np.where(rng.uniform(size=M) < 0.8, q,
                                              rng.integers(0, len(keep), M)),
                threshold=rng.uniform(0.1, THR, M).astype(np.float32),
                kp=np.sort(rng.choice(2400, 150, replace=False)),  # rows of both clouds
                inliers=rng.uniform(size=M) < 0.6, correct=rng.uniform(size=M) < 0.5,
                weights=rng.gamma(2.0, 1.0, 3072).astype(np.float32))  # the capacity


def _inputs(types, s):
    """One package's clouds, correspondences (capacity 384, padding after
    the 300 valid rows) and parameters."""
    src = types.Cloud.from_numpy(s["src"], s["normal"])
    tgt = types.Cloud.from_numpy(s["tgt"], s["tgt_normal"])
    cap, m = 384, len(s["query"])
    pad = lambda v, fill=0: np.concatenate([v, np.full(cap - m, fill, v.dtype)])  # noqa: E731
    arrs = dict(query=pad(s["query"]), match=pad(s["match"]),
                distance=np.zeros(cap, np.float32), threshold=pad(s["threshold"], 1.0),
                valid=np.arange(cap) < m)
    if types is jtypes:
        arrs = {k: jnp.asarray(v.astype(np.int32) if k in ("query", "match") else v)
                for k, v in arrs.items()}
    else:
        arrs = {k: torch.from_numpy(v.astype(np.int64) if k in ("query", "match") else v)
                for k, v in arrs.items()}
    params = types.AlignmentParameters(
        testname="scanA_scanB", alignment_id="ransac", descriptor_id="fpfh", keypoint_id="iss",
        matching_id="cluster", metric_id="uniformity", lrf_id="default", feature_radius=1.5,
        distance_thr=THR, iss_radius_src=0.5, iss_radius_tgt=0.5)
    return src, tgt, types.Correspondences(**arrs), params


def _both(tmp_path, monkeypatch, s, call):
    """call(dv, src, tgt, corrs, params, kp) in each package's directory;
    returns {package: (directory, printed text)}."""
    out = {}
    for name, types, dv, kp in (("jax", jtypes, jdv, s["kp"].astype(np.int32)),
                                ("port", ttypes, tdv, torch.from_numpy(s["kp"]))):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            call(dv, *_inputs(types, s), kp)
        out[name] = (d, log.getvalue())
    return out


def _files(d):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def _ply(path):
    return read_ply(str(path))[0]


def _colors_within_one_level(a, b) -> int:
    """The colours of two PLY field dicts: at most one level apart; returns
    how many rows differ."""
    ca = np.stack([a[c].astype(np.int32) for c in ("red", "green", "blue")], 1)
    cb = np.stack([b[c].astype(np.int32) for c in ("red", "green", "blue")], 1)
    assert np.abs(ca - cb).max() <= 1
    return int((ca != cb).any(1).sum())


def _same_cloud(a, b, atol=2e-5):
    """Vertex counts and fields of two PLYs: positions and normals within
    atol (the last bits of a transform), colours equal."""
    assert a.keys() == b.keys()
    for k in a:
        if k in ("red", "green", "blue"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            np.testing.assert_allclose(a[k], b[k], atol=atol, err_msg=k)


def test_scene_is_under_the_jax_caps(scene):
    """The temperature maps' grid (cell 2 distance_thr) and the point ids'
    first grid (density._auto_cell_size(cloud, 2); every query is found
    there) keep under 64 points a cell."""
    for xyz in (scene["src"], scene["tgt"]):
        assert max_bucket(xyz, 2 * THR) <= 64
        assert max_bucket(xyz, _auto_cell_size(jtypes.Cloud.from_numpy(xyz), 2)) <= 64


@pytest.mark.parametrize("which", ["colorized", "normals"])
def test_colorized_cloud_and_normals(scene, tmp_path, monkeypatch, which):
    """saveColorizedPointCloud and saveNormals: the GT-aligned source with
    its normals (and one colour), the same in both packages."""
    def call(dv, src, _tgt, _c, params, _kp):
        if which == "colorized":
            dv.save_colorized_cloud(src, scene["T_gt"], dv.COLOR_RED, "kps.ply")
        else:
            dv.save_normals(src, scene["T_gt"], True, params)

    out = _both(tmp_path, monkeypatch, scene, call)
    (jd, _), (td, _) = out["jax"], out["port"]
    assert _files(td) == _files(jd) and len(_files(td)) == 1
    a, b = _ply(jd / _files(jd)[0]), _ply(td / _files(td)[0])
    assert len(b["x"]) == N
    _same_cloud(a, b)


@pytest.mark.parametrize("side", ["src", "tgt"])
@pytest.mark.parametrize("with_corrs", [False, True])
def test_cloud_with_correspondences(scene, tmp_path, monkeypatch, side, with_corrs):
    """savePointCloudWithCorrespondences with keypoints only (the keypoint
    test type) and with correspondences, inliers and correct ones (debug):
    the same name, rows and colours."""
    def call(dv, src, tgt, corrs, params, kp):
        cloud, T = (src, scene["T_gt"]) if side == "src" else (tgt, np.eye(4))
        if with_corrs:
            dv.save_cloud_with_correspondences(cloud, kp, corrs, scene["correct"],
                                               scene["inliers"], params, T, side == "src")
        else:
            dv.save_cloud_with_correspondences(cloud, kp, None, None, None, params, T,
                                               side == "src")

    out = _both(tmp_path, monkeypatch, scene, call)
    (jd, _), (td, _) = out["jax"], out["port"]
    (name,) = _files(td)
    assert _files(jd) == [name] and f"downsampled_{side}" in name
    a, b = _ply(jd / name), _ply(td / name)
    _same_cloud(a, b)
    colours = {tuple(c) for c in np.stack([b["red"], b["green"], b["blue"]], 1)}
    assert len(colours) == (6 if with_corrs else 2)


def test_colorized_weights(scene, tmp_path, monkeypatch):
    """saveColorizedWeights: the same rows, colours within one level of the
    1 % / 99 % quantile ramp (measured: 0 rows differ)."""
    out = _both(tmp_path, monkeypatch, scene, lambda dv, src, _t, _c, params, _kp:
                dv.save_colorized_weights(src, scene["weights"], "weights", params,
                                          scene["tn"]))
    (jd, _), (td, _) = out["jax"], out["port"]
    (name,) = _files(td)
    assert _files(jd) == [name]
    a, b = _ply(jd / name), _ply(td / name)
    assert len(b["x"]) == N
    assert _colors_within_one_level(a, b) == 0


@pytest.mark.parametrize("sparse", [False, True])
def test_correspondence_edges(scene, tmp_path, monkeypatch, sparse):
    """saveCorrespondences: the ASCII PLY of both clouds side by side, one
    face per correspondence edge (100 drawn of 300 with sparse): the same
    header, the same face lines, vertices within 1e-4 of JAX's as printed
    with six digits and colours equal."""
    out = _both(tmp_path, monkeypatch, scene, lambda dv, src, tgt, corrs, params, _kp:
                dv.save_correspondence_edges(src, tgt, corrs, scene["T_gt"], params,
                                             sparse=sparse))
    (jd, _), (td, _) = out["jax"], out["port"]
    (name,) = _files(td)
    assert _files(jd) == [name]
    ja, ta = ((d / name).read_text().splitlines() for d in (jd, td))
    end = ja.index("end_header")
    assert ta[:end + 1] == ja[:end + 1]
    n_v = int(next(ln for ln in ja if ln.startswith("element vertex")).split()[-1])
    n_f = 100 if sparse else 300
    assert n_v == N + 2400 + n_f and len(ja) == len(ta) == end + 1 + n_v + n_f
    assert ta[end + 1 + n_v:] == ja[end + 1 + n_v:]
    jv, tv = (np.array([ln.split() for ln in x[end + 1:end + 1 + n_v]], np.float64)
              for x in (ja, ta))
    np.testing.assert_allclose(tv[:, :3], jv[:, :3], atol=1e-4, rtol=1e-5)
    np.testing.assert_array_equal(tv[:, 3:6], jv[:, 3:6])


def test_temperature_maps(scene, tmp_path, monkeypatch):
    """saveTemperatureMaps: the distance and normal-difference maps of both
    sides (one vertex per valid row), the distance CSVs (the same rows,
    values within 1e-5) and the histogram PNGs, under the same names;
    colours within one level (measured: 0 of 10,800 map rows differ)."""
    out = _both(tmp_path, monkeypatch, scene, lambda dv, src, tgt, _c, params, _kp:
                dv.save_temperature_maps(src, tgt, "temperature", params, THR, scene["tn"]))
    (jd, _), (td, _) = out["jax"], out["port"]
    names = _files(td)
    assert names == _files(jd) and len(names) == 8
    moved = 0
    for name in names:
        if name.endswith(".ply"):
            a, b = _ply(jd / name), _ply(td / name)
            assert len(b["x"]) == (N if "_src_" in name else 2400)
            np.testing.assert_allclose(b["x"], a["x"], atol=2e-5)
            moved += _colors_within_one_level(a, b)
        elif name.endswith(".csv"):
            ja, ta = ((d / name).read_text().split() for d in (jd, td))
            assert ta[0] == ja[0] == "value" and len(ta) == len(ja) > 100
            np.testing.assert_allclose(np.float64(ta[1:]), np.float64(ja[1:]), atol=1e-5)
    assert moved == 0


def test_histograms_skipped_without_matplotlib(scene, tmp_path, monkeypatch):
    """Without matplotlib the port prints one line a PNG and writes the
    distance CSVs and maps all the same."""
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    src, tgt, _c, params = _inputs(ttypes, scene)
    monkeypatch.chdir(tmp_path)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        tdv.save_temperature_maps(src, tgt, "temperature", params, THR, scene["tn"])
    names = _files(tmp_path)
    assert len(names) == 6 and not any(n.endswith(".png") for n in names)
    assert log.getvalue().count("no matplotlib, histogram PNG skipped") == 2


def test_features_csv(scene, tmp_path):
    """saveFeatures: one row per valid descriptor, index then values with
    %g: byte for byte."""
    rng = np.random.default_rng(5)
    feats = rng.uniform(0, 100, (200, 33)).astype(np.float32)
    feats[::7] = 0.0
    valid = rng.uniform(size=200) < 0.8
    idx = np.sort(rng.choice(5000, 200, replace=False))
    for indices in (idx, None):
        jdv.save_features_csv(feats, valid, indices, str(tmp_path / "j" / "h.csv"))
        tdv.save_features_csv(torch.from_numpy(feats), torch.from_numpy(valid),
                              None if indices is None else torch.from_numpy(idx),
                              str(tmp_path / "t" / "h.csv"))
        a, b = ((tmp_path / d / "h.csv").read_bytes() for d in "jt")
        assert a == b and len(a.splitlines()) == valid.sum()


def test_extracted_point_ids(scene, tmp_path, monkeypatch):
    """saveExtractedPointIds of every target point: the same nearest ids in
    the GT-aligned source and in the target (itself), the same coordinates."""
    out = _both(tmp_path, monkeypatch, scene, lambda dv, src, tgt, _c, params, _kp:
                dv.save_extracted_point_ids(src, tgt, scene["T_gt"], params, scene["tgt"]))
    (jd, _), (td, _) = out["jax"], out["port"]
    (name,) = _files(td)
    assert _files(jd) == [name] and "_ids_" in name
    ja, ta = ((d / name).read_text().splitlines() for d in (jd, td))
    assert ta[0] == ja[0] and len(ta) == len(ja) == 2401
    j, t = (np.array([ln.split(",") for ln in x[1:]], np.float64) for x in (ja, ta))
    np.testing.assert_array_equal(t[:, :2], j[:, :2])
    np.testing.assert_array_equal(t[:, 1], np.arange(2400))
    np.testing.assert_allclose(t[:, 2:], j[:, 2:], atol=1e-4, rtol=1e-5)

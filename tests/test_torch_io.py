"""The PyTorch port's host IO and records against the JAX package's:
utils/io.py (PLY both ways, binary and ascii, the pose / viewpoint /
correspondence / iterations CSVs byte for byte), utils/naming.py (the
artifact names that the `metric` command reads back), the exact-duplicate
filter (ops/downsample.dedup_points against the native hash set) and the
Cloud / Correspondences helpers of types.py.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_global_registration_tpu import types as jtypes
from lidar_global_registration_tpu.utils import io as jio
from lidar_global_registration_tpu.utils import naming as jnaming
from lidar_global_registration_tpu.utils import native
from lidar_global_registration_tpu_torch import types as ttypes
from lidar_global_registration_tpu_torch.ops.downsample import dedup_points
from lidar_global_registration_tpu_torch.utils import io as tio
from lidar_global_registration_tpu_torch.utils import naming as tnaming

torch.set_num_threads(2)


def _cloud_fields(n=300, seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(scale=20.0, size=(n, 3)).astype(np.float32)
    normal = rng.normal(size=(n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    color = rng.integers(0, 256, size=(n, 3)).astype(np.uint8)
    intensity = rng.uniform(0, 1, size=n).astype(np.float32)
    curvature = rng.uniform(0, 0.3, size=n).astype(np.float32)
    return dict(xyz=xyz, normal=normal, color=color, intensity=intensity, curvature=curvature)


WRITERS = {"jax": jio.write_ply, "port": tio.write_ply}
READERS = {"jax": jio.read_ply, "port": tio.read_ply}


@pytest.mark.parametrize("extras", ["xyz", "normals", "all"])
@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_ply_round_trip(tmp_path, writer, reader, binary, extras):
    """One package writes, the other reads: the same field names in the
    same order, every field np.array_equal to what was written (ascii
    through %g, so the written values are rounded first)."""
    f = _cloud_fields()
    kw = {}
    if extras in ("normals", "all"):
        kw["normal"] = f["normal"]
    if extras == "all":
        kw.update(color=f["color"], intensity=f["intensity"], curvature=f["curvature"])
    path = str(tmp_path / "c.ply")
    WRITERS[writer](path, f["xyz"], binary=binary, **kw)
    fields, names = READERS[reader](path)
    want_fields, want_names = READERS[writer](path)
    assert names == want_names
    expect = ["x", "y", "z"] + (["red", "green", "blue", "intensity"] if extras == "all" else [])
    expect += ["normal_x", "normal_y", "normal_z"] if extras != "xyz" else []
    expect += ["curvature"] if extras == "all" else []
    assert names == expect
    for name in names:
        np.testing.assert_array_equal(fields[name], want_fields[name])
    rnd = (lambda a: np.array([float(f"{v:g}") for v in a], np.float32)) if not binary else (
        lambda a: a)
    for i, c in enumerate("xyz"):
        np.testing.assert_array_equal(fields[c], rnd(f["xyz"][:, i]))
    assert tio.cloud_has_normals(names) == jio.cloud_has_normals(names) == (extras != "xyz")
    # and back: the reader's fields rewritten by the reader's package are
    # the same file when both wrote binary
    if binary:
        again = str(tmp_path / "again.ply")
        WRITERS[reader](again, f["xyz"], binary=True, **kw)
        assert open(again, "rb").read() == open(path, "rb").read()


def test_ply_big_endian_and_doubles(tmp_path):
    """A binary big-endian file with double, int and uchar properties and a
    second element: both readers give the same fields."""
    n = 50
    rng = np.random.default_rng(1)
    dt = np.dtype([("x", ">f8"), ("y", ">f8"), ("z", ">f8"), ("label", ">i4"), ("red", "u1")])
    rec = np.zeros(n, dt)
    for c in "xyz":
        rec[c] = rng.normal(size=n)
    rec["label"] = rng.integers(-5, 5, size=n)
    rec["red"] = rng.integers(0, 255, size=n)
    path = tmp_path / "be.ply"
    hdr = ("ply\nformat binary_big_endian 1.0\ncomment made by hand\nelement vertex 50\n"
           "property double x\nproperty double y\nproperty double z\nproperty int label\n"
           "property uchar red\nelement face 0\nproperty list uchar int vertex_indices\n"
           "end_header\n")
    path.write_bytes(hdr.encode() + rec.tobytes())
    got, names = tio.read_ply(str(path))
    want, wnames = jio.read_ply_numpy(str(path))
    assert names == wnames == ["x", "y", "z", "label", "red"]
    for k in names:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    np.testing.assert_array_equal(got["x"], rec["x"])


def test_ply_errors(tmp_path):
    bad = tmp_path / "bad.ply"
    bad.write_bytes(b"plx\n")
    with pytest.raises(ValueError, match="not a PLY"):
        tio.read_ply(str(bad))
    bad.write_bytes(b"ply\nformat ascii 1.0\nelement vertex 1\n")
    with pytest.raises(ValueError, match="truncated"):
        tio.read_ply(str(bad))


def _params(types, **kw):
    return types.AlignmentParameters(**{
        "testname": "scanA_scanB", "distance_thr": 0.25, "iss_radius_src": 0.1234567,
        "iss_radius_tgt": 0.2, "descriptor_id": "fpfh", "keypoint_id": "iss",
        "metric_id": "uniformity", **kw})


NAME_CASES = {
    "defaults": {},
    "ratio": dict(matching_id="ratio", ratio_k=3),
    "weighted": dict(metric_id="weighted_closest_plane", weight_id="harris"),
    "weighted_constant": dict(metric_id="weighted_closest_plane"),
    "feature_radius": dict(feature_radius=0.75),
    "flann_gror": dict(use_bfmatcher=False, alignment_id="gror", lrf_id="gravity",
                       reestimate_frames=False, scale_factor=1.5, cluster_k=30,
                       feature_nr_points=300, normal_nr_points=20, randomness=2),
}
NAME_FLAGS = [(True, True, True, False), (True, False, False, False), (False, True, True, True),
              (True, True, False, False)]


@pytest.mark.parametrize("case", sorted(NAME_CASES))
def test_construct_name_and_path_equal_jax(case, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tp = _params(ttypes, **NAME_CASES[case])
    jp = _params(jtypes, **NAME_CASES[case])
    for flags in NAME_FLAGS:
        assert tnaming.construct_name(tp, "transformation", *flags) == \
            jnaming.construct_name(jp, "transformation", *flags)
    assert tnaming.construct_path(tp, "correspondences", "csv", True, False, False) == \
        jnaming.construct_path(jp, "correspondences", "csv", True, False, False)
    assert tnaming.construct_path(tp, "kps") == jnaming.construct_path(jp, "kps")
    for with_version in (True, False):
        assert tnaming.construct_path_simple("test", "results", "csv", with_version) == \
            jnaming.construct_path_simple("test", "results", "csv", with_version)
    for k in ("DATA_DEBUG_PATH", "TRANSFORMATIONS_CSV", "ITERATIONS_CSV", "VERSION",
              "SUBVERSION"):
        assert getattr(tnaming, k) == getattr(jnaming, k)


def _write_csvs(io, root, corrs):
    pose = np.arange(16, dtype=np.float32).reshape(4, 4) / 7.0
    io.save_transformation(os.path.join(root, "poses.csv"), "scanA.ply", np.eye(4, dtype=np.float32))
    io.save_transformation(os.path.join(root, "poses.csv"), "scanB.ply", pose)
    rng = np.random.default_rng(3)
    src = rng.normal(size=(40, 3)).astype(np.float32) * 30
    tgt = rng.normal(size=(50, 3)).astype(np.float32) * 30
    io.save_correspondences_csv(os.path.join(root, "corr.csv"), src, tgt, corrs)
    io.save_iterations_info(os.path.join(root, "it.csv"), "t1", [0.5, 0.25], ["lr", "cluster"])
    with open(os.path.join(root, "vp.csv"), "w") as f:
        f.write("reading,x,y,z\nscanA.ply,1.5,2,3\nscanB.ply,-1,0.25,7\n")


def _corrs(types, to_dev):
    rng = np.random.default_rng(4)
    q = rng.integers(0, 40, size=20)
    m = rng.integers(0, 50, size=20)
    d = rng.uniform(0, 1, size=20).astype(np.float32)
    t = rng.uniform(0.1, 0.3, size=20).astype(np.float32)
    v = rng.uniform(size=20) < 0.7
    return types.Correspondences(to_dev(q), to_dev(m), to_dev(d), to_dev(t), to_dev(v))


def test_csvs_byte_for_byte(tmp_path):
    """The pose, correspondence and iterations CSVs written by both packages
    are the same bytes, and each reader reads the other's files alike."""
    roots = {}
    for name, io, types, to_dev in (("jax", jio, jtypes, jnp.asarray),
                                     ("port", tio, ttypes, torch.as_tensor)):
        roots[name] = str(tmp_path / name)
        os.makedirs(roots[name])
        _write_csvs(io, roots[name], _corrs(types, to_dev))
    for f in ("poses.csv", "corr.csv", "it.csv"):
        a = open(os.path.join(roots["jax"], f), "rb").read()
        assert a == open(os.path.join(roots["port"], f), "rb").read(), f
        assert len(a) > 20
    r = roots["jax"]
    pj, pt = jio.read_pose_table(f"{r}/poses.csv"), tio.read_pose_table(f"{r}/poses.csv")
    assert pj.keys() == pt.keys() == {"scanA.ply", "scanB.ply"}
    np.testing.assert_array_equal(tio.get_transformation_gt(f"{r}/poses.csv", "scanB.ply",
                                                            "scanA.ply"),
                                  jio.get_transformation_gt(f"{r}/poses.csv", "scanB.ply",
                                                            "scanA.ply"))
    assert tio.get_transformation_gt(f"{r}/poses.csv", "scanB.ply", "nope.ply") is None
    np.testing.assert_array_equal(tio.get_transformation(f"{r}/poses.csv", "scanB.ply"),
                                  pj["scanB.ply"])
    with pytest.raises(KeyError):
        tio.get_transformation(f"{r}/poses.csv", "nope")
    for a, b in zip(tio.read_correspondences_csv(f"{r}/corr.csv"),
                    jio.read_correspondences_csv(f"{r}/corr.csv")):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert tio.read_correspondences_csv(f"{r}/missing.csv") is None
    assert tio.get_iterations_info(f"{r}/it.csv", "t1") == jio.get_iterations_info(f"{r}/it.csv",
                                                                                   "t1")
    for scan in ("scanA.ply", "/some/dir/scanB.ply", "scanC.ply"):
        a = tio.load_viewpoint(f"{r}/vp.csv", scan)
        b = jio.load_viewpoint(f"{r}/vp.csv", scan)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert tio.load_viewpoint(None, "scanA.ply") is None


def test_dedup_points_equals_native():
    """Planted exact duplicates (repeats of earlier and later rows, runs of
    three) in a cloud with near-duplicates one ulp apart: the same
    keep-mask as the native hash set (first occurrence kept)."""
    rng = np.random.default_rng(5)
    x = rng.normal(scale=10.0, size=(3000, 3)).astype(np.float32)
    x[100:150] = x[:50]
    x[2000:2010] = x[2500:2510]
    x[2900] = x[2901] = x[7]
    x[1500] = np.nextafter(x[1499], np.float32(np.inf))  # one ulp apart: kept
    x[1700:1705, 2] = 0.0  # equal z, distinct x / y
    assert native.available()
    want = native.dedup_points(x)
    got = dedup_points(torch.from_numpy(x))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert int((~want).sum()) == 62
    assert not dedup_points(torch.zeros((0, 3))).numel()


def test_cloud_helpers_equal_jax():
    """Cloud.count / compact / transformed and Correspondences.count /
    empty / to_numpy / compact against the JAX records."""
    rng = np.random.default_rng(6)
    xyz = rng.normal(size=(300, 3)).astype(np.float32)
    nrm = rng.normal(size=(300, 3)).astype(np.float32)
    valid = rng.uniform(size=300) < 0.6
    jc = jtypes.Cloud.from_numpy(xyz, nrm, weight=np.arange(300))
    tc = ttypes.Cloud.from_numpy(xyz, nrm, weight=np.arange(300))
    jc = jtypes.Cloud(jc.xyz, jc.normal, jc.weight, jc.curvature + 0.5,
                      jc.valid.at[:300].set(jnp.asarray(valid)))
    tc = ttypes.Cloud(tc.xyz, tc.normal, tc.weight, tc.curvature + 0.5,
                      torch.cat([torch.from_numpy(valid), tc.valid[300:]]))
    assert int(tc.count()) == int(jc.count()) == int(valid.sum())
    for cap in (None, 256):
        jk, tk = jc.compact(cap), tc.compact(cap)
        assert tk.capacity == jk.capacity
        for f in ("xyz", "normal", "weight", "curvature", "valid"):
            np.testing.assert_array_equal(getattr(tk, f).numpy(), np.asarray(getattr(jk, f)))
    with pytest.raises(ValueError, match="capacity"):
        tc.compact(8)
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.3), np.sin(0.3)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[:3, 3] = [1.0, -2.0, 0.5]
    jm, tm = jc.transformed(jnp.asarray(T)), tc.transformed(torch.from_numpy(T))
    for f in ("xyz", "normal"):
        np.testing.assert_allclose(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                                   rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tm.xyz.numpy()[~tc.valid.numpy()],
                                  np.asarray(jm.xyz)[~np.asarray(jc.valid)])

    jr = _corrs(jtypes, jnp.asarray)
    tr = _corrs(ttypes, torch.as_tensor)
    assert int(tr.count()) == int(jr.count())
    for k, v in jr.to_numpy().items():
        np.testing.assert_array_equal(tr.to_numpy()[k], v)
    for cap in (None, 32):
        jk, tk = jr.compact(cap), tr.compact(cap)
        assert tk.capacity == jk.capacity
        for f in ("query", "match", "distance", "threshold", "valid"):
            np.testing.assert_array_equal(getattr(tk, f).numpy(), np.asarray(getattr(jk, f)))
    je, te = jtypes.Correspondences.empty(5), ttypes.Correspondences.empty(5)
    for f in ("query", "match", "distance", "threshold", "valid"):
        np.testing.assert_array_equal(getattr(te, f).numpy(), np.asarray(getattr(je, f)))

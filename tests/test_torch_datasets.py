"""Parity: the port's dataset tool (tools/datasets_torch.py) against the JAX
package's (tools/datasets.py), command by command, each on its own copy of
one seeded input.  The converters (stanford, eth_gt, perturb, transform,
eth, las) write the same bytes; downsample the same rows within the
loader's tolerance (atol 1e-5; lone voxels bit for bit), row for row, and
the same printed lines; overlap the same matrix and CSV bytes where no cell
of the JAX tool's hash grid holds more than its 64-point cap, and the
float64 brute force everywhere, also where the cap binds and the JAX
matrix reads lower.
"""
import importlib.util
import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import datasets as jtool  # noqa: E402  (tools/datasets.py)
from test_tools_datasets import _write_las  # noqa: E402

from lidar_global_registration_tpu.ops import grid as jgrid  # noqa: E402
from lidar_global_registration_tpu_torch import types as ttypes  # noqa: E402
from lidar_global_registration_tpu_torch.ops import downsample as tds  # noqa: E402
from lidar_global_registration_tpu_torch.utils import io as tio  # noqa: E402

torch.set_num_threads(2)

_spec = importlib.util.spec_from_file_location("datasets_torch_tool",
                                               ROOT / "tools" / "datasets_torch.py")
ttool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ttool)


def _run_jax(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["datasets.py", *argv])
    jtool.main()


def _run_both(tmp_path, monkeypatch, capsys, build, argv_of):
    """build(root) writes the input under tmp_path/jax, copied to
    tmp_path/torch (the configs' paths pointed at the copy); each tool runs
    argv_of(root) on its own tree.  Returns the two roots and each tool's
    printed lines with its root replaced."""
    jroot, troot = tmp_path / "jax", tmp_path / "torch"
    jroot.mkdir()
    build(jroot)
    shutil.copytree(jroot, troot)
    for p in troot.rglob("*.yaml"):
        p.write_text(p.read_text().replace(str(jroot), str(troot)))
    outs = []
    for root, run in ((jroot, lambda a: _run_jax(monkeypatch, a)),
                      (troot, lambda a: ttool.main(a, device="cpu"))):
        capsys.readouterr()
        for argv in argv_of(root):
            run([str(a) for a in argv])
        outs.append(capsys.readouterr().out.replace(str(root), "<root>").splitlines())
    return jroot, troot, outs


def _same_files(jroot: Path, troot: Path):
    """Every file under the two roots has the same relative path and the
    same bytes, each root's path replaced."""
    jfiles = sorted(p.relative_to(jroot) for p in jroot.rglob("*") if p.is_file())
    tfiles = sorted(p.relative_to(troot) for p in troot.rglob("*") if p.is_file())
    assert jfiles == tfiles
    for rel in jfiles:
        want, got = ((root / rel).read_bytes().replace(str(root).encode(), b"<root>")
                     for root in (jroot, troot))
        assert got == want, rel
    return jfiles


def _scan(rng, n=2000, lo=(0.0, 0.0, 0.0), hi=(20.0, 20.0, 2.0)):
    return rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _rot_z(deg):
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _pose(deg, t):
    T = np.eye(4)
    T[:3, :3] = _rot_z(deg)
    T[:3, 3] = t
    return T


def _xyz(path):
    fields, names = tio.read_ply(str(path))
    return np.stack([fields["x"], fields["y"], fields["z"]], axis=1), names


def _dataset(root: Path, poses: dict, normals=("scan0.ply",), seed=1, n=2000):
    """Scans named after `poses` with the given poses in ground_truth.csv
    (the JAX tool's writer); the scans in `normals` carry normals."""
    rng = np.random.default_rng(seed)
    for name in poses:
        xyz = _scan(rng, n)
        tio.write_ply(str(root / name), xyz,
                      normal=_unit(rng, n) if name in normals else None)
    jtool._write_gt(str(root / "ground_truth.csv"), list(poses.items()))


def test_stanford_writes_the_same_bytes(tmp_path, monkeypatch, capsys):
    """Quaternion poses in a .conf and two scans, one with normals and
    non-finite rows: the same clouds and ground_truth.csv."""
    rng = np.random.default_rng(3)

    def build(root):
        raw = root / "raw"
        raw.mkdir()
        lines = ["camera 0 0 0 0 0 0 1"]
        for k, (q, t) in enumerate([((0.0, 0.0, 0.0, 1.0), (0.0, 0.0, 0.0)),
                                    (rng.normal(size=4), rng.uniform(-5, 5, 3))]):
            xyz = _scan(rng, 1500)
            normal = None
            if k == 0:
                xyz[[3, 77, 1000]] = [np.nan, 1.0, 2.0], [0.0, np.inf, 0.0], [-np.inf] * 3
                normal = _unit(rng, len(xyz))
            tio.write_ply(str(raw / f"scan{k}.ply"), xyz, normal=normal)
            lines.append(f"bmesh scan{k}.ply " + " ".join(repr(float(v)) for v in (*t, *q)))
        (raw / "scan.conf").write_text("\n".join(lines) + "\n")

    jroot, troot, outs = _run_both(tmp_path, monkeypatch, capsys, build, lambda r: [
        ["stanford", r / "raw", "-o", r / "out"]])
    files = _same_files(jroot, troot)
    assert Path("out/ground_truth.csv") in files and Path("out/scan1.ply") in files
    assert outs[0] == outs[1] == ["wrote 2 clouds + ground_truth.csv to <root>/out"]
    xyz, names = _xyz(troot / "out" / "scan0.ply")
    assert len(xyz) == 1497 and "normal_x" in names


def test_eth_gt_writes_the_same_bytes(tmp_path, monkeypatch, capsys):
    def build(root):
        rng = np.random.default_rng(4)
        (root / "groundtruth").mkdir()
        for k in range(3):
            tio.write_ply(str(root / f"Hokuyo_{k}.ply"), _scan(rng, 64))
            if k:
                T = _pose(rng.uniform(-90, 90), rng.uniform(-3, 3, 3))
                (root / "groundtruth" / f"Hokuyo_{k}-Hokuyo_0.tfm").write_text(
                    "\n".join(" ".join(repr(float(v)) for v in row) for row in T) + "\n")

    jroot, troot, outs = _run_both(tmp_path, monkeypatch, capsys, build,
                                   lambda r: [["eth_gt", r]])
    _same_files(jroot, troot)
    assert outs[0] == outs[1] == ["wrote ground_truth.csv"]


@pytest.mark.parametrize("flags", [[], ["--with-translation"],
                                   ["--without-rotation", "--with-translation"],
                                   ["--without-rotation"]])
def test_perturb_writes_the_same_bytes(tmp_path, monkeypatch, capsys, flags):
    """The seeded draw, the moved scan (normals too) and the updated GT."""
    def build(root):
        _dataset(root, {"scan0.ply": _pose(10.0, [1.0, 2.0, 0.5]),
                        "scan1.ply": _pose(-35.0, [4.0, -1.0, 0.0])})
        (root / "perturb.yaml").write_text(yaml.safe_dump(
            {"transform": str(root / "scan0.ply"), "ground_truth": str(root / "ground_truth.csv")}))

    jroot, troot, outs = _run_both(tmp_path, monkeypatch, capsys, build, lambda r: [
        ["perturb", r / "perturb.yaml", "--seed", 7, *flags]])
    files = _same_files(jroot, troot)
    assert len(files) == 5  # the moved scan beside its source
    assert outs[0] == outs[1] and len(outs[1]) == 1
    gt = tio.read_pose_table(str(troot / "ground_truth.csv"))
    moved = [f for f in gt if "_transformed" in f]
    assert len(moved) == 1 and (troot / moved[0]).exists()


@pytest.mark.parametrize("steps", [["local"], ["local", "global"]])
def test_transform_writes_the_same_bytes(tmp_path, monkeypatch, capsys, steps):
    """Local to global (the rows under their pose), then back (within 1e-4
    of the scans): the same bytes; a scan outside the dataset's prefix
    stays as it was."""
    before = {}

    def build(root):
        _dataset(root, {"scan0.ply": _pose(20.0, [3.0, -2.0, 1.0]),
                        "scan1.ply": _pose(-60.0, [-7.5, 4.25, 0.0]),
                        "other.ply": _pose(5.0, [1.0, 1.0, 1.0])})
        (root / "scan.yaml").write_text(yaml.safe_dump(
            {"ground_truth": str(root / "ground_truth.csv")}))
        before.update({f: _xyz(root / f)[0] for f in ("scan0.ply", "scan1.ply", "other.ply")})

    jroot, troot, outs = _run_both(tmp_path, monkeypatch, capsys, build, lambda r: [
        ["transform", r / "scan.yaml", "--current", c] for c in steps])
    _same_files(jroot, troot)
    assert outs[0] == outs[1] == ["transformed scan0.ply", "transformed scan1.ply"] * len(steps)
    gt = tio.read_pose_table(str(troot / "ground_truth.csv"))
    for f, xyz in before.items():
        got = _xyz(troot / f)[0]
        if f == "other.ply":
            np.testing.assert_array_equal(got, xyz)
        elif len(steps) == 1:
            T = gt[f].astype(np.float64)
            np.testing.assert_allclose(got, xyz @ T[:3, :3].T + T[:3, 3], rtol=0, atol=1e-5)
        else:
            np.testing.assert_allclose(got, xyz, rtol=0, atol=1e-4)


def test_eth_writes_the_same_bytes(tmp_path, monkeypatch, capsys):
    """CSV clouds (one with a non-finite row) to PLY and the rewritten GT."""
    def build(root):
        rng = np.random.default_rng(5)
        raw = root / "raw"
        raw.mkdir()
        gt = [",".join(jtool.GT_COLUMNS)]
        for k in range(2):
            pts = rng.uniform(-10, 10, size=(300, 3))
            if k == 1:
                pts[17] = [np.nan, 0.0, 0.0]
            with open(raw / f"Hokuyo_{k}.csv", "w") as f:
                f.write("timestamp,x,y,z\n")
                for i, p in enumerate(pts):
                    f.write(f"{i}," + ",".join(repr(float(v)) for v in p) + "\n")
            T = _pose(rng.uniform(-90, 90), rng.uniform(-3, 3, 3))
            gt.append(f"Hokuyo_{k}.csv," + ",".join(repr(float(v)) for v in T.reshape(-1)))
        (raw / "ground_truth.csv").write_text("\n".join(gt) + "\n")

    jroot, troot, outs = _run_both(tmp_path, monkeypatch, capsys, build, lambda r: [
        ["eth", r / "raw", "-o", r / "out"]])
    _same_files(jroot, troot)
    assert outs[0] == outs[1] == ["wrote 2 clouds + ground_truth.csv to <root>/out"]
    assert len(_xyz(troot / "out" / "Hokuyo_1.ply")[0]) == 299


@pytest.mark.parametrize("version", [(1, 2), (1, 4)])
def test_las_writes_the_same_bytes(tmp_path, monkeypatch, capsys, version):
    """Crafted LAS files (tests/test_tools_datasets.py's writer): the same
    decoded rows and intensities, the same PLY bytes."""
    rng = np.random.default_rng(6)
    xyz = rng.uniform(-50, 80, size=(3000, 3))

    def build(root):
        _write_las(str(root / "a.las"), xyz, version=version)
        _write_las(str(root / "b.las"), xyz[:700] * 0.5, version=version, point_format=3,
                   record_len=34)

    jroot, troot, outs = _run_both(tmp_path, monkeypatch, capsys, build,
                                   lambda r: [["las", r]])
    _same_files(jroot, troot)
    assert outs[0] == outs[1] == ["a.las -> a.ply (3000 points)", "b.las -> b.ply (700 points)"]
    for name in ("a.las", "b.las"):
        jx, ji = jtool.read_las(str(jroot / name))
        tx, ti = ttool.read_las(str(troot / name))
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(_xyz(troot / "a.ply")[0], xyz, rtol=0, atol=1e-3)


def test_las_refuses_what_it_cannot_read(tmp_path, capsys):
    (tmp_path / "x.las").write_bytes(b"NOTLAS" + bytes(400))
    with pytest.raises(ValueError, match="not a LAS file"):
        ttool.main(["las", str(tmp_path)], device="cpu")
    (tmp_path / "x.las").unlink()
    _write_las(str(tmp_path / "z.las"), np.zeros((4, 3)), point_format=1 | 0x80)
    with pytest.raises(ValueError, match="LAZ"):
        ttool.main(["las", str(tmp_path)], device="cpu")
    (tmp_path / "z.las").unlink()
    ttool.main(["las", str(tmp_path)], device="cpu")
    assert capsys.readouterr().out.splitlines()[-1] == f"no .las files in {tmp_path}"


def _downsample_set(root: Path):
    """Two 4,000-point scans with a dense corner (voxels of many points)
    and a sparse rest (many lone voxels), and their poses."""
    rng = np.random.default_rng(8)
    poses = {"scan0.ply": _pose(15.0, [2.0, -1.0, 0.25]), "scan1.ply": _pose(-70.0, [-3.0, 6.0, 1.0])}
    for name in poses:
        xyz = _scan(rng, 4000)
        xyz[:1500] = rng.uniform(0, 1.5, size=(1500, 3)).astype(np.float32)
        tio.write_ply(str(root / name), xyz)
    jtool._write_gt(str(root / "ground_truth.csv"), list(poses.items()))
    (root / "ds.yaml").write_text(yaml.safe_dump(
        {"path": str(root), "voxel_size": 0.4, "ground_truth": str(root / "ground_truth.csv")}))


@pytest.mark.parametrize("transformation", [True, False])
def test_downsample_matches_jax(tmp_path, monkeypatch, capsys, transformation):
    """The same row counts and printed lines; rows in the same (z-major)
    order within atol 1e-5, lone voxels' rows equal."""
    flags = [] if transformation else ["--without-transformation"]
    jroot, troot, outs = _run_both(tmp_path, monkeypatch, capsys, _downsample_set, lambda r: [
        ["downsample", r / "ds.yaml", *flags]])
    assert outs[0] == outs[1] and len(outs[1]) == 2
    gt = tio.read_pose_table(str(troot / "ground_truth.csv"))
    n_lone = 0
    for f in ("scan0.ply", "scan1.ply"):
        got, _ = _xyz(troot / "downsampled_0.4" / f)
        want, _ = _xyz(jroot / "downsampled_0.4" / f)
        assert got.shape == want.shape and outs[1][int(f[4])] == f"{f}: 4000 -> {len(got)}"
        down = tds.voxel_downsample(ttypes.Cloud.from_numpy(_xyz(troot / f)[0]), 0.4)
        lone = (down.weight[down.valid] == 1.0).numpy()
        n_lone += int(lone.sum())
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got[lone], want[lone])
        rows = down.xyz[down.valid].numpy()
        if transformation:
            T = gt[f]
            rows = rows @ T[:3, :3].T + T[:3, 3]
        np.testing.assert_array_equal(got, rows.astype(np.float32))
    assert n_lone > 500


def test_downsample_and_overlap_need_a_card_unless_told(tmp_path, monkeypatch):
    """No CPU fallback: on the card by default, and without one they raise."""
    _downsample_set(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["downsample", str(tmp_path / "ds.yaml")], ["overlap", str(tmp_path / "ds.yaml")]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttool.main(argv)
    assert not (tmp_path / "overlapping.csv").exists()


def _nearest_f64(q: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Each query's nearest distance to the support rows, float64 brute force."""
    out = np.empty(len(q))
    s = s.astype(np.float64)
    for i in range(0, len(q), 512):
        d = q[i:i + 512, None, :].astype(np.float64) - s[None]
        out[i:i + 512] = np.sqrt((d * d).sum(-1)).min(1)
    return out


def _brute_overlap(clouds: list, r: float) -> np.ndarray:
    """The matrix of cmd_overlap in float64 brute force; asserts that no
    query's nearest distance lies within 1e-5 r of r, where the two
    packages' float32 distance arithmetic could decide a tie differently."""
    n = len(clouds)
    M = np.ones((n, n))
    for i in range(n):
        for j in range(i):
            fr = []
            for a, b in ((clouds[i], clouds[j]), (clouds[j], clouds[i])):
                d = _nearest_f64(a, b)
                assert np.all(np.abs(d - r) > 1e-5 * r)
                fr.append(float((d <= r).sum()) / float(len(a)))
            M[i, j] = M[j, i] = max(fr)
    return M


def _bucket_max(xyz: np.ndarray, cell: float) -> int:
    """The most points in one bucket of the JAX tool's hash grid over xyz
    (grid.build_grid's cell coordinates and hash)."""
    x = jnp.asarray(xyz)
    origin = jnp.min(x, axis=0) - 0.5 * cell
    c = [jgrid._cell_coords_1d(x[:, d], origin[d], 1.0 / cell) for d in range(3)]
    return int(np.bincount(np.asarray(jgrid._hash_cells(*c))).max())


def _read_matrix(path: Path):
    lines = path.read_text().splitlines()
    return lines[0].split(",")[1:], np.array([[float(v) for v in ln.split(",")[1:]]
                                              for ln in lines[1:]])


def _overlap_set(root: Path, clouds: dict, voxel: float):
    for name, xyz in clouds.items():
        tio.write_ply(str(root / name), xyz)
    (root / "overlap.yaml").write_text(yaml.safe_dump({"path": str(root), "voxel_size": voxel}))


def test_overlap_matches_jax_where_no_cell_is_capped(tmp_path, monkeypatch, capsys):
    """Three partly overlapping scans, no bucket of the JAX grid over 64
    points: the same matrix as the JAX tool and the brute force, the same
    CSV bytes and printed lines."""
    rng = np.random.default_rng(9)
    clouds = {"s0.ply": _scan(rng, 2500, hi=(16, 16, 2)),
              "s1.ply": _scan(rng, 2500, lo=(6, 0, 0), hi=(22, 16, 2)),
              "s2.ply": _scan(rng, 2000, lo=(0, 8, 0), hi=(16, 24, 2))}
    voxel = 0.5
    assert max(_bucket_max(x, 2 * voxel) for x in clouds.values()) <= 64
    want = _brute_overlap(list(clouds.values()), 2 * voxel)
    jroot, troot, outs = _run_both(tmp_path, monkeypatch, capsys,
                                   lambda r: _overlap_set(r, clouds, voxel),
                                   lambda r: [["overlap", r / "overlap.yaml"]])
    _same_files(jroot, troot)
    assert outs[0] == outs[1] and len(outs[1]) == 3
    names, got = _read_matrix(troot / "overlapping.csv")
    assert names == sorted(clouds)
    np.testing.assert_array_equal(got, want)
    assert 0.3 < got[0, 1] < 0.9 and 0.3 < got[0, 2] < 0.9


def test_overlap_is_exact_where_the_cap_binds(tmp_path, monkeypatch, capsys):
    """A dense blob of 600 points in one cell: its first 64 points (the ones
    the JAX grid keeps) sit on the side away from the query slab, the rest
    within the radius of it.  The port's matrix is the brute force; the JAX
    tool's reads lower."""
    rng = np.random.default_rng(10)
    yz = lambda n: rng.uniform(10.05, 10.45, size=(n, 2))  # noqa: E731
    near_side = np.column_stack([rng.uniform(10.40, 10.45, 536), yz(536)])
    far_side = np.column_stack([rng.uniform(10.05, 10.10, 64), yz(64)])
    sparse = np.column_stack([rng.uniform(30, 50, (2000, 2)), rng.uniform(10.05, 12.05, 2000)])
    b = np.concatenate([far_side, near_side, sparse]).astype(np.float32)
    a = np.column_stack([rng.uniform(11.2, 11.35, 60), yz(60)]).astype(np.float32)
    clouds = {"a.ply": a, "b.ply": b}
    voxel = 0.5
    assert _bucket_max(b, 2 * voxel) > 64 and _bucket_max(a, 2 * voxel) <= 64
    want = _brute_overlap([a, b], 2 * voxel)
    jroot, troot, outs = _run_both(tmp_path, monkeypatch, capsys,
                                   lambda r: _overlap_set(r, clouds, voxel),
                                   lambda r: [["overlap", r / "overlap.yaml"]])
    _names, got = _read_matrix(troot / "overlapping.csv")
    _names, jax_got = _read_matrix(jroot / "overlapping.csv")
    np.testing.assert_array_equal(got, want)
    assert got[0, 1] == 1.0  # every slab point has a blob point within r
    assert jax_got[0, 1] < got[0, 1]  # the JAX grid kept only the far side
    assert outs[1] == ["b.ply <-> a.ply: 1.000"]

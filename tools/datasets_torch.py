"""Offline dataset tooling on the PyTorch port (tools/datasets.py, ported;
reference: process_datasets.py).

Commands: stanford / eth_gt converters, perturb (random-rotation injection
with GT update), transform (local<->global frames), downsample, overlap
matrix, eth (CSV clouds) and las.  The same arguments and output files as
tools/datasets.py, built on the port's PLY IO
(lidar_global_registration_tpu_torch.utils.io) and device ops; the host
commands keep that tool's NumPy arithmetic, so their files are the same
bytes.

downsample runs the port's weighted voxel grid (ops/downsample.
voxel_downsample) on the device.  overlap takes, for each ordered pair,
the share of a cloud's points that have a point of the other within
2 * voxel_size, with the exact nearest-point query (ops/grid.
nearest_within: passes at r / 8 ... r over cell plans, no cap).  The
JAX tool's hash grid keeps at most 64 points a cell, so its matrix equals
this one wherever no cell of the support cloud holds more, and reads lower
where one does; this one is the true share.

    python tools/datasets_torch.py <command> ...

runs on the CUDA card (no card: downsample and overlap raise); from Python,
main(argv, device="cpu") runs them on the CPU.
"""
from __future__ import annotations

import argparse
import functools
import os
import sys

import numpy as np
import yaml

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lidar_global_registration_tpu_torch.utils import io as iomod  # noqa: E402

GT_COLUMNS = ["reading"] + [f"gT{i}{j}" for i in range(4) for j in range(4)]


def _write_gt(path: str, rows: list[tuple[str, np.ndarray]]):
    with open(path, "w") as f:
        f.write(",".join(GT_COLUMNS) + "\n")
        for name, T in rows:
            f.write(name + "," + ",".join(f"{v:g}" for v in np.asarray(T).reshape(-1)) + "\n")


def _read_gt(path: str) -> dict:
    return iomod.read_pose_table(path)


def _read_config(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


def _quat_to_matrix(q):
    """Quaternion (x, y, z, w) -> rotation matrix (scipy convention used by
    the Stanford .conf files)."""
    x, y, z, w = q
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _xyz(fields) -> np.ndarray:
    return np.stack([fields["x"], fields["y"], fields["z"]], axis=1)


def _normals(fields) -> np.ndarray:
    return np.stack([fields["normal_x"], fields["normal_y"], fields["normal_z"]], axis=1)


def cmd_stanford(args):
    """Stanford .conf (quat poses) -> ground_truth.csv + copied clouds
    (process_datasets.py stanford_to_common)."""
    confs = sorted(f for f in os.listdir(args.input_dir) if f.endswith(".conf"))
    if not confs:
        print(f"No .conf file was found in {args.input_dir}")
        return
    out = args.output_dir or confs[0][: confs[0].rfind(".")]
    os.makedirs(out, exist_ok=True)
    rows = []
    for conf in confs:
        with open(os.path.join(args.input_dir, conf)) as f:
            for line in f:
                tok = line.split()
                if len(tok) < 2 or not tok[1].endswith(".ply"):
                    continue
                t = np.array(list(map(float, tok[2:5])))
                q = list(map(float, tok[5:9]))
                T = np.eye(4)
                T[:3, :3] = np.linalg.inv(_quat_to_matrix(q))
                T[:3, 3] = t
                rows.append((tok[1], T))
    for name, _ in rows:
        fields, names = iomod.read_ply(os.path.join(args.input_dir, name))
        xyz = _xyz(fields)
        finite = np.isfinite(xyz).all(axis=1)
        normal = _normals(fields)[finite] if iomod.cloud_has_normals(names) else None
        iomod.write_ply(os.path.join(out, name), xyz[finite], normal=normal)
    _write_gt(os.path.join(out, "ground_truth.csv"), rows)
    print(f"wrote {len(rows)} clouds + ground_truth.csv to {out}")


def cmd_eth_gt(args):
    """ETH groundtruth .tfm files -> ground_truth.csv
    (process_datasets.py parse_gt_eth)."""
    path = args.path
    names = sorted(f[: f.find(".")] for f in os.listdir(path) if f.endswith(".ply"))
    with open(os.path.join(path, "ground_truth.csv"), "w") as f:
        f.write(",".join(GT_COLUMNS) + "\n")
        f.write(names[0] + ".ply," + ",".join(map(str, np.eye(4).reshape(-1))) + "\n")
        for name in names[1:]:
            tfm = os.path.join(path, "groundtruth", f"{name}-{names[0]}.tfm")
            vals = []
            with open(tfm) as tf:
                for line in tf:
                    vals += line.split()
            f.write(name + ".ply," + ",".join(vals) + "\n")
    print("wrote ground_truth.csv")


def _transform_ply(load_from, save_to, T):
    """The cloud under T: float64 rows, written as float32 (normals rotated)."""
    fields, names = iomod.read_ply(load_from)
    xyz = _xyz(fields) @ T[:3, :3].T + T[:3, 3]
    normal = _normals(fields) @ T[:3, :3].T if iomod.cloud_has_normals(names) else None
    iomod.write_ply(save_to, xyz.astype(np.float32), normal=normal)


def cmd_perturb(args):
    """Inject a random rotation (optionally translation) into one scan and
    update its GT row — the reference's fault-injection analogue
    (process_datasets.py:213-238)."""
    config = _read_config(args.config)
    rng = np.random.default_rng(args.seed)
    if args.with_rotation:
        ang = np.deg2rad(180.0 * rng.random())
        c, s = np.cos(ang), np.sin(ang)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    else:
        R = np.eye(3)
    t = rng.random(3) * 10 if args.with_translation else np.zeros(3)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    src = config["transform"]
    suffix = ("_r" if args.with_rotation else "") + ("_t" if args.with_translation else "")
    out_name = os.path.basename(src)[:-4] + f"_transformed{suffix}.ply"
    out_path = os.path.join(os.path.dirname(src), out_name)
    _transform_ply(src, out_path, T)
    gt = _read_gt(config["ground_truth"])
    gt.pop(out_name, None)
    base = gt[os.path.basename(src)]
    gt[out_name] = base @ np.linalg.inv(T)
    _write_gt(config["ground_truth"], list(gt.items()))
    print(f"wrote {out_path} and updated GT")


def cmd_transform(args):
    """Move a dataset between local and global frames
    (process_datasets.py transform)."""
    config = _read_config(args.config)
    dirpath = os.path.dirname(args.config)
    dataset = os.path.basename(args.config)[:-5]
    files = sorted(f for f in os.listdir(dirpath) if f.endswith(".ply") and f.startswith(dataset))
    gt = _read_gt(config["ground_truth"])
    for f in files:
        T = gt[f] if args.current == "local" else np.linalg.inv(gt[f])
        p = os.path.join(dirpath, f)
        _transform_ply(p, p, T)
        print(f"transformed {f}")


def cmd_downsample(args, device="cuda"):
    """Voxel-downsample every cloud of a dataset (process_datasets.py
    downsample) with the port's weighted voxel grid on `device`; the ground
    truth moves the valid rows on the host, in float32 NumPy as the JAX tool
    does."""
    from lidar_global_registration_tpu_torch.models.pipeline import resolve_device
    from lidar_global_registration_tpu_torch.ops.downsample import voxel_downsample
    from lidar_global_registration_tpu_torch.types import Cloud

    dev = resolve_device(device)
    config = _read_config(args.config)
    voxel = float(config["voxel_size"])
    files = sorted(f for f in os.listdir(config["path"]) if f.endswith(".ply"))
    gt = _read_gt(config["ground_truth"]) if args.with_transformation else {}
    out_dir = os.path.join(config["path"], f"downsampled_{voxel}")
    os.makedirs(out_dir, exist_ok=True)
    for f in files:
        fields, _names = iomod.read_ply(os.path.join(config["path"], f))
        xyz = _xyz(fields)
        down = voxel_downsample(Cloud.from_numpy(xyz, device=dev), voxel)
        v = down.valid.cpu().numpy()
        dxyz = down.xyz.cpu().numpy()[v]
        if f in gt:
            T = gt[f]
            dxyz = dxyz @ T[:3, :3].T + T[:3, 3]
        iomod.write_ply(os.path.join(out_dir, f), dxyz.astype(np.float32))
        print(f"{f}: {len(xyz)} -> {v.sum()}")


def cmd_eth(args):
    """ETH CSV clouds -> PLY + rewritten ground truth
    (process_datasets.py:122-142 eth_to_common).  The input dir holds a
    ground truth CSV whose first column (`reading`) names per-scan CSV
    clouds with x,y,z columns."""
    import csv

    gt_path = os.path.join(args.input_dir, "ground_truth.csv")
    if not os.path.exists(gt_path):
        cands = [f for f in os.listdir(args.input_dir) if f.endswith("global.csv")]
        if cands:
            gt_path = os.path.join(args.input_dir, cands[0])
    with open(gt_path) as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    out = args.output_dir or os.path.basename(os.path.normpath(args.input_dir))
    os.makedirs(out, exist_ok=True)
    for row in body:
        filename = row[0]
        data = np.genfromtxt(os.path.join(args.input_dir, filename), delimiter=",", names=True)
        xyz = _xyz(data).astype(np.float32)
        xyz = xyz[np.isfinite(xyz).all(axis=1)]
        base = filename[: filename.rfind(".")] if "." in filename else filename
        iomod.write_ply(os.path.join(out, base + ".ply"), xyz)
        row[0] = base + ".ply"
    with open(os.path.join(out, "ground_truth.csv"), "w") as f:
        f.write(",".join(header) + "\n")
        for row in body:
            f.write(",".join(row) + "\n")
    print(f"wrote {len(body)} clouds + ground_truth.csv to {out}")


def read_las(path: str):
    """Minimal native LAS 1.2-1.4 point reader (XYZ + intensity).

    The reference converts .las scans with PyntCloud
    (process_datasets.py:191-198); this is a dependency-free equivalent:
    parse the public header block, then bulk-decode the point records'
    leading i32 XYZ triple (all point formats 0-10) and u16 intensity,
    applying the header scale/offset.  Returns (xyz f64[N,3], intensity
    u16[N])."""
    import struct

    with open(path, "rb") as f:
        header = f.read(375)
        if header[:4] != b"LASF":
            raise ValueError(f"{path}: not a LAS file")
        ver_major, ver_minor = header[24], header[25]
        (point_offset,) = struct.unpack_from("<I", header, 96)
        if header[104] & 0xC0:  # the high bits of the point format flag LAZ
            raise ValueError(f"{path}: LAZ-compressed LAS is not supported")
        (record_len,) = struct.unpack_from("<H", header, 105)
        (n_points,) = struct.unpack_from("<I", header, 107)
        scale = struct.unpack_from("<3d", header, 131)
        offset = struct.unpack_from("<3d", header, 155)
        if n_points == 0 and (ver_major, ver_minor) >= (1, 4):
            (n_points,) = struct.unpack_from("<Q", header, 247)
        f.seek(point_offset)
        raw = np.frombuffer(f.read(n_points * record_len), dtype=np.uint8).reshape(
            n_points, record_len)
    # every point format (0-10) starts with the i32 XYZ triple and a u16 intensity
    xyz_raw = raw[:, :12].copy().view("<i4").reshape(n_points, 3)
    xyz = xyz_raw.astype(np.float64) * np.asarray(scale) + np.asarray(offset)
    intensity = raw[:, 12:14].copy().view("<u2").reshape(n_points)
    return xyz, intensity


def cmd_las(args):
    """Convert every .las in a directory to .ply next to it
    (process_datasets.py:191-198)."""
    n = 0
    for filename in sorted(os.listdir(args.las_path)):
        if not filename.endswith(".las"):
            continue
        xyz, _intensity = read_las(os.path.join(args.las_path, filename))
        out = os.path.join(args.las_path, filename[: -len(".las")] + ".ply")
        iomod.write_ply(out, xyz.astype(np.float32))
        print(f"{filename} -> {os.path.basename(out)} ({len(xyz)} points)")
        n += 1
    if n == 0:
        print(f"no .las files in {args.las_path}")


def cmd_overlap(args, device="cuda"):
    """Pairwise overlap matrix (process_datasets.py overlap): the share of
    points whose nearest point in the other cloud is within 2 * voxel_size,
    the larger of the two directions, exact on `device` (module docstring).
    On the card the cache is emptied after each pair and the peak device
    memory printed last."""
    import torch

    from lidar_global_registration_tpu_torch.models.pipeline import resolve_device
    from lidar_global_registration_tpu_torch.ops.grid import nearest_within
    from lidar_global_registration_tpu_torch.types import Cloud

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    config = _read_config(args.config)
    dirpath = config["path"]
    radius = 2.0 * float(config["voxel_size"])
    files = sorted(f for f in os.listdir(dirpath) if f.endswith(".ply"))
    clouds = []
    for f in files:
        fields, _ = iomod.read_ply(os.path.join(dirpath, f))
        clouds.append(Cloud.from_numpy(_xyz(fields), device=dev))

    def frac_within(a: Cloud, b: Cloud):
        _i, _d, found = nearest_within(b.xyz, b.valid, a.xyz, a.valid, radius)
        return float(found.sum()) / float(a.count())

    n = len(files)
    M = np.ones((n, n))
    for i in range(n):
        for j in range(i):
            ov = max(frac_within(clouds[i], clouds[j]), frac_within(clouds[j], clouds[i]))
            M[i, j] = M[j, i] = ov
            print(f"{files[i]} <-> {files[j]}: {ov:.3f}")
            if on_card:
                torch.cuda.empty_cache()
    with open(os.path.join(dirpath, "overlapping.csv"), "w") as f:
        f.write("reading," + ",".join(files) + "\n")
        for i in range(n):
            f.write(files[i] + "," + ",".join(f"{v:g}" for v in M[i]) + "\n")
    if on_card:
        print(f"# device: peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB")


def main(argv=None, device="cuda"):
    """`python tools/datasets_torch.py <command> ...`; `device` is for the
    tests (the command line always runs downsample and overlap on the card)."""
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("stanford")
    s.add_argument("input_dir")
    s.add_argument("-o", "--output-dir")
    s.set_defaults(fn=cmd_stanford)

    s = sub.add_parser("eth_gt")
    s.add_argument("path")
    s.set_defaults(fn=cmd_eth_gt)

    s = sub.add_parser("perturb")
    s.add_argument("config")
    s.add_argument("--with-translation", action="store_true")
    s.add_argument("--without-rotation", dest="with_rotation", action="store_false")
    s.add_argument("--seed", type=int, default=None)
    s.set_defaults(fn=cmd_perturb, with_rotation=True)

    s = sub.add_parser("transform")
    s.add_argument("config")
    s.add_argument("--current", choices=["local", "global"], default="global")
    s.set_defaults(fn=cmd_transform)

    s = sub.add_parser("downsample")
    s.add_argument("config")
    s.add_argument("--without-transformation", dest="with_transformation",
                   action="store_false")
    s.set_defaults(fn=functools.partial(cmd_downsample, device=device), with_transformation=True)

    s = sub.add_parser("eth")
    s.add_argument("input_dir")
    s.add_argument("-o", "--output-dir")
    s.set_defaults(fn=cmd_eth)

    s = sub.add_parser("las")
    s.add_argument("las_path")
    s.set_defaults(fn=cmd_las)

    s = sub.add_parser("overlap")
    s.add_argument("config")
    s.set_defaults(fn=functools.partial(cmd_overlap, device=device))

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

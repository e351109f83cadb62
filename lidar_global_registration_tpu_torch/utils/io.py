"""IO: PLY clouds, ground-truth / viewpoint / transformation CSVs,
correspondence caches (lidar_global_registration_tpu/utils/io.py, copied:
pure host code).

Reference: include/io.h (PLY with the raw field list so callers can tell
whether normals came with the file), common.cpp:83-200 (pose CSVs),
common.cpp:1223-1266 (correspondence CSV cache).

The PLY reader and writer are NumPy only (the JAX package's read_ply_numpy
and its NumPy writer): binary little- and big-endian and ascii, any extra
properties.  The JAX package's ctypes module (utils/native.py) has no
counterpart here; exact duplicates are removed on the device
(ops/downsample.dedup_points).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

_PLY_TYPES = {
    "char": "i1",
    "int8": "i1",
    "uchar": "u1",
    "uint8": "u1",
    "short": "i2",
    "int16": "i2",
    "ushort": "u2",
    "uint16": "u2",
    "int": "i4",
    "int32": "i4",
    "uint": "u4",
    "uint32": "u4",
    "float": "f4",
    "float32": "f4",
    "double": "f8",
    "float64": "f8",
}


def read_ply(path: str):
    """Read a PLY vertex cloud: one np.frombuffer over a binary vertex block.

    Returns (fields: dict[name -> np.ndarray], field_names: list[str]).
    Matches loadPLYFile keeping the field list (io.h:6-20)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_vertex = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        elements: list[tuple[str, int]] = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated header")
            tok = line.decode("ascii", "replace").strip().split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                in_vertex = tok[1] == "vertex"
                elements.append((tok[1], int(tok[2])))
                if in_vertex:
                    n_vertex = int(tok[2])
            elif tok[0] == "property" and in_vertex:
                if tok[1] == "list":
                    raise ValueError("list property on vertex element unsupported")
                props.append((tok[2], _PLY_TYPES[tok[1]]))
            elif tok[0] == "end_header":
                break
        if elements and elements[0][0] != "vertex":
            raise ValueError("vertex must be the first element")
        names = [n for n, _ in props]
        if fmt == "ascii":
            rows = []
            for _ in range(n_vertex):
                rows.append(f.readline().split())
            arr = np.array(rows, dtype=np.float64)
            fields = {
                n: arr[:, i].astype(np.dtype(t)) for i, (n, t) in enumerate(props)
            }
        elif fmt in ("binary_little_endian", "binary_big_endian"):
            end = "<" if fmt == "binary_little_endian" else ">"
            dt = np.dtype([(n, end + t) for n, t in props])
            raw = f.read(dt.itemsize * n_vertex)
            arr = np.frombuffer(raw, dtype=dt, count=n_vertex)
            fields = {n: np.ascontiguousarray(arr[n]) for n in names}
        else:
            raise ValueError(f"unknown PLY format {fmt}")
    return fields, names


def write_ply(
    path: str,
    xyz: np.ndarray,
    normal: Optional[np.ndarray] = None,
    color: Optional[np.ndarray] = None,
    intensity: Optional[np.ndarray] = None,
    curvature: Optional[np.ndarray] = None,
    binary: bool = True,
    faces: Optional[np.ndarray] = None,
):
    """Write a vertex cloud (+ optional triangle faces, used by the debug
    correspondence-edge artifacts, common.cpp:965-1017)."""
    n = len(xyz)
    cols: list[tuple[str, np.ndarray, str]] = [
        ("x", xyz[:, 0], "float"),
        ("y", xyz[:, 1], "float"),
        ("z", xyz[:, 2], "float"),
    ]
    if color is not None:
        for i, c in enumerate("red green blue".split()):
            cols.append((c, color[:, i].astype(np.uint8), "uchar"))
    if intensity is not None:
        cols.append(("intensity", intensity, "float"))
    if normal is not None:
        for i, c in enumerate(["normal_x", "normal_y", "normal_z"]):
            cols.append((c, normal[:, i], "float"))
    if curvature is not None:
        cols.append(("curvature", curvature, "float"))

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        hdr = ["ply"]
        hdr.append(
            "format binary_little_endian 1.0" if binary else "format ascii 1.0"
        )
        hdr.append(f"element vertex {n}")
        for name, _, t in cols:
            hdr.append(f"property {t} {name}")
        if faces is not None:
            hdr.append(f"element face {len(faces)}")
            hdr.append("property list uchar int vertex_indices")
        hdr.append("end_header")
        f.write(("\n".join(hdr) + "\n").encode())
        if binary:
            dt = np.dtype(
                [(name, "<u1" if t == "uchar" else "<f4") for name, _, t in cols]
            )
            rec = np.zeros(n, dtype=dt)
            for name, arr, _ in cols:
                rec[name] = arr
            f.write(rec.tobytes())
            if faces is not None:
                fdt = np.dtype([("n", "u1"), ("a", "<i4"), ("b", "<i4"), ("c", "<i4")])
                frec = np.zeros(len(faces), dtype=fdt)
                frec["n"] = 3
                frec["a"], frec["b"], frec["c"] = faces[:, 0], faces[:, 1], faces[:, 2]
                f.write(frec.tobytes())
        else:
            data = np.stack([c[1].astype(np.float64) for c in cols], axis=1)
            for row in data:
                f.write((" ".join(f"{v:g}" for v in row) + "\n").encode())
            if faces is not None:
                for a, b, c in faces:
                    f.write(f"3 {a} {b} {c}\n".encode())


def cloud_has_normals(field_names) -> bool:
    """pointCloudHasNormals (common.h:465-480)."""
    return "normal_x" in field_names and "normal_y" in field_names and (
        "normal_z" in field_names
    )


# ---------------------------------------------------------------------------
# Pose / viewpoint CSVs (common.cpp:83-153, 482-507)
# ---------------------------------------------------------------------------
def read_pose_table(csv_path: str) -> dict:
    """reading -> 4x4 matrix rows (header tolerated)."""
    out = {}
    with open(csv_path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 17:
                continue
            try:
                mat = np.array([float(x) for x in parts[1:17]], np.float32).reshape(4, 4)
            except ValueError:
                continue  # header
            out[parts[0]] = mat
    return out


def get_transformation_gt(csv_path: str, src_filename: str, tgt_filename: str):
    """GT = inv(tgt_pose) @ src_pose (common.cpp:83-106)."""
    table = read_pose_table(csv_path)
    if src_filename not in table or tgt_filename not in table:
        return None
    return np.linalg.inv(table[tgt_filename]) @ table[src_filename]


def get_transformation(csv_path: str, name: str) -> np.ndarray:
    table = read_pose_table(csv_path)
    if name not in table:
        raise KeyError(f"Failed to get transformation {name} from {csv_path}")
    return table[name]


def save_transformation(csv_path: str, name: str, transformation: np.ndarray):
    exists = os.path.exists(csv_path)
    os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
    with open(csv_path, "a") as f:
        if not exists:
            f.write(
                "reading,gT00,gT01,gT02,gT03,gT10,gT11,gT12,gT13,"
                "gT20,gT21,gT22,gT23,gT30,gT31,gT32,gT33\n"
            )
        vals = ",".join(f"{v:g}" for v in np.asarray(transformation).reshape(-1))
        f.write(f"{name},{vals}\n")


def load_viewpoint(viewpoints_path: Optional[str], pcd_path: str):
    """Viewpoint lookup per scan filename (common.cpp:482-507)."""
    if not viewpoints_path:
        return None
    fname = os.path.basename(pcd_path)
    with open(viewpoints_path) as f:
        for line in f:
            parts = line.strip().split(",")
            if parts and parts[0] == fname and len(parts) >= 4:
                try:
                    return np.array([float(x) for x in parts[1:4]], np.float32)
                except ValueError:
                    continue
    return None


# ---------------------------------------------------------------------------
# Correspondence CSV cache (common.cpp:1223-1266)
# ---------------------------------------------------------------------------
def save_correspondences_csv(filepath, src_xyz, tgt_xyz, corrs):
    d = corrs.to_numpy()
    os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
    with open(filepath, "w") as f:
        f.write("query_idx,match_idx,distance,threshold,x_s,y_s,z_s,x_t,y_t,z_t\n")
        for qi, mi, dist, thr in zip(d["query"], d["match"], d["distance"], d["threshold"]):
            s = src_xyz[qi]
            t = tgt_xyz[mi]
            f.write(
                f"{qi},{mi},{dist:g},{thr:g},{s[0]:g},{s[1]:g},{s[2]:g},"
                f"{t[0]:g},{t[1]:g},{t[2]:g}\n"
            )


def read_correspondences_csv(filepath):
    """Returns (query, match, distance, threshold) numpy arrays or None."""
    if not os.path.exists(filepath):
        return None
    q, m, d, t = [], [], [], []
    with open(filepath) as f:
        next(f, None)  # header
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 4:
                continue
            q.append(int(parts[0]))
            m.append(int(parts[1]))
            d.append(float(parts[2]))
            t.append(float(parts[3]))
    return (
        np.array(q, np.int32),
        np.array(m, np.int32),
        np.array(d, np.float32),
        np.array(t, np.float32),
    )


# ---------------------------------------------------------------------------
# Iterations info CSV (common.cpp:155-200)
# ---------------------------------------------------------------------------
def save_iterations_info(csv_path: str, name: str, voxel_sizes, matching_ids):
    os.makedirs(os.path.dirname(csv_path) or ".", exist_ok=True)
    with open(csv_path, "a") as f:
        row = [name, str(len(voxel_sizes))]
        for v, m in zip(voxel_sizes, matching_ids):
            row += [f"{v:g}", m]
        f.write(",".join(row) + "\n")


def get_iterations_info(csv_path: str, name: str):
    with open(csv_path) as f:
        for line in f:
            parts = line.strip().split(",")
            if parts and parts[0] == name:
                n = int(parts[1])
                voxels = [float(parts[2 + 2 * i]) for i in range(n)]
                ids = [parts[3 + 2 * i] for i in range(n)]
                return voxels, ids
    raise KeyError(f"Failed to get iterations for test {name}")

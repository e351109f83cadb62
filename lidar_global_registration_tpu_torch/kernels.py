"""Build and bind the hand-written CUDA kernels of `csrc/`.

All `csrc/*.cu` files compile with nvcc (one process per source, in
parallel) into ONE shared library with a plain C interface, loaded with
ctypes (no PyTorch headers, so the build takes seconds).  The library is
built at first use into `_build/`, under a name that carries the hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is loaded as it is.

Every C entry point takes device pointers and the stream as `void*`, ints
and floats by value, launches on that stream without synchronising, and
returns `cudaGetLastError()`; `launch` raises when that is not 0.  Nothing
here falls back to anything: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from lidar_global_registration_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no FMA contraction: the radius tests and pair features then round
    # exactly like the plain PyTorch versions they are checked against
    "-fmad=false",
    "-Xcompiler", "-fPIC",
)

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
_L = ctypes.c_longlong
# C signatures (all return int = cudaError_t)
SIGNATURES = {
    # pts, cell_of, cols, oid, slots (or 0), m, r2, out8, nn_d, nn_id, stream
    "lgr_surface": (_P, _P, _P, _P, _P, _I, _F, _P, _P, _P, _P),
    # pts, cell_of, cols, n, r2, count, inv, stream
    "lgr_iss_count": (_P, _P, _P, _I, _F, _P, _P, _P),
    # pts, cell_of, cols, inv, n, r2, gamma21, gamma32, sal, ok, nnb, stream
    "lgr_iss_saliency": (_P, _P, _P, _P, _I, _F, _F, _F, _P, _P, _P, _P),
    # pts, cell_of, cols, sal, ok, n, r2, min_nb, origin, cell, kp, stream
    "lgr_iss_nms": (_P, _P, _P, _P, _P, _I, _F, _I, _P, _D, _P, _P),
    # the slot-list forms: the same with slots (i32[m]) and m in place of n
    "lgr_iss_count_at": (_P, _P, _P, _P, _I, _F, _P, _P, _P),
    "lgr_iss_saliency_at": (_P, _P, _P, _P, _P, _I, _F, _F, _F, _P, _P, _P, _P),
    "lgr_iss_nms_at": (_P, _P, _P, _P, _P, _P, _I, _F, _I, _P, _D, _P, _P),
    # ctr, nrm, cell_of, cols, slots (or 0), items, n_items, r2, spfh, cnt,
    # stream
    "lgr_spfh": (_P, _P, _P, _P, _P, _P, _I, _F, _P, _P, _P),
    # pts, cell_of, cols, spfh, slots (or 0), rows (or 0), m, r2, per_thread,
    # feat, kcnt, stream
    "lgr_combine": (_P, _P, _P, _P, _P, _P, _I, _F, _I, _P, _P, _P),
    # qt, tt, qn, tn, nq, nq_pad, nt_pad, d, tiles_per, splits, part_d2,
    # part_i, best_d2, best_i, stream
    "lgr_nn_l2": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P),
    # d, blocks_per_sm (int*)
    "lgr_nn_l2_blocks_per_sm": (_I, _P),
    # q, qv, nq, t (or 0: the same set), tv, nt, part, qkey, tkey, stream
    "lgr_knn_xyz_keys": (_P, _P, _I, _P, _P, _I, _P, _P, _P, _P),
    # q, perm_q, qkey_s, nq, t, tv, perm_t, tkey_s, nt, nt_pad, exclude_ids
    # (or 0), id_offset, diag, k, t4, tid, box, home, nt_valid, best_d,
    # best_i, stream
    "lgr_knn_xyz": (_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _L, _I, _I, _P, _P, _P, _P, _P,
                    _P, _P, _P),
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put the CUDA toolkit on PATH or set CUDA_HOME")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"liblgr_kernels_{h.hexdigest()[:16]}.so"


def build(out: Path, verbose: bool = False) -> tuple[float, str]:
    """Compile every csrc/*.cu into `out`: one nvcc per source, all started
    together, then one link.  Returns (wall seconds of the build, nvcc's
    output); verbose adds ptxas's per-kernel register and spill report."""
    cu, _ = _sources()
    out.parent.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        objs = [os.path.join(tmpdir, f.stem + ".o") for f in cu]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *extra, "-c", "-o", o, str(f)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for f, o in zip(cu, objs)]
        logs, failed = [], []
        for f, proc in zip(cu, procs):
            log, _ = proc.communicate()
            logs.append(log)
            if proc.returncode != 0:
                failed.append(f"{f.name} ({proc.returncode}):\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = os.path.join(tmpdir, out.name)
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return time.perf_counter() - t0, "".join(logs) + proc.stdout + proc.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed (the
    span lgr.setup.kernel_library, once a process)."""
    global _lib
    if _lib is None:
        with profiling.span("lgr.setup.kernel_library"):
            path = library_path()
            if not path.exists():
                build(path)
            lib = ctypes.CDLL(str(path))
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            lib.lgr_error_string.argtypes = [ctypes.c_int]
            lib.lgr_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call one C entry point and raise if its launch failed."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.lgr_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def check(t: torch.Tensor, dtype: torch.dtype, shape: tuple, name: str) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and `shape`
    (None in `shape` matches any size)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")

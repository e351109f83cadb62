"""Tracing / profiling utilities (lidar_global_registration_tpu/utils/profiling.py).

Reference (SURVEY.md section 5): wall-clock pcl::ScopeTime blocks around
alignment, correspondence search, keypoints, RANSAC, GROR, analysis; the
timings flow into the results CSV as time_cs / time_te.

`scope_time` is the host wall clock around a block; `maybe_torch_profile`
wraps a region in a torch.profiler trace when LGR_PROFILE=<dir> is set (the
CLI wraps its whole run) and writes a Chrome trace into that directory
(chrome://tracing, Perfetto).
"""
from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def scope_time(label: str, sink: dict | None = None, key: str | None = None,
               verbose: bool = True):
    """pcl::ScopeTime equivalent: prints '[<label>] took NNNms.'"""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if verbose:
            print(f"[{label}] took {1000.0 * dt:.1f}ms.")
        if sink is not None and key is not None:
            sink[key] = sink.get(key, 0.0) + dt


@contextlib.contextmanager
def maybe_torch_profile(cuda: bool = True):
    """Trace the region with torch.profiler (CPU activity, and CUDA activity
    when `cuda`) when LGR_PROFILE=<dir> is set, then write the Chrome trace
    <dir>/trace_<pid>.json and print its path; otherwise do nothing."""
    trace_dir = os.environ.get("LGR_PROFILE")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    print(f"[profiler] trace written to {path}", flush=True)

"""Tracing / profiling utilities (lidar_global_registration_tpu/utils/profiling.py).

Reference (SURVEY.md section 5): wall-clock pcl::ScopeTime blocks around
alignment, correspondence search, keypoints, RANSAC, GROR, analysis; the
timings flow into the results CSV as time_cs / time_te.

The tracer: `span(name)` marks a block of the program, named
`lgr.<layer>` or `lgr.<layer>.<part>` (the layers: pre_downsample,
keypoints, descriptors, match, solver; `lgr.pair` is one whole
register_pair_staged call, `lgr.setup.*` the one-off work before the
pairs).  Off by default: a span is then a shared no-op, one flag test, no
clock and no synchronise.  After `enable()` a span enters
torch.profiler.record_function, so a recording profiler places it on the
device trace's clock beside the kernels it launched, and adds its host
seconds and one call to a sum under its name.  `count(name, n)` adds to an
integer sum whether or not the tracer is on (an add, like the kernel
wrappers' `.launches`).  `snapshot()` reads both kinds of sum and
`reset()` clears them.  The profiler's Chrome trace is the only record of
single spans.

`maybe_torch_profile` wraps a region in a torch.profiler trace, with the
tracer on, when LGR_PROFILE=<dir> is set (the CLI wraps its whole run) and
writes a Chrome trace into that directory (chrome://tracing, Perfetto).
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

_on = False
_NOOP = contextlib.nullcontext()
_span_s: dict = {}  # span name -> host seconds
_span_calls: dict = {}  # span name -> calls
_counts: dict = {}  # counter name -> integer sum


def enable() -> None:
    """Turn the spans on."""
    global _on
    _on = True


def disable() -> None:
    """Turn the spans off (the sums are kept)."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


class _Span:
    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._rf.__exit__(*exc)
        _span_s[self.name] = _span_s.get(self.name, 0.0) + dt
        _span_calls[self.name] = _span_calls.get(self.name, 0) + 1
        return False


def span(name: str):
    """A context manager over one block named `name`: the shared no-op
    while the tracer is off, else a record_function annotation whose host
    seconds and call are summed under `name`."""
    if not _on:
        return _NOOP
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add n to the integer sum `name`."""
    _counts[name] = _counts.get(name, 0) + n


def snapshot() -> dict:
    """{"spans": {name: {"seconds", "calls"}}, "counts": {name: n}}: copies
    of the sums since the last reset()."""
    return {"spans": {k: {"seconds": _span_s[k], "calls": _span_calls[k]} for k in _span_s},
            "counts": dict(_counts)}


def reset() -> None:
    """Clear every span sum and counter."""
    _span_s.clear()
    _span_calls.clear()
    _counts.clear()


@contextlib.contextmanager
def maybe_torch_profile(cuda: bool = True):
    """Trace the region with torch.profiler (CPU activity, and CUDA activity
    when `cuda`) when LGR_PROFILE=<dir> is set, the tracer on so that the
    trace carries the program's spans, then write the Chrome trace
    <dir>/trace_<pid>.json and print its path; otherwise do nothing."""
    trace_dir = os.environ.get("LGR_PROFILE")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    was_on = _on
    enable()
    try:
        with profile(activities=activities) as prof:
            yield
    finally:
        if not was_on:
            disable()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    print(f"[profiler] trace written to {path}", flush=True)

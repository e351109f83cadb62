"""The traced run's readings: torch.profiler over a fixed count of pairs,
reduced to the device's busy time, its operations by name, its idle gaps
by what the host was doing, and the program's own kernels told apart from
the libraries' by the names of csrc/*.cu's `__global__` functions."""
from __future__ import annotations

import bisect
import json
import re
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

WINDOW = "bench.profiled"  # the annotation around the profiled pairs
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


@dataclass
class Readings:
    """What the per-layer readers read (benchmark/metrics/*.py)."""
    profiled_pairs: int = 0
    window_s: float = 0.0  # the profiled stretch, from its annotation
    busy_s: float = 0.0  # union of device operations inside it
    device_ops: dict = field(default_factory=dict)  # name -> seconds
    handwritten: set = field(default_factory=set)  # the program's kernel names
    idle_gaps: dict = field(default_factory=dict)  # host label -> seconds
    stage_pairs: int = 0  # pairs timed stage by stage after the profiled ones
    stage_s: dict = field(default_factory=dict)  # stage label -> seconds
    pre_downsample_s: float = 0.0
    pair_s: list = field(default_factory=list)  # seconds of each stage-timed pair

    def stage_ms(self, pick):
        """Milliseconds a pair of the stage labels `pick` selects, or None
        where no such label was timed."""
        labels = [k for k in self.stage_s if pick(k)]
        if not self.stage_pairs or not labels:
            return None
        return 1e3 * sum(self.stage_s[k] for k in labels) / self.stage_pairs

    def is_handwritten(self, name: str) -> bool:
        return kernel_of(name, self.handwritten) is not None


def handwritten_kernels(csrc: Path) -> set:
    """The `__global__` function names of the program's CUDA sources."""
    names = set()
    for f in sorted(csrc.glob("*.cu")):
        text = re.sub(r"__launch_bounds__\s*\([^)]*\)", " ", f.read_text())
        names.update(re.findall(r"__global__\s+void\s+(\w+)\s*[(<]", text))
    return names


def kernel_of(name: str, names: set):
    """The handwritten kernel a trace name belongs to, or None."""
    for k in names:
        if re.search(rf"(?<!\w){re.escape(k)}(?!\w)", name):
            return k
    return None


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _host_label(starts, events, t: float, max_scan: int = 4000) -> str:
    """The innermost host op or annotation running at time t."""
    i = bisect.bisect_right(starts, t) - 1
    for k in range(i, max(i - max_scan, -1), -1):
        e = events[k]
        if e["ts"] + e["dur"] >= t and e["name"] != WINDOW:
            return e["name"]
    return "host (no op)"


def reduce_trace(events: list, readings: Readings) -> Readings:
    """Fill readings' device numbers from Chrome-trace events."""
    wins = [e for e in events
            if e.get("name") == WINDOW and e.get("cat") == "user_annotation" and "dur" in e]
    if not wins:
        return readings
    w0 = float(wins[0]["ts"])
    w1 = w0 + float(wins[0]["dur"])
    readings.window_s = (w1 - w0) / 1e6
    dev, intervals = defaultdict(float), []
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
            if b > a:
                dev[e["name"]] += (b - a) / 1e6
                intervals.append((a, b))
    merged = _merge(intervals)
    readings.busy_s = sum(b - a for a, b in merged) / 1e6
    readings.device_ops = dict(dev)
    host = sorted((e for e in events if e.get("cat") in HOST_CATS and "dur" in e),
                  key=lambda e: float(e["ts"]))
    starts = [float(e["ts"]) for e in host]
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = defaultdict(float)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps[_host_label(starts, host, 0.5 * (a + b))] += (b - a) / 1e6
    readings.idle_gaps = dict(gaps)
    return readings


def profile(device):
    """A torch.profiler context over the host and, on a card, the device."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    return _profile(activities=acts)


def read_profile(prof) -> list:
    """The profile's Chrome-trace events (written to a temporary file of the
    run's TMPDIR, read and deleted)."""
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text())["traceEvents"]


def breakdown(readings: Readings, top: int = 10) -> dict:
    """The device operations that took most time and the idle gaps by what
    the host was doing, each at most `top` entries of [name, seconds]."""
    ops = sorted(readings.device_ops.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(readings.idle_gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in gaps]}

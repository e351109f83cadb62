#!/usr/bin/env python3
"""The program's own spans and counters in a traced run.

The port marks its layers with `lgr.*` spans (lidar_global_registration_tpu_torch/
utils/profiling.py): `lgr.pair` around each register_pair_staged call,
`lgr.pre_downsample`, `lgr.keypoints.<stage>`, `lgr.descriptors.<stage>`,
`lgr.match` (with `lgr.match.descriptor_nn`, `.gate_knn`, `.consensus`
inside), `lgr.solver`, and in set-up `lgr.setup.kernel_library` and
`lgr.setup.radii`; its counters are `pairs` and `solver.rounds`.  With the
tracer on, each span is a record_function annotation on the profiler's
clock.  `reduce` reads them off the profiled stretch's Chrome trace
(tracing.WINDOW):

- idle time by layer: each idle gap of the device is split at span
  boundaries and each part charged to the layer of the innermost `lgr.`
  span over it; `pair` where that is `lgr.pair` itself (the registration's
  host work between its stages), `outside` where no span covers it (the
  loop around the program and the pose read);
- device time by span: each device operation charged to the innermost
  `lgr.` span around the host runtime call that launched it, found by the
  trace's `correlation` id;
- host syncs: the synchronising runtime calls (SYNC_EVENTS) inside
  `lgr.pair`, by innermost span.

READERS turns them into the per-layer numbers.  run.py does not turn the
tracer on, so no cell reports them yet; this file's own run does:

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s> [--profile 0]

runs run.run_cell on the card with the tracer on: with --profile 1 (the
default) a traced run whose set-up span sums are snapshotted and reset when
the profiler starts and whose tracer stops with the profiler (so the
stage-timed pairs run as in run.py), and prints run.py's line with the
readings under "spans"; with --profile 0 an untraced run with the tracer on
throughout, to set against run.py --trace 0.
"""
from __future__ import annotations

import argparse
import bisect
import importlib
import json
import sys
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import tracing  # noqa: E402

PREFIX = "lgr."
PAIR = "lgr.pair"
LAYERS = ("pre_downsample", "keypoints", "descriptors", "match", "solver")
OUTSIDE = "outside"
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
# the runtime calls that block the host until the device has caught up: a
# .item(), a .tolist() and an aten::nonzero each leave a cudaMemcpyAsync then
# a cudaStreamSynchronize (benchmark/tests/test_bench_spans.py, on the card)
SYNC_EVENTS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
               "cudaMemcpy")


@dataclass
class SpanReadings:
    pairs: int = 0  # lgr.pair spans inside the profiled stretch
    window_s: float = 0.0
    busy_s: float = 0.0
    idle_s: dict = field(default_factory=dict)  # layer ("pair" too) or OUTSIDE -> seconds
    device_total_s: float = 0.0  # device operations inside the stretch
    device_charged_s: float = 0.0  # of which the launch was found by correlation
    device_s: dict = field(default_factory=dict)  # innermost span or OUTSIDE -> seconds
    ops_by_span: dict = field(default_factory=dict)  # span -> {operation: seconds}
    syncs: dict = field(default_factory=dict)  # innermost span -> sync calls in lgr.pair
    setup: dict = field(default_factory=dict)  # set-up's span sums: name -> {seconds, calls}
    counts: dict = field(default_factory=dict)  # the profiled pairs' counters


def layer_of(span):
    """The layer a span name charges: its second part (`pair` for lgr.pair),
    OUTSIDE for None."""
    return OUTSIDE if span is None else span.split(".")[1]


def _pieces(spans, w0: float, w1: float) -> list:
    """[w0, w1] cut at span boundaries: (start, end, innermost span name or
    None).  `spans` are (start, end, name), nested as one thread opens them."""
    marks = []
    for i, (a, b, _name) in enumerate(spans):
        marks.append((a, 1, i))
        marks.append((b, 0, i))
    marks.sort()  # at one instant, ends before starts
    out, open_, t = [], [], w0
    for x, starts, i in marks:
        x = min(max(x, w0), w1)
        if x > t:
            out.append((t, x, spans[open_[-1]][2] if open_ else None))
            t = x
        if starts:
            open_.append(i)
        else:
            open_.remove(i)
    if t < w1:
        out.append((t, w1, None))
    return out


def _at(pieces, starts, t: float):
    """The innermost span name at time t (None outside every span and the stretch)."""
    k = bisect.bisect_right(starts, t) - 1
    if k < 0 or t > pieces[k][1]:
        return None
    return pieces[k][2]


def reduce(events: list, readings: SpanReadings | None = None) -> SpanReadings:
    """Fill readings' span numbers from Chrome-trace events (the profiled
    stretch is tracing.WINDOW's annotation; nothing is read without it)."""
    r = readings if readings is not None else SpanReadings()
    wins = [e for e in events if e.get("name") == tracing.WINDOW
            and e.get("cat") == "user_annotation" and "dur" in e]
    if not wins:
        return r
    w0 = float(wins[0]["ts"])
    w1 = w0 + float(wins[0]["dur"])
    r.window_s = (w1 - w0) / 1e6
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                    for e in events
                    if e.get("cat") == "user_annotation" and "dur" in e and float(e["dur"]) > 0
                    and str(e.get("name", "")).startswith(PREFIX)),
                   key=lambda s: (s[0], -s[1]))
    spans = [s for s in spans if s[1] > w0 and s[0] < w1]
    r.pairs = sum(1 for a, b, name in spans if name == PAIR and w0 <= a and b <= w1)
    pieces = _pieces(spans, w0, w1)
    starts = [p[0] for p in pieces]

    # device time by the span of its launch, and the busy intervals
    launch = {}
    for e in events:
        if e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = float(e["ts"])
    dev, ops, intervals = defaultdict(float), defaultdict(lambda: defaultdict(float)), []
    total = charged = 0.0
    for e in events:
        if e.get("cat") in tracing.DEVICE_CATS and "dur" in e:
            a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
            if b <= a:
                continue
            intervals.append((a, b))
            s = (b - a) / 1e6
            total += s
            t = launch.get(e.get("args", {}).get("correlation"))
            if t is not None:
                charged += s
            name = _at(pieces, starts, t) if t is not None and w0 <= t <= w1 else None
            dev[name or OUTSIDE] += s
            ops[name or OUTSIDE][e["name"]] += s
    r.device_total_s, r.device_charged_s = total, charged
    r.device_s = dict(dev)
    r.ops_by_span = {k: dict(v) for k, v in ops.items()}
    merged = tracing._merge(intervals)
    r.busy_s = sum(b - a for a, b in merged) / 1e6

    # idle gaps split at span boundaries
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    idle, k = defaultdict(float), 0
    for a, b in gaps:
        while k < len(pieces) and pieces[k][1] <= a:
            k += 1
        j = k
        while j < len(pieces) and pieces[j][0] < b:
            lo, hi = max(a, pieces[j][0]), min(b, pieces[j][1])
            if hi > lo:
                idle[layer_of(pieces[j][2])] += (hi - lo) / 1e6
            j += 1
    r.idle_s = dict(idle)

    # host syncs inside lgr.pair
    pair_iv = sorted((a, b) for a, b, name in spans if name == PAIR)
    pair_starts = [a for a, _b in pair_iv]
    syncs = defaultdict(int)
    for e in events:
        if e.get("cat") in RUNTIME_CATS and e.get("name") in SYNC_EVENTS:
            t = float(e["ts"])
            k = bisect.bisect_right(pair_starts, t) - 1
            if k >= 0 and t <= pair_iv[k][1] and w0 <= t <= w1:
                syncs[_at(pieces, starts, t)] += 1
    r.syncs = dict(syncs)
    return r


# ---- the per-layer numbers: each None where its data is absent
def _idle_ms(layer):
    def read(r):
        if not r.pairs or not r.device_total_s:
            return None
        return 1e3 * r.idle_s.get(layer, 0.0) / r.pairs
    return read


def _device_ms(span):
    def read(r):
        if not r.pairs or not r.device_total_s:
            return None
        return 1e3 * r.device_s.get(span, 0.0) / r.pairs
    return read


def _host_syncs(r):
    if not r.pairs or not r.device_total_s:
        return None
    return sum(r.syncs.values()) / r.pairs


def _solver_rounds(r):
    if not r.counts.get("pairs") or "solver.rounds" not in r.counts:
        return None
    return r.counts["solver.rounds"] / r.counts["pairs"]


def _setup_s(span):
    def read(r):
        return r.setup[span]["seconds"] if span in r.setup else None
    return read


READERS = {
    **{f"idle_ms.{layer}": _idle_ms(layer) for layer in LAYERS},
    "match_ms.descriptor_nn": _device_ms("lgr.match.descriptor_nn"),
    "match_ms.gate_knn": _device_ms("lgr.match.gate_knn"),
    "host_syncs": _host_syncs,
    "solver.rounds": _solver_rounds,
    "setup_s.kernel_library": _setup_s("lgr.setup.kernel_library"),
    "setup_s.radii": _setup_s("lgr.setup.radii"),
}


def read_all(r: SpanReadings) -> dict:
    return {name: read(r) for name, read in READERS.items()}


def summary(r: SpanReadings) -> dict:
    """What the readers sum over, for the run's stderr: the idle seconds by
    layer beside the stretch's idle, the share of device time charged by
    correlation, device and sync counts by span, the top operations of
    the match's parts."""
    match_dev = sum(v for k, v in r.device_s.items() if k != OUTSIDE and layer_of(k) == "match")
    top = {k: sorted(v.items(), key=lambda kv: -kv[1])[:5] for k, v in r.ops_by_span.items()
           if k.startswith("lgr.match")}
    return {"pairs": r.pairs, "window_s": r.window_s, "busy_s": r.busy_s,
            "idle_s": r.idle_s, "idle_sum_s": sum(r.idle_s.values()),
            "window_minus_busy_s": r.window_s - r.busy_s,
            "charged_share": r.device_charged_s / r.device_total_s if r.device_total_s else None,
            "device_ms_by_span": {k: 1e3 * v / max(r.pairs, 1) for k, v in r.device_s.items()},
            "match_device_ms": 1e3 * match_dev / max(r.pairs, 1),
            "syncs_by_span": {str(k): v / max(r.pairs, 1) for k, v in r.syncs.items()},
            "top_ops": {k: [[n[:120], s] for n, s in v] for k, v in top.items()}}


def traced_run(cell, seed: int, seconds: float, device, profile: bool = True):
    """run.run_cell with the program's tracer on (see the module's doc).
    Returns (run.py's result dict, SpanReadings or None)."""
    from benchmark import run

    prof_mod = importlib.import_module(f"{run.PORT}.utils.profiling")
    state = SimpleNamespace(setup={}, counts={}, events=None)

    class Window:
        """The profiler's context: set-up's sums snapshotted and reset when
        it starts, the tracer stopped when it ends."""

        def __init__(self, inner):
            self.inner = inner

        def __enter__(self):
            state.setup = prof_mod.snapshot()["spans"]
            prof_mod.reset()
            self.inner.__enter__()
            return self

        def __exit__(self, *exc):
            out = self.inner.__exit__(*exc)
            state.counts = prof_mod.snapshot()["counts"]
            prof_mod.disable()
            return out

    def read_profile(prof):
        state.events = orig_read(prof.inner)
        return state.events

    orig_profile, orig_read = tracing.profile, tracing.read_profile
    tracing.profile = lambda dev: Window(orig_profile(dev))
    tracing.read_profile = read_profile
    prof_mod.reset()
    prof_mod.enable()
    try:
        result = run.run_cell(cell, seed, seconds, profile, device)
    finally:
        tracing.profile, tracing.read_profile = orig_profile, orig_read
        prof_mod.disable()
    if not profile:
        return result, None
    r = reduce(state.events or [], SpanReadings(setup=state.setup, counts=state.counts))
    return result, r


def main(argv=None) -> int:
    import torch

    from benchmark import manifest, run

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available():
        run.log("no result: the cell needs a CUDA card")
        return 2
    result, r = traced_run(cell, args.seed, args.seconds, torch.device("cuda"),
                           bool(args.profile))
    if r is not None:
        result["spans"] = read_all(r)
        s = summary(r)
        run.log(f"# spans: idle s by layer {s['idle_s']} (sum {s['idle_sum_s']!r}, window - busy "
                f"{s['window_minus_busy_s']!r}); outside {s['idle_s'].get(OUTSIDE, 0.0)!r} s; "
                f"device time charged by correlation {s['charged_share']!r}")
        run.log("# spans summary " + json.dumps(s))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's tracer (utils/profiling.py): spans at the layer boundaries of
register_pair_staged, pre_downsample_pair and set-up, the counters, and
the stage times the spans share their boundaries with.  On the CPU, with
the ISS e2e tests' scene at 2,048 points a side."""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lidar_global_registration_tpu_torch.models import flagship as tfl
from lidar_global_registration_tpu_torch.ops.density import derive_radii
from lidar_global_registration_tpu_torch.utils import profiling
from test_torch_e2e_iss import RADII, SETTINGS, pair_inputs

torch.set_num_threads(2)

N = 2048
PYR_RADII = (0.6, 0.15, 0.15, 0.4, 0.4, 2.4, 0.6)  # tests/test_torch_e2e_pyramid.py's
ISS_LABELS = ["fs_maps", "plan", "side_src", "side_tgt", "fpfh_src", "fpfh_tgt", "match_corr",
              "ransac"]
LAYERS = ("keypoints", "descriptors", "match", "solver")


@pytest.fixture(autouse=True)
def tracer_off():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def _pair(radii=RADII, stage_times=None, **cfg):
    a, b, vp_a, vp_b = pair_inputs(N)
    ones = torch.ones(N, dtype=torch.bool)
    return tfl.register_pair_staged(
        torch.from_numpy(a), ones, torch.from_numpy(b), ones, torch.Generator().manual_seed(3),
        *radii, vp_src=torch.from_numpy(vp_a), vp_tgt=torch.from_numpy(vp_b),
        cfg=tfl.FlagshipConfig(**{**SETTINGS, **cfg}), return_correspondences=True,
        stage_times=stage_times)


def _spans(prof):
    """(name, start, end) of every lgr. annotation in a profile."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith("lgr.")]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_off_is_a_shared_noop(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("called while the tracer is off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(profiling.time, "perf_counter", boom)
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    assert not profiling.enabled()
    s1, s2 = profiling.span("lgr.match"), profiling.span("lgr.solver")
    assert s1 is s2
    with s1, s2:
        pass
    assert profiling.snapshot()["spans"] == {}


def test_off_leaves_no_annotation_and_the_stage_labels():
    times = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _pair(stage_times=times)
    assert _spans(prof) == []
    assert list(times) == ISS_LABELS
    assert bool(out["converged"])


@pytest.mark.parametrize("route,radii,cfg", [
    ("feature-scale", RADII, {}),
    ("pyramid", PYR_RADII, {"pyramid": True}),
], ids=["feature-scale", "pyramid"])
def test_on_spans_nest_under_the_pair(route, radii, cfg):
    profiling.enable()
    times = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _pair(radii, stage_times=times, **cfg)
    spans = _spans(prof)
    pairs = [s for s in spans if s[0] == "lgr.pair"]
    assert len(pairs) == 1
    rest = [s for s in spans if s[0] != "lgr.pair"]
    assert rest and all(_inside(s, pairs[0]) for s in rest)
    assert {s[0].split(".")[1] for s in rest} == set(LAYERS)
    matches = [s for s in rest if s[0] == "lgr.match"]
    for part in ("lgr.match.gate_knn", "lgr.match.consensus", "lgr.match.descriptor_nn"):
        found = [s for s in rest if s[0] == part]
        assert found, part
        assert all(any(_inside(s, m) for m in matches) for s in found), part
    # each stage's span under its stage_times label, once a label
    names = {s[0] for s in rest}
    for label in times:
        assert tfl._stage_span(label) in names, label
    assert bool(out["converged"])
    snap = profiling.snapshot()
    assert snap["spans"]["lgr.pair"]["calls"] == 1
    assert snap["spans"]["lgr.solver"]["calls"] == 1


def test_pre_downsample_and_radii_spans():
    a, b, _vp_a, _vp_b = pair_inputs(N)
    src, tgt = torch.from_numpy(a), torch.from_numpy(b)
    ones = torch.ones(N, dtype=torch.bool)
    profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        radii = derive_radii(src, tgt)
        tfl.pre_downsample_pair(src, ones, tgt, ones, 2 * radii["density_src"],
                                2 * radii["density_tgt"])
    names = [s[0] for s in _spans(prof)]
    assert names.count("lgr.setup.radii") == 1 and names.count("lgr.pre_downsample") == 1
    snap = profiling.snapshot()["spans"]
    assert snap["lgr.setup.radii"]["seconds"] > 0 and snap["lgr.pre_downsample"]["calls"] == 1


def test_solver_rounds_counts_each_round():
    out = _pair()
    counts = profiling.snapshot()["counts"]
    assert counts["pairs"] == 1
    assert counts["solver.rounds"] == int(out["iterations"]) // SETTINGS["hypothesis_batch"]
    assert counts["solver.rounds"] * SETTINGS["hypothesis_batch"] == int(out["iterations"])


def test_snapshot_and_reset():
    profiling.count("c", 3)  # counters count with the tracer off
    with profiling.span("lgr.a"):
        pass
    assert profiling.snapshot() == {"spans": {}, "counts": {"c": 3}}
    profiling.enable()
    for _ in range(2):
        with profiling.span("lgr.a"):
            pass
    profiling.count("c")
    snap = profiling.snapshot()
    assert snap["counts"] == {"c": 4}
    assert snap["spans"]["lgr.a"]["calls"] == 2 and snap["spans"]["lgr.a"]["seconds"] >= 0
    snap["counts"]["c"] = 0  # a copy
    assert profiling.snapshot()["counts"]["c"] == 4
    profiling.disable()
    with profiling.span("lgr.a"):
        pass
    assert profiling.snapshot()["spans"]["lgr.a"]["calls"] == 2  # kept while off
    profiling.reset()
    assert profiling.snapshot() == {"spans": {}, "counts": {}}


def test_maybe_torch_profile_turns_the_tracer_on(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("LGR_PROFILE", str(tmp_path))
    with profiling.maybe_torch_profile(cuda=False):
        assert profiling.enabled()
        with profiling.span("lgr.x"):
            torch.ones(4).sum()
    assert not profiling.enabled()
    (trace,) = tmp_path.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "lgr.x" in names
    assert "[profiler] trace written to" in capsys.readouterr().out

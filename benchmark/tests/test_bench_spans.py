"""benchmark/spans.py over hand-made Chrome traces (times in microseconds),
its run on the CPU at a test's size, and on the card the runtime calls a
host read leaves."""
import pytest
import torch

from benchmark import manifest, spans, tracing


def ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def ann(name, ts, dur):
    return ev(name, "user_annotation", ts, dur)


def kernel(ts, dur, corr=None, name="k"):
    return ev(name, "kernel", ts, dur, **({} if corr is None else {"correlation": corr}))


def launch(ts, corr):
    return ev("cudaLaunchKernel", "cuda_runtime", ts, 5, correlation=corr)


WINDOW = ann(tracing.WINDOW, 0, 1000)


def test_idle_gap_straddling_two_spans_is_split():
    events = [WINDOW, ann("lgr.pair", 0, 1000), ann("lgr.keypoints.plan", 100, 300),
              ann("lgr.match", 400, 300), kernel(0, 300), kernel(500, 500)]
    r = spans.reduce(events)
    assert r.pairs == 1
    assert r.idle_s == pytest.approx({"keypoints": 1e-4, "match": 1e-4})
    assert sum(r.idle_s.values()) == pytest.approx(r.window_s - r.busy_s)
    assert spans.READERS["idle_ms.keypoints"](r) == pytest.approx(0.1)
    assert spans.READERS["idle_ms.solver"](r) == 0.0


def test_gap_outside_every_span_goes_outside():
    events = [WINDOW, ann("lgr.pair", 100, 800), ann("lgr.solver", 600, 300),
              ann("bench.pose_read", 900, 100), kernel(100, 300), kernel(450, 150)]
    r = spans.reduce(events)
    # [0, 100) and [900, 1000) outside; [400, 450) in lgr.pair between stages;
    # [600, 900) in the solver
    assert r.idle_s == pytest.approx({"outside": 2e-4, "pair": 5e-5, "solver": 3e-4})
    assert sum(r.idle_s.values()) == pytest.approx(r.window_s - r.busy_s)


def test_kernel_charged_by_its_launch_not_when_it_ran():
    events = [WINDOW, ann("lgr.pair", 0, 1000), ann("lgr.match", 100, 800),
              ann("lgr.match.gate_knn", 100, 300), ann("lgr.match.consensus", 400, 300),
              launch(150, 7), kernel(450, 200, 7, "mbtopk"),  # runs during consensus
              launch(420, 8), kernel(700, 50, 8),
              kernel(800, 100)]  # no launch found: charged outside
    r = spans.reduce(events)
    assert r.device_s == pytest.approx({"lgr.match.gate_knn": 2e-4,
                                        "lgr.match.consensus": 5e-5, "outside": 1e-4})
    assert r.ops_by_span["lgr.match.gate_knn"] == pytest.approx({"mbtopk": 2e-4})
    assert r.device_charged_s / r.device_total_s == pytest.approx(2.5 / 3.5)
    assert spans.READERS["match_ms.gate_knn"](r) == pytest.approx(0.2)
    assert spans.READERS["match_ms.descriptor_nn"](r) == 0.0


def test_syncs_counted_per_pair():
    sync = lambda ts: ev("cudaStreamSynchronize", "cuda_runtime", ts, 10)  # noqa: E731
    events = [WINDOW, ann("lgr.pair", 0, 400), ann("lgr.match", 50, 100),
              ann("lgr.pair", 500, 400), kernel(0, 100),
              sync(100), sync(200), sync(600), sync(950),  # the last outside both pairs
              ev("cudaMemcpyAsync", "cuda_runtime", 300, 10)]  # not a sync alone
    r = spans.reduce(events)
    assert r.pairs == 2
    assert r.syncs == {"lgr.match": 1, "lgr.pair": 2}
    assert spans.READERS["host_syncs"](r) == pytest.approx(1.5)


def test_readers_none_where_data_absent():
    assert all(v is None for v in spans.read_all(spans.SpanReadings()).values())
    assert all(v is None for v in spans.read_all(spans.reduce([])).values())
    # a program with no spans or counters: the device is seen, nothing else
    r = spans.reduce([WINDOW, ann("bench.register", 0, 900), kernel(0, 300)])
    assert r.busy_s > 0 and all(v is None for v in spans.read_all(r).values())
    r = spans.SpanReadings(counts={"pairs": 4, "solver.rounds": 10},
                           setup={"lgr.setup.radii": {"seconds": 1.5, "calls": 9}})
    got = spans.read_all(r)
    assert got["solver.rounds"] == 2.5 and got["setup_s.radii"] == 1.5
    assert got["setup_s.kernel_library"] is None and got["idle_ms.match"] is None


def test_solver_rounds_metric_reads_the_program_counters(monkeypatch):
    from lidar_global_registration_tpu_torch.utils import profiling

    read = manifest.reader("solver.rounds")
    profiling.reset()
    assert read(tracing.Readings()) is None
    profiling.count("pairs", 2)
    profiling.count("solver.rounds", 5)
    assert read(tracing.Readings()) == 2.5
    profiling.reset()
    monkeypatch.delitem(__import__("sys").modules,
                        "lidar_global_registration_tpu_torch.utils.profiling")
    assert read(tracing.Readings()) is None


def test_traced_run_on_the_cpu(tiny_cell):
    from lidar_global_registration_tpu_torch.utils import profiling

    res, r = spans.traced_run(tiny_cell(), 2**31 + 11, 6.0, torch.device("cpu"))
    assert res["correct"] is True and not profiling.enabled()
    assert r.pairs == 1  # the profiled pair, whole in the stretch
    assert r.setup["lgr.setup.radii"]["calls"] == 3  # the raw pair, then each pooled pose
    assert "lgr.pair" in r.setup  # set-up's registrations
    got = spans.read_all(r)
    assert got["solver.rounds"] > 0 and got["setup_s.radii"] > 0
    assert got["idle_ms.match"] is None  # no device on the CPU
    assert res["metrics"]["solver.rounds"]["value"] > 0
    res, r = spans.traced_run(tiny_cell(), 2**31 + 11, 1.0, torch.device("cpu"), profile=False)
    assert r is None and res["correct"] is True and "pairs_per_s" in res["metrics"]
    assert not profiling.enabled()


@pytest.mark.card
def test_host_reads_leave_a_sync_event(card):
    """A .item(), a .tolist() and an aten::nonzero each leave one of
    SYNC_EVENTS inside their annotation."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.rand(1 << 20, device=card)
    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("t.item"):
            (x * 2).sum().item()
        with record_function("t.tolist"):
            (x[:4] * 2).tolist()
        with record_function("t.nonzero"):
            torch.nonzero(x > 0.5)
    events = tracing.read_profile(prof)
    found = {}
    for name in ("t.item", "t.tolist", "t.nonzero"):
        (a,) = [e for e in events if e.get("name") == name and e.get("cat") == "user_annotation"]
        lo, hi = float(a["ts"]), float(a["ts"]) + float(a["dur"])
        found[name] = sorted({e["name"] for e in events if e.get("cat") in spans.RUNTIME_CATS
                              and lo <= float(e["ts"]) <= hi})
    print(found)
    assert all(set(v) & set(spans.SYNC_EVENTS) for v in found.values()), found

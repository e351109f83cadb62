"""bench_torch.py and tools/bench_sweep_torch.py, the port's bench entry and
sweep, against bench.py and tools/bench_sweep.py on the CPU.

The printed JSON lines are held equal to bench.py's for the same canned
results (one-row mode and the default rows' merge), the success rule at its
edges, the radii to bench.py's, and a few CPU runs of the port's plain
versions: a keypoint-any and an ISS row, the CPU worker with JAX blocked,
and the no-card refusal.
"""
import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
import bench_torch
from __graft_entry__ import _synthetic_pair
from lidar_global_registration_tpu_torch.ops.density import derive_radii

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = ("LGR_BENCH_N", "LGR_BENCH_REPEATS", "LGR_BENCH_CPU_N", "LGR_BENCH_ISS",
         "LGR_BENCH_EXTENT", "LGR_BENCH_GRADED", "LGR_BENCH_PREDS", "LGR_BENCH_METRIC",
         "LGR_BENCH_DESC", "LGR_BENCH_ALIGN", "LGR_BENCH_PYRAMID", "LGR_BENCH_MODE",
         "LGR_BENCH_SUB", "LGR_STAGE_TIMING")


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def clean_env(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _json_line(text: str) -> dict:
    return json.loads([l for l in text.strip().splitlines() if l.startswith("{")][-1])


# ---------------------------------------------------------------------------
# the output format against bench.py's, on canned results
# ---------------------------------------------------------------------------
ONE_ROW = {
    "all_ok": (0.25, True, False),
    "one_repeat_failed": (0.25, False, False),
    "baseline_raises": (0.25, True, True),
}


@pytest.mark.parametrize("case", sorted(ONE_ROW))
def test_one_row_json_equals_bench(case, clean_env, capsys):
    secs, ok, raises = ONE_ROW[case]
    clean_env.setenv("LGR_BENCH_N", "65536")
    clean_env.setattr(torch.cuda, "is_available", lambda: True)
    per = [0.251, 0.25, 0.249]

    def baseline(n):
        if raises:
            raise RuntimeError("no baseline")
        return 12.5

    lines = []
    for mod, stats in ((bench, {"per_repeat_s": per, "rtt_probe_ms": [0.1, 0.1, 0.2]}),
                       (bench_torch, {"per_repeat_s": per})):
        clean_env.setattr(mod, "N", 65536)
        clean_env.setattr(mod, "CPU_N", 65536)
        clean_env.setattr(mod, "run_step", lambda n, r, st=stats: (secs, ok, dict(st)))
        clean_env.setattr(mod, "cpu_baseline", baseline)
        mod.main()
        out = _json_line(capsys.readouterr().out)
        out.pop("rtt_probe_ms", None)
        lines.append(json.dumps(out))
    assert lines[0] == lines[1]
    got = json.loads(lines[1])
    assert got["metric"] == "register_64k_pt_pair_e2e"
    assert (got["value"] > 0) == ok
    assert got["vs_baseline"] == (None if raises else (round(12.5 / secs, 3) if ok else 0.0))


MERGE = {
    "both_fine": ({"metric": "register_64k_pt_pair_e2e", "value": 25.1, "unit": "pairs/s",
                   "vs_baseline": 300.0, "per_repeat_s": [0.04, 0.04, 0.04]},
                  {"metric": "register_10240k_pt_pair_e2e", "value": 3.3, "unit": "pairs/s",
                   "vs_baseline": 9.1, "per_repeat_s": [0.3, 0.3, 0.31]}),
    "10m_failed": ({"metric": "register_64k_pt_pair_e2e", "value": 25.1, "unit": "pairs/s",
                    "vs_baseline": 300.0, "per_repeat_s": [0.04, 0.04, 0.04]},
                   {"metric": "register_10240k_pt_pair_e2e", "value": 0.0, "unit": "pairs/s",
                    "vs_baseline": 0.0, "error": "not all repeats converged with correct pose",
                    "per_repeat_s": [0.3, 0.3, 0.31]}),
    "10m_lost": ({"metric": "register_64k_pt_pair_e2e", "value": 25.1, "unit": "pairs/s",
                  "vs_baseline": 300.0, "per_repeat_s": [0.04, 0.04, 0.04]}, None),
    "both_failed": (None, None),
}


@pytest.mark.parametrize("case", sorted(MERGE))
def test_default_merge_equals_bench(case, clean_env, capsys):
    r64, r10 = MERGE[case]
    printed, calls = [], []
    for mod in (bench, bench_torch):
        seen = []

        def sub(env_over, timeout, seen=seen):
            seen.append((dict(env_over), timeout))
            row = r10 if env_over.get("LGR_BENCH_ISS") == "1" else r64
            return None if row is None else dict(row)

        clean_env.setattr(mod, "_sub_bench", sub)
        mod._main_flagship()
        printed.append(capsys.readouterr().out)
        calls.append(seen)
    assert printed[0] == printed[1]
    assert calls[0] == calls[1]
    assert [c[0]["LGR_BENCH_N"] for c in calls[1]] == ["65536", "10485760"]


def test_default_mode_runs_the_two_rows(clean_env, capsys):
    """With no LGR_BENCH_N, main() runs _main_flagship on the card."""
    clean_env.setattr(torch.cuda, "is_available", lambda: True)
    seen = []
    clean_env.setattr(bench_torch, "_sub_bench", lambda env, tmo: seen.append(env) or None)
    bench_torch.main()
    assert [e.get("LGR_BENCH_ISS") for e in seen] == [None, "1"]
    assert _json_line(capsys.readouterr().out)["error"] == "both workloads failed"


# ---------------------------------------------------------------------------
# the rule and the radii
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("conv, r_err, t_err, thr", [
    (True, 0.05, 0.1, 1.0),            # r_err at the bound: fails
    (True, np.nextafter(0.05, 0.0), 0.1, 1.0),
    (True, 0.01, 1.0, 1.0),            # t_err at distance_thr: fails
    (True, 0.01, np.nextafter(1.0, 0.0), 1.0),
    (False, 0.0, 0.0, 1.0),
    (True, 0.0, 0.0, 0.0),
])
def test_success_rule_at_its_edges(conv, r_err, t_err, thr):
    assert bench_torch.R_ERR_MAX == bench.R_ERR_MAX
    # bench.py:327, inline there
    want = conv and r_err < bench.R_ERR_MAX and t_err < thr
    assert bench_torch.success(conv, r_err, t_err, thr) == want


def test_radii_equal_bench():
    """At 4,096 points the keypoint-any pair lies under the JAX package's grid
    caps, so both cloud densities are exact k-NN quantiles and only float32
    rounding can part the two derivations."""
    a, b = _synthetic_pair(4096)
    want = bench._derive_radii(a, b, 4096)
    got = bench_torch._derive_radii(torch.from_numpy(a), torch.from_numpy(b))
    assert got == derive_radii(torch.from_numpy(a), torch.from_numpy(b))
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), rel=1e-5), k


# ---------------------------------------------------------------------------
# CPU runs of the port's plain versions
# ---------------------------------------------------------------------------
def test_cpu_step_keypoint_any_meets_the_rule(clean_env, capsys):
    secs, ok, stats = bench_torch.run_step(4096, 2, device="cpu")
    err = capsys.readouterr().err
    repeats = [l for l in err.splitlines() if l.startswith("# repeat")]
    assert ok and len(repeats) == 2 and all(l.endswith("ok=True") for l in repeats)
    assert len(stats["per_repeat_s"]) == 2 and secs > 0
    assert "# launches" not in err  # the counters are the card's


def test_cpu_step_iss_row(clean_env, capsys):
    """The ISS row (the box + mound scene, pre-downsample in the repeats,
    stage lines) at 32,768 points; the row posts value > 0 exactly when
    every repeat met the rule."""
    clean_env.setenv("LGR_BENCH_ISS", "1")
    clean_env.setenv("LGR_STAGE_TIMING", "1")
    result = bench_torch.run_step(32768, 2, device="cpu")
    err = capsys.readouterr().err.splitlines()
    assert sum(l.startswith("# derived: ") for l in err) == 2
    assert any(l.startswith("# pre-downsample: 32768 -> ") for l in err)
    stages = [l.split(":")[0] for l in err if l.startswith("# [stage] ")]
    assert stages.count("# [stage] pre_downsample") == 3  # warm-up + 2 repeats
    assert stages.count("# [stage] ransac") == 3
    repeats = [l for l in err if l.startswith("# repeat")]
    assert len(repeats) == 2
    assert result[1] == all(l.endswith("ok=True") for l in repeats)

    clean_env.setenv("LGR_BENCH_N", "32768")
    clean_env.setattr(torch.cuda, "is_available", lambda: True)
    clean_env.setattr(bench_torch, "N", 32768)
    clean_env.setattr(bench_torch, "run_step", lambda n, r: result)
    clean_env.setattr(bench_torch, "cpu_baseline", lambda n: 1.0)
    bench_torch.main()
    out = _json_line(capsys.readouterr().out)
    assert out["metric"] == "register_32k_pt_pair_e2e"
    assert (out["value"] > 0) == result[1] == ("error" not in out)


def _run(env_over: dict, code: str | None = None):
    env = {k: v for k, v in os.environ.items() if k not in KNOBS}
    env.update(env_over, OMP_NUM_THREADS="2")
    cmd = [sys.executable, "bench_torch.py"] if code is None else [sys.executable, "-c", code]
    return subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_cpu_worker_runs_without_jax():
    p = _run({"LGR_BENCH_MODE": "cpu_worker", "LGR_BENCH_N": "2048", "LGR_BENCH_REPEATS": "1"},
             "import runpy, sys; sys.modules['jax'] = None; "
             "runpy.run_path('bench_torch.py', run_name='__main__')")
    assert p.returncode == 0, p.stderr[-3000:]
    secs = _json_line(p.stdout)["seconds_per_pair"]
    assert math.isfinite(secs) and secs > 0


@pytest.mark.parametrize("env", [{"LGR_BENCH_N": "2048"}, {}], ids=["one_row", "default"])
def test_no_card_exits_nonzero(env):
    p = _run({**env, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert '"value"' not in p.stdout
    assert "CUDA card" in p.stderr


def test_cpu_baseline_cache_is_its_own(clean_env, tmp_path):
    """The baseline is cached per size and mode under the port's own key, in
    a file of its own (never bench.py's); a cached key runs no worker."""
    assert os.path.basename(bench_torch.CACHE) == ".bench_torch_cpu_cache.json"
    assert bench_torch.CACHE != bench.CACHE
    cache = tmp_path / "cache.json"
    cache.write_text(json.dumps({"cpu_4096_any_torch_v1": 3.5, "cpu_4096_iss_torch_v1": 7.0}))
    clean_env.setattr(bench_torch, "CACHE", str(cache))
    clean_env.setattr(subprocess, "run", lambda *a, **k: pytest.fail("ran a worker"))
    assert bench_torch.cpu_baseline(4096) == 3.5
    clean_env.setenv("LGR_BENCH_ISS", "1")
    assert bench_torch.cpu_baseline(4096) == 7.0


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------
def test_sweep_rows_equal_bench_sweep():
    old, new = _tool("bench_sweep"), _tool("bench_sweep_torch")
    assert new.ROWS == old.ROWS
    assert new.DEFAULT == old.DEFAULT


def test_sweep_runs_bench_torch_per_row(tmp_path, monkeypatch):
    sweep = _tool("bench_sweep_torch")
    monkeypatch.setattr(sweep, "OUT_JSONL", str(tmp_path / "rows.jsonl"))
    monkeypatch.setattr(sweep, "OUT_LOG", str(tmp_path / "rows.log"))
    seen = []

    def run(cmd, env, **kw):
        seen.append((cmd, env))
        return subprocess.CompletedProcess(cmd, 0, stdout='{"value": 1.5}\n', stderr="# repeat\n")

    monkeypatch.setattr(sweep.subprocess, "run", run)
    sweep.main(["iss1m", "any256k"])
    assert [c[-1] for c, _ in seen] == [os.path.join(ROOT, "bench_torch.py")] * 2
    assert seen[0][1]["LGR_BENCH_ISS"] == "1" and seen[0][1]["LGR_BENCH_N"] == "1048576"
    rows = [json.loads(l) for l in (tmp_path / "rows.jsonl").read_text().splitlines()]
    assert [r["row"] for r in rows] == ["iss1m", "any256k"]
    assert all(r["rc"] == 0 and r["result"] == {"value": 1.5} for r in rows)
    assert "==== iss1m rc=0" in (tmp_path / "rows.log").read_text()
    with pytest.raises(SystemExit):
        sweep.main(["nope"])

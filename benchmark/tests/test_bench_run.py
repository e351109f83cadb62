"""A run on the CPU at a test's size, the harness's look for a card skipped:
the result line's keys, and `correct` false under each fault the cells can
have, planted under the timed path."""
import json
import math
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark import run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _go(cell, trace=False, program=None, seed=2**31 + 7, seconds=1.0):
    return run.run_cell(cell, seed, seconds, trace, torch.device("cpu"), program=program)


def test_untraced_line(tiny_cell):
    res = _go(tiny_cell())
    assert list(res) == KEYS + ["checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {m["name"] for m in tiny_cell().end_to_end}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    json.dumps(res)


def test_traced_line(tiny_cell):
    res = _go(tiny_cell(), trace=True, seconds=6.0)
    assert list(res) == KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"stage_ms.keypoints", "stage_ms.descriptors", "stage_ms.solver"} <= set(res["metrics"])
    assert res["correct"] is True


def _faulty(**over):
    prog = run.load_program()
    return SimpleNamespace(**{**vars(prog), **over})


def _unchanged_state(*args, **kw):
    """The step returns its state unchanged: the identity pose."""
    out = run.load_program().register_pair_staged(*args, **kw)
    out["transformation"] = torch.eye(4, device=out["transformation"].device)
    return out


def _half_left_out(src, sv, tgt, tv, *args, **kw):
    """Half of the rows left out, the centroids taken over the rest."""
    keep = torch.arange(src.shape[0], device=src.device) % 2 == 0
    return run.load_program().pre_downsample_pair(src[keep], sv[keep], tgt[keep], tv[keep],
                                                  *args, **kw)


def _answer_altered(*args, **kw):
    """The pose altered where it is produced: 0.1 rad more yaw."""
    out = run.load_program().register_pair_staged(*args, **kw)
    c, s = math.cos(0.1), math.sin(0.1)
    R = torch.tensor([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=torch.float32)
    out["transformation"] = out["transformation"].clone()
    out["transformation"][:3, :3] = R @ out["transformation"][:3, :3]
    return out


def _token_altered(*args, **kw):
    """A correspondence altered where it is produced: its target row moved
    to the next row."""
    out = run.load_program().register_pair_staged(*args, **kw)
    sel, jm, thr, valid = out["correspondences"]
    out["correspondences"] = (sel, jm + 1, thr, valid)
    return out


@pytest.mark.parametrize("fault", [
    {"register_pair_staged": _unchanged_state},
    {"pre_downsample_pair": _half_left_out},
    {"register_pair_staged": _answer_altered},
    {"register_pair_staged": _token_altered},
], ids=["state_unchanged", "half_left_out", "answer_altered", "token_altered"])
def test_fault_is_not_correct(tiny_cell, fault):
    res = _go(tiny_cell(), program=_faulty(**fault))
    assert res["correct"] is False
    failed = [k for k, (v, lim) in res["checks"].items() if v is None or v > lim]
    assert failed


def test_no_card_no_result():
    p = subprocess.run([sys.executable, str(run.ROOT / "benchmark" / "run.py"), "--workload",
                        "iss_fpfh.4m", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=run.ROOT,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "lidar_global_registration_tpu_torch_x", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.something", object())
    assert run.forbidden_modules() == ["jaxlib"]


def test_nothing_loads_jax():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.run, benchmark.control; "
            "benchmark.run.load_program(); print(benchmark.run.forbidden_modules())"
            % str(run.ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.stages; "
            "print(sorted(m for m in sys.modules if m.startswith('lidar')))" % str(run.ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.stdout.strip() == "[]", p.stderr


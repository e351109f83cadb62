"""A route is added to the benchmark by new files only: a configuration
naming a reference module of its own, the module, a cell's limits and
entries in BENCHMARK.json, and no edit to any file the benchmark holds."""
import json

import torch

from benchmark import control, run, traffic

PROBE = '''"""A route's reference module that delegates to feature_scale and records
the poses it worked out and those it gave the control of."""
from benchmark.reference import feature_scale

COVERS = dict(feature_scale.COVERS)
POSES = []
CONTROLLED = []


class Reference(feature_scale.Reference):
    def _pose(self, k):
        POSES.append(k)
        return super()._pose(k)


def control(ref, k):
    CONTROLLED.append(k)
    return feature_scale.control(ref, k)
'''


def _add_route(root):
    bench = root / "benchmark"
    (bench / "reference" / "probe_route.py").write_text(PROBE)
    conf = json.loads((bench / "configs" / "iss_fpfh.json").read_text())
    conf.update(name="probe", reference="probe_route")
    (bench / "configs" / "probe.json").write_text(json.dumps(conf))
    (bench / "limits" / "probe.4m.json").write_text(json.dumps({"corr_extra": 0.04,
                                                                "corr_missing": 0.015}))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "probe", "source": "benchmark/tests/test_bench_routes.py",
                           "file": "benchmark/configs/probe.json", "reduced": [],
                           "why": "a route added by new files only"})
    man["workloads"].append({"name": "probe.4m", "config": "probe", "traffic": "scan4m_uniform",
                             "chips": 1, "why": "a route added by new files only"})
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))


def test_a_route_is_added_by_new_files_only(bench_copy, tiny_cell):
    before = {p: p.read_bytes() for p in bench_copy.rglob("*") if p.is_file()}
    _add_route(bench_copy)
    cell = tiny_cell("probe.4m", root=bench_copy)
    assert cell.reference.__file__ == str(bench_copy / "benchmark" / "reference"
                                          / "probe_route.py")
    seed = 2**31 + 7
    res = run.run_cell(cell, seed, 1.0, False, torch.device("cpu"))
    assert res["correct"] is True
    assert res["checks"]["corr_extra"][1] == 0.04 and res["checks"]["corr_missing"][1] == 0.015
    pool = int(cell.traffic["pool"])
    sent = set(range(min(res["attempted"], pool)))
    checked = sorted(sent & set(traffic.checked_pairs(seed, cell.traffic)))
    assert checked and sorted(cell.reference.POSES) == checked

    nums, _shown = control.control_numbers(cell, seed, torch.device("cpu"))
    assert set(nums) == {"corr_extra", "corr_missing"}
    assert sorted(cell.reference.CONTROLLED) == sorted(traffic.checked_pairs(seed, cell.traffic))

    changed = [str(p.relative_to(bench_copy)) for p, b in before.items() if p.read_bytes() != b]
    assert changed == ["BENCHMARK.json"]

"""The benchmark's manifest (BENCHMARK.json at the repo root) and the files
it names, each found by its name: a configuration's `file`, the traffic
mix benchmark/traffic/<traffic>.json, a cell's limits
benchmark/limits/<cell>.json and a per-layer metric's reader
benchmark/metrics/<metric>.py (a function `read(ctx)` returning a number or
None)."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    limits: dict  # the cell's limits on the numbers `correct` compares
    end_to_end: list  # the manifest's entries this cell reports
    per_layer: list


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    man = load_manifest(root)
    works = [w for w in man["workloads"] if w["name"] == name]
    if len(works) != 1:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    work = works[0]
    (conf,) = [c for c in man["configs"] if c["name"] == work["config"]]
    return Cell(
        name=name,
        chips=int(work["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((root / "benchmark" / "traffic" / f"{work['traffic']}.json")
                           .read_text()),
        limits=json.loads((root / "benchmark" / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in man["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in man["per_layer"] if _applies(m, name)],
    )


def reader(metric: str, root: Path = ROOT):
    """The `read` function of benchmark/metrics/<metric>.py."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

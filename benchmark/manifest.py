"""The benchmark's manifest (BENCHMARK.json at the repo root) and the files
it names, each found by its name: a configuration's `file`, the reference
module benchmark/reference/<reference>.py that its `reference` key names,
the traffic mix benchmark/traffic/<traffic>.json, a cell's limits
benchmark/limits/<cell>.json and a per-layer metric's reader
benchmark/metrics/<metric>.py (a function `read(ctx)` returning a number or
None).

A reference module reproduces one route of the program and provides
COVERS (the `flagship` settings of that route), Reference(traffic, config)
and control(ref, k); see benchmark/README.md.  load_cell refuses a
configuration that names no module, or whose `flagship` differs from the
module's COVERS, so that no route is judged by another route's reference."""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    limits: dict  # the cell's limits on the numbers `correct` compares
    reference: ModuleType  # the configuration's reference module
    end_to_end: list  # the manifest's entries this cell reports
    per_layer: list


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _module(path: Path, name: str) -> ModuleType:
    """The module at path, loaded anew under name (and registered in
    sys.modules under it, as dataclasses need)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reference_module(config: dict, root: Path = ROOT) -> ModuleType:
    """The module benchmark/reference/<reference>.py that the configuration
    names, once its `flagship` is checked against the module's COVERS."""
    name = config.get("reference")
    if not isinstance(name, str) or not name.isidentifier():
        raise ValueError(f"configuration {config.get('name')!r} names no reference module: "
                         f"reference is {name!r}, not the name of a file in benchmark/reference/")
    mod = _module(root / "benchmark" / "reference" / f"{name}.py", f"benchmark_reference_{name}")
    flagship = config["flagship"]
    wrong = sorted(k for k, v in mod.COVERS.items() if flagship.get(k, "unset") != v)
    if wrong:
        raise ValueError(
            f"configuration {config.get('name')!r} is not on the route reference {name!r} covers: "
            + ", ".join(f"{k} is {flagship.get(k, 'unset')!r}, not {mod.COVERS[k]!r}"
                        for k in wrong))
    return mod


def load_cell(name: str, root: Path = ROOT) -> Cell:
    man = load_manifest(root)
    works = [w for w in man["workloads"] if w["name"] == name]
    if len(works) != 1:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    work = works[0]
    (conf,) = [c for c in man["configs"] if c["name"] == work["config"]]
    config = json.loads((root / conf["file"]).read_text())
    return Cell(
        name=name,
        chips=int(work["chips"]),
        config=config,
        traffic=json.loads((root / "benchmark" / "traffic" / f"{work['traffic']}.json")
                           .read_text()),
        limits=json.loads((root / "benchmark" / "limits" / f"{name}.json").read_text()),
        reference=reference_module(config, root),
        end_to_end=[m for m in man["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in man["per_layer"] if _applies(m, name)],
    )


def reader(metric: str, root: Path = ROOT):
    """The `read` function of benchmark/metrics/<metric>.py."""
    return _module(root / "benchmark" / "metrics" / f"{metric}.py",
                   f"benchmark_metric_{metric}").read

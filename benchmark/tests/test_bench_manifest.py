"""BENCHMARK.json against the benchmark's contract, and every file it names
found by its name."""
import json
import re

import pytest

from benchmark import manifest
from benchmark.reference import feature_scale

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
MAN = manifest.load_manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def test_keys_and_shapes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert {m["name"] for m in MAN["end_to_end"]} == {"pairs_per_s", "pair_s_p95", "setup_s"}
    for m in MAN["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
        assert set(m["workloads"]) <= set(CELLS)


def test_names_and_units():
    names = ([c["name"] for c in MAN["configs"]] + CELLS
             + [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
             + [w["traffic"] for w in MAN["workloads"]] + [w["config"] for w in MAN["workloads"]])
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in MAN["end_to_end"] + MAN["per_layer"])
    assert all(m["better"] in ("lower", "higher") for m in MAN["end_to_end"] + MAN["per_layer"])
    for text in ([c["source"] for c in MAN["configs"]] + [c["why"] for c in MAN["configs"]]
                 + [w["why"] for w in MAN["workloads"]] + [m["layer"] for m in MAN["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_resolve(cell):
    c = manifest.load_cell(cell)
    assert c.config["flagship"] and c.traffic["points_per_side"] > 0
    assert set(c.limits) == {"corr_extra", "corr_missing"}
    assert callable(c.reference.Reference) and callable(c.reference.control)
    assert {"pairs_per_s", "setup_s"} <= {m["name"] for m in c.end_to_end}
    for m in c.per_layer:
        assert callable(manifest.reader(m["name"]))


def test_every_config_has_a_cell():
    assert {c["name"] for c in MAN["configs"]} == {w["config"] for w in MAN["workloads"]}


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        manifest.load_cell("no_such_cell")


@pytest.mark.parametrize("reference, flagship, keys", [
    (None, {}, ["reference"]),
    ("../reference/feature_scale", {}, ["reference"]),
    ("feature_scale", {"pyramid": True}, ["pyramid"]),
    ("feature_scale", {"descriptor": "shot"}, ["descriptor"]),
], ids=["no_reference", "a_path", "pyramid", "shot"])
def test_load_cell_refuses_a_route_its_reference_does_not_cover(bench_copy, reference, flagship,
                                                                 keys):
    path = bench_copy / "benchmark" / "configs" / "iss_fpfh.json"
    conf = json.loads(path.read_text())
    conf.pop("reference")
    if reference is not None:
        conf["reference"] = reference
    conf["flagship"].update(flagship)
    path.write_text(json.dumps(conf))
    with pytest.raises(ValueError) as err:
        manifest.load_cell("iss_fpfh.4m", bench_copy)
    msg = str(err.value)
    for k in ["reference", *feature_scale.COVERS]:
        assert (f"{k} is " in msg) == (k in keys), (k, msg)


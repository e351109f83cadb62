"""Tests of the benchmark harness.  Those that need a CUDA card carry the
`card` marker and skip, inside the `card` fixture, where none is visible;
on the card: python -m pytest benchmark/tests -m card."""
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: this test runs on the H100")
    return torch.device("cuda")


@pytest.fixture
def tiny_cell():
    """A cell of the manifest cut to a CPU test's size: 65,536 points a side
    on the 30 m site, a pool of 2 poses, one profiled pair."""
    from benchmark import manifest

    def make(name="iss_fpfh.4m", root=manifest.ROOT, **traffic):
        cell = manifest.load_cell(name, root)
        cell.traffic.update({**dict(points_per_side=65536, extent_m=30.0, pool=2,
                                    profiled_pairs=1), **traffic})
        return cell

    return make


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of the benchmark as a checkout holds it (BENCHMARK.json and
    benchmark/), in a temporary directory; returns its root."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path

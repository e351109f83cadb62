"""RANSAC rounds a registration: the program's counter solver.rounds over
its counter pairs (lidar_global_registration_tpu_torch/utils/profiling.py),
every registration of the run counted, set-up's too; None where the
program keeps no such counters."""
import sys


def read(ctx):
    prof = sys.modules.get("lidar_global_registration_tpu_torch.utils.profiling")
    counts = prof.snapshot()["counts"] if hasattr(prof, "snapshot") else {}
    if not counts.get("pairs") or "solver.rounds" not in counts:
        return None
    return counts["solver.rounds"] / counts["pairs"]

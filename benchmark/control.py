#!/usr/bin/env python3
"""The control of the check that decides `correct`: the cell's reference
computed in the precision next below the one the configuration states (the
reference module's `control`: for float32 with TF32 off, every matrix
product in TF32) put in the program's place and judged by check.compare
against the reference itself on the cell's own traffic.  It has to come out
not correct; its readings are the upper readings of the cell's limits.

    python3 benchmark/control.py --workload <cell> --seed <n> [--seed <m> ...]

One JSON line per seed: {"seed", "numbers", "shown", "correct"}.  The
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import check, manifest  # noqa: E402
from benchmark import traffic as traffic_mod  # noqa: E402


def control_numbers(cell: manifest.Cell, seed: int, device) -> tuple[dict, dict]:
    """(the compared numbers, the printed ones) of the control for one seed."""
    tr = traffic_mod.build(cell.traffic, seed, device)
    ref = cell.reference.Reference(tr, cell.config)
    raw = {"density_src": ref.ds, "density_tgt": ref.dt}
    checked = []
    for k in traffic_mod.checked_pairs(seed, cell.traffic):
        pp = ref.pose(k)
        corr, T = cell.reference.control(ref, k)
        checked.append(check.Checked(pose=k, src_rows=pp.vox_src[0], tgt_rows=pp.vox_tgt[0],
                                     corr=corr, radii=pp.radii, T=T))
    return check.compare(raw, checked, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("the control runs at the cell's size on a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seed:
        numbers, shown = control_numbers(cell, seed, torch.device("cuda"))
        correct, _table = check.judge(numbers, cell.limits)
        print(json.dumps({"seed": seed, "numbers": numbers, "shown": shown, "correct": correct}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

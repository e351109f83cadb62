"""Sequential benchmark sweep on the PyTorch + CUDA port (tools/bench_sweep.py,
ported): one bench_torch.py process a row, one row at a time.

Runs bench_torch.py across the measurement grid of tools/bench_sweep.py (the
same rows, environments and timeouts): 64k / 256k keypoint-any, 256k-10M
ISS, SHOT, GROR and staged-pyramid rows, each as its own subprocess so a
crash or a timeout loses only that row.  Appends one JSON line a row to
BENCH_SWEEP_TORCH.jsonl and the row's stderr transcript to
BENCH_SWEEP_TORCH.log, both at the repo root.

    python3 tools/bench_sweep_torch.py [row ...]

Rows default to DEFAULT; pass names (e.g. `iss1m shot256k`) to subset.
Needs the card bench_torch.py needs; no row is retried.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench_torch.py")
OUT_JSONL = os.path.join(ROOT, "BENCH_SWEEP_TORCH.jsonl")
OUT_LOG = os.path.join(ROOT, "BENCH_SWEEP_TORCH.log")

ROWS = {
    # name: (env overrides, timeout seconds)
    "any64k": ({"LGR_BENCH_N": "65536", "LGR_BENCH_REPEATS": "5"}, 3600),
    "any256k": ({"LGR_BENCH_N": "262144", "LGR_BENCH_REPEATS": "3"}, 3600),
    "iss256k": ({"LGR_BENCH_N": "262144", "LGR_BENCH_REPEATS": "3",
                 "LGR_BENCH_ISS": "1"}, 3600),
    "iss1m": ({"LGR_BENCH_N": "1048576", "LGR_BENCH_REPEATS": "3",
               "LGR_BENCH_ISS": "1"}, 5400),
    "iss4m": ({"LGR_BENCH_N": "4194304", "LGR_BENCH_REPEATS": "3",
               "LGR_BENCH_ISS": "1"}, 7200),
    "iss10m": ({"LGR_BENCH_N": "10485760", "LGR_BENCH_REPEATS": "2",
                "LGR_BENCH_ISS": "1"}, 18000),
    "shot256k": ({"LGR_BENCH_N": "262144", "LGR_BENCH_REPEATS": "3",
                  "LGR_BENCH_ISS": "1", "LGR_BENCH_DESC": "shot"}, 5400),
    "shot1m": ({"LGR_BENCH_N": "1048576", "LGR_BENCH_REPEATS": "3",
                "LGR_BENCH_ISS": "1", "LGR_BENCH_DESC": "shot"}, 7200),
    "shot4m": ({"LGR_BENCH_N": "4194304", "LGR_BENCH_REPEATS": "3",
                "LGR_BENCH_ISS": "1", "LGR_BENCH_DESC": "shot"}, 7200),
    "shot10m": ({"LGR_BENCH_N": "10485760", "LGR_BENCH_REPEATS": "2",
                 "LGR_BENCH_ISS": "1", "LGR_BENCH_DESC": "shot"}, 18000),
    "gror256k": ({"LGR_BENCH_N": "262144", "LGR_BENCH_REPEATS": "3",
                  "LGR_BENCH_ISS": "1", "LGR_BENCH_ALIGN": "gror"}, 5400),
    "gror1m": ({"LGR_BENCH_N": "1048576", "LGR_BENCH_REPEATS": "3",
                "LGR_BENCH_ISS": "1", "LGR_BENCH_ALIGN": "gror"}, 5400),
    "gror4m": ({"LGR_BENCH_N": "4194304", "LGR_BENCH_REPEATS": "3",
                "LGR_BENCH_ISS": "1", "LGR_BENCH_ALIGN": "gror"}, 7200),
    "gror10m": ({"LGR_BENCH_N": "10485760", "LGR_BENCH_REPEATS": "2",
                 "LGR_BENCH_ISS": "1", "LGR_BENCH_ALIGN": "gror"}, 18000),
    # the staged pyramid on the range-graded scene (per-keypoint radii span
    # several octaves); pyramid + SHOT + cluster is the reference's default
    "pyr1m": ({"LGR_BENCH_N": "1048576", "LGR_BENCH_REPEATS": "3",
               "LGR_BENCH_ISS": "1", "LGR_BENCH_DESC": "shot",
               "LGR_BENCH_PYRAMID": "1", "LGR_BENCH_GRADED": "1"}, 7200),
    "pyr1m_fpfh": ({"LGR_BENCH_N": "1048576", "LGR_BENCH_REPEATS": "3",
                    "LGR_BENCH_ISS": "1", "LGR_BENCH_PYRAMID": "1",
                    "LGR_BENCH_GRADED": "1"}, 7200),
    "pyr4m": ({"LGR_BENCH_N": "4194304", "LGR_BENCH_REPEATS": "3",
               "LGR_BENCH_ISS": "1", "LGR_BENCH_DESC": "shot",
               "LGR_BENCH_PYRAMID": "1", "LGR_BENCH_GRADED": "1"}, 10800),
    "pyr10m": ({"LGR_BENCH_N": "10485760", "LGR_BENCH_REPEATS": "2",
                "LGR_BENCH_ISS": "1", "LGR_BENCH_DESC": "shot",
                "LGR_BENCH_PYRAMID": "1", "LGR_BENCH_GRADED": "1"}, 18000),
    "pyr4m_fpfh": ({"LGR_BENCH_N": "4194304", "LGR_BENCH_REPEATS": "3",
                    "LGR_BENCH_ISS": "1", "LGR_BENCH_PYRAMID": "1",
                    "LGR_BENCH_GRADED": "1"}, 10800),
    # per-stage times (LGR_STAGE_TIMING synchronises between stages: the
    # stage lines over-count a repeat; never quote them as end to end)
    "prof1m": ({"LGR_BENCH_N": "1048576", "LGR_BENCH_REPEATS": "1",
                "LGR_BENCH_ISS": "1", "LGR_STAGE_TIMING": "1"}, 5400),
    "prof10m": ({"LGR_BENCH_N": "10485760", "LGR_BENCH_REPEATS": "1",
                 "LGR_BENCH_ISS": "1", "LGR_STAGE_TIMING": "1"}, 10800),
}
DEFAULT = ["any64k", "iss256k", "iss1m", "iss4m", "iss10m", "shot256k",
           "shot1m", "any256k"]


def main(names):
    unknown = [n for n in names if n not in ROWS]
    if unknown:
        raise SystemExit(f"unknown rows {unknown}; rows: {' '.join(ROWS)}")
    for name in names:
        env_over, tmo = ROWS[name]
        env = dict(os.environ)
        env.update(env_over)
        t0 = time.time()
        print(f"== {name} start {time.strftime('%H:%M:%S')}", flush=True)
        try:
            p = subprocess.run([sys.executable, BENCH], env=env, capture_output=True,
                               text=True, timeout=tmo)
            rc, out, err = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as e:
            rc, out = -9, ""
            err = (e.stderr.decode() if isinstance(e.stderr, bytes) else e.stderr or "")
            err += f"\n== TIMEOUT {tmo}s"
        dt = time.time() - t0
        with open(OUT_LOG, "a") as f:
            f.write(f"\n==== {name} rc={rc} wall={dt:.0f}s ====\n{err}\n{out}\n")
        row = {"row": name, "rc": rc, "wall_s": round(dt, 1)}
        for line in out.splitlines():
            line = line.strip()
            if line.startswith("{"):
                try:
                    row["result"] = json.loads(line)
                except ValueError:
                    pass
        with open(OUT_JSONL, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(f"== {name} done rc={rc} {dt:.0f}s: {row.get('result')}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or DEFAULT)

"""Run a cell several times, one process a run, and summarize the spread.

    python3 mdbench/sets.py --workload <cell> --seeds 11,12,13 \
        --seconds 10 [--trace 1] [--out <file>.jsonl]

Each run is ``mdbench/run.py`` as the benchmark's command runs it, one
after the other. Every run's result line, exit code and wall seconds go
to ``--out`` (JSON lines); standard output ends with each metric's median
and its spread: the distance between the first and third quartile of
``statistics.quantiles(values, n=4)`` as a share of the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values):
    """(median, interquartile distance over the median)."""
    med = statistics.median(values)
    if len(values) < 2:
        return med, None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / abs(med) if med else None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows = []
    for seed in args.seeds.split(","):
        cmd = [sys.executable, str(ROOT / "mdbench" / "run.py"),
               "--workload", args.workload, "--seed", seed, "--seconds",
               str(args.seconds), "--trace", str(args.trace)]
        t0 = time.time()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
        wall = time.time() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        row = {"workload": args.workload, "seed": int(seed),
               "trace": args.trace, "rc": proc.returncode, "wall_s": wall,
               "result": result, "stderr": proc.stderr[-3000:],
               "host": [ln for ln in proc.stderr.splitlines()
                        if "window host:" in ln]}
        rows.append(row)
        print(json.dumps({k: row[k] for k in ("seed", "rc", "wall_s")}
                         | {"correct": (result or {}).get("correct"),
                            "metrics": {k: v["value"] for k, v in
                                        (result or {}).get("metrics",
                                                           {}).items()}}),
              flush=True)
        if result is None:
            print(proc.stderr[-3000:], flush=True)
        if args.out:
            with open(ROOT / args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    values = {}
    for row in rows:
        for k, v in ((row["result"] or {}).get("metrics") or {}).items():
            values.setdefault(k, []).append(v["value"])
    for k, vals in values.items():
        med, spr = spread(vals)
        print(f"{args.workload} {k}: median {med!r}, spread {spr!r}, "
              f"n {len(vals)}", flush=True)


if __name__ == "__main__":
    main()

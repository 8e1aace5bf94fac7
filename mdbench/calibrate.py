"""Readings that a cell's limits are set from, in one process on the card.

    python3 mdbench/calibrate.py --workload <cell> --seeds 1,2,...,12 \
        --control-seeds 21,22,23 [--faults half_batch,altered] \
        [--seconds 2] [--out <file>.jsonl] \
        [--set 'compute_dtype="float32"' --no-tf32]

For each seed, one run of the cell (set-up, a short window at the cell's
load, the comparison) gives the program's numbers; each control seed gives
the control's: the reference computed at fp8 in the program's place; each
fault, planted in the program (``faults.py``), gives its numbers on the
control seeds. ``--set`` and ``--no-tf32`` make a witness: the program
at another setting of the configuration. Standard output ends with,
for each number, the largest
reading of the program (the lower reading), the smallest of the control
and of each fault, and their ratios.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mdbench import faults, harness  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--set", action="append", default=[],
                    help="key=json: a config field changed for every run "
                         "(a witness, e.g. compute_dtype=\"float32\")")
    ap.add_argument("--no-tf32", action="store_true",
                    help="TF32 off in the program's process (a float32 "
                         "witness)")
    args = ap.parse_args(argv)
    over = {"config": {k: json.loads(v) for k, v in
                       (kv.split("=", 1) for kv in args.set)}}
    import torch
    if args.no_tf32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    bench = harness.manifest()
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    with open(harness.HERE / "traffic" / f"{cell['traffic']}.json") as f:
        kind = json.load(f)["loop"]
    plant = faults.train_fault if kind == "train" else faults.infer_fault
    jobs = [("program", int(s), None) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    jobs += [("control", s, None) for s in controls]
    for fault in filter(None, args.faults.split(",")):
        jobs += [(fault, s, fault) for s in controls]
    readings = {}
    for what, seed, fault in jobs:
        t0 = time.time()
        if fault:
            with plant(fault):
                result, _ = harness.run_cell(args.workload, seed,
                                             args.seconds, False,
                                             overrides=over)
        else:
            result, _ = harness.run_cell(args.workload, seed, args.seconds,
                                         False, overrides=over,
                                         control=what == "control")
        numbers = {k: v["value"] for k, v in result["checks"].items()}
        row = {"workload": args.workload, "what": what, "seed": seed,
               "set": args.set + (["no_tf32"] if args.no_tf32 else []),
               "numbers": numbers, "correct": result["correct"],
               "seconds": time.time() - t0,
               "metrics": {k: v["value"] for k, v in
                           result["metrics"].items()}}
        print(json.dumps(row), flush=True)
        if args.out:
            with open(ROOT / args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        for k, v in numbers.items():
            readings.setdefault(what, {}).setdefault(k, []).append(v)
        torch.cuda.empty_cache()
    lower = {k: max(v) for k, v in readings.get("program", {}).items()}
    for what, nums in readings.items():
        for k, v in nums.items():
            worst = max(v) if what == "program" else min(v)
            ratio = worst / lower[k] if lower.get(k) else None
            print(f"{args.workload} {what} {k}: "
                  f"{'max' if what == 'program' else 'min'} {worst!r} "
                  f"over {len(v)} seeds; / program max {ratio!r}",
                  flush=True)


if __name__ == "__main__":
    main()

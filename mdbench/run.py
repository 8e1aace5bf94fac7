"""Run one cell of the benchmark on the card and print its result's line.

    python3 mdbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, when traced,
``breakdown``; its last key, ``checks``, holds each number compared with
the reference beside its limit, and the same lines end standard error.
Without a card, or with fewer cards than the cell asks for, the run exits
with code 2 and prints no result; if JAX or the JAX package was loaded,
with code 3.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mdbench import harness  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    bench = harness.manifest()
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        sys.exit(f"unknown workload {args.workload!r}")
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < int(cell["chips"]):
        print(f"[mdbench] needs {cell['chips']} CUDA device(s); found "
              f"{found}; no result", file=sys.stderr)
        sys.exit(2)
    result, bad = harness.run_cell(args.workload, args.seed, args.seconds,
                                   bool(args.trace), "cuda", started=STARTED)
    if bad:
        print(f"[mdbench] modules of JAX or the JAX package were loaded: "
              f"{', '.join(bad)}; no result", file=sys.stderr)
        sys.exit(3)
    print(f"[mdbench] card: {harness.card_report()}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    print("\n".join(harness.check_lines(result["checks"])), file=sys.stderr,
          flush=True)


if __name__ == "__main__":
    main()

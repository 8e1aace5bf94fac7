"""GT export entry point of the port (port of movedepth_tpu/cli/export_gt.py;
reference: movedepth/export_gt_depth.py).

  python -m movedepth_tpu_torch.cli.export_gt --data_path /kitti_raw \\
      --split eigen [--splits_dir /path/to/splits]

With ``--splits_dir`` the split's ``test_files.txt`` is read from, and
``gt_depths.npz`` written to, ``<splits_dir>/<split>/``. Without it the
list is found as ``data/splits.py`` says (the port's own splits, then the
bundled lists) and the GT goes to the port's own
``movedepth_tpu_torch/splits/<split>/gt_depths.npz``, where the evaluator
looks first; nothing is written under the JAX package.
"""

from __future__ import annotations

import argparse
import os

from movedepth_tpu_torch.data import splits
from movedepth_tpu_torch.eval.export_gt import export_gt_depths


def main(argv=None):
    parser = argparse.ArgumentParser(description="export GT depths "
                                                 "(PyTorch port)")
    parser.add_argument("--data_path", type=str, required=True)
    parser.add_argument("--splits_dir", type=str, default=None,
                        help="directory containing <split>/test_files.txt; "
                             "the GT is written there too")
    parser.add_argument("--split", type=str, required=True,
                        choices=["eigen", "eigen_benchmark"])
    args = parser.parse_args(argv)
    if args.splits_dir:
        split_dir = os.path.join(args.splits_dir, args.split)
        out = os.path.join(split_dir, "gt_depths.npz")
    else:
        split_dir = None
        out = str(splits.PORT_SPLITS / args.split / "gt_depths.npz")
    out = export_gt_depths(args.data_path, args.split, out, split_dir)
    print(f"saved {out}")
    return out


if __name__ == "__main__":
    main()

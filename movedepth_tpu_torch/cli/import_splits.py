"""Import KITTI split lists into the port (port of
movedepth_tpu/cli/import_splits.py).

The train/val/test split lists (eigen_zhou: 39,810 train / 4,424 val;
eigen: 697 test; plus eigen_full / eigen_benchmark / benchmark / odom) are
public dataset metadata distributed with monodepth2-lineage repos. Import
them once from any checkout:

  python -m movedepth_tpu_torch.cli.import_splits /path/to/movedepth/splits

which copies ``<split>/{train,val,test,all}_files.txt`` (and any
``gt_depths.npz`` or ``eigen_to_benchmark_ids.npy``) into
``movedepth_tpu_torch/splits/`` (or ``--dst``), where the port's trainer
and evaluator look before the lists bundled with the checkout.
"""

from __future__ import annotations

import argparse
import os
import shutil

from movedepth_tpu_torch.data import splits

WANTED = ("train_files.txt", "val_files.txt", "test_files.txt",
          "all_files.txt", "gt_depths.npz", "eigen_to_benchmark_ids.npy")


def import_splits(src_dir: str, dst_dir: str) -> int:
    """Copy the WANTED files of every split under ``src_dir`` into
    ``dst_dir/<split>/``; returns the number of files copied."""
    copied = 0
    for split in sorted(os.listdir(src_dir)):
        sdir = os.path.join(src_dir, split)
        if not os.path.isdir(sdir):
            continue
        ddir = os.path.join(dst_dir, split)
        os.makedirs(ddir, exist_ok=True)
        for name in WANTED:
            src = os.path.join(sdir, name)
            if os.path.isfile(src):
                shutil.copy2(src, os.path.join(ddir, name))
                copied += 1
    return copied


def main(argv=None):
    parser = argparse.ArgumentParser(description="import KITTI split lists "
                                                 "(PyTorch port)")
    parser.add_argument("src", help="source splits dir (reference checkout)")
    parser.add_argument("--dst", default=str(splits.PORT_SPLITS))
    args = parser.parse_args(argv)
    n = import_splits(args.src, os.path.abspath(args.dst))
    print(f"imported {n} split files into {os.path.abspath(args.dst)}")
    return n


if __name__ == "__main__":
    main()

"""Evaluation entry point of the port (port of
movedepth_tpu/cli/evaluate.py; reference launch: test_movedepth.sh).

  python -m movedepth_tpu_torch.cli.evaluate --data_path /path/to/kitti_raw \\
      --load_weights_folder log/exp/mdp/models/last \\
      --eval_split eigen --png [--splits_dir /path/to/splits] [--device cuda]

Every Config field is a flag, as in the JAX package's CLI. The split's
``test_files.txt`` and ``gt_depths.npz`` come from ``--splits_dir/<split>``
when it is given, else from the port's ``movedepth_tpu_torch/splits/``
(``cli.import_splits``, ``cli.export_gt``), else from the split lists
bundled with the checkout (``data/splits.py``); ``--gt_path`` names the
GT file directly. ``--load_weights_folder`` is a reference folder of
per-model ``.pth`` files or a checkpoint folder of the port's trainer
(its ``adam.pth`` is not read). An Orbax checkpoint of the JAX package is
refused with a pointer to its converter, which runs where JAX is
installed: ``python scripts/orbax_to_pth.py <orbax dir> <out dir>``, then
``--load_weights_folder <out dir>``. ``--device`` (default ``cuda``)
picks the device; without a card the default raises. The CLI prints the four metric tables and then one
line with the warp-correlate kernel's launches in this evaluation (0 on
the CPU, where its plain version runs).
"""

from __future__ import annotations

import argparse
import json
import os

from movedepth_tpu_torch import trace
from movedepth_tpu_torch.cli.infer import load_models
from movedepth_tpu_torch.cli.options import add_config_args, config_from_args
from movedepth_tpu_torch.eval.evaluate import check_device, evaluate


def main(argv=None):
    parser = argparse.ArgumentParser(description="MoveDepth evaluation "
                                                 "(PyTorch port)")
    add_config_args(parser)
    parser.add_argument("--splits_dir", type=str, default=None,
                        help="directory containing <eval_split>/"
                             "test_files.txt (default: the port's "
                             "splits, then the bundled lists)")
    parser.add_argument("--gt_path", type=str, default=None)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default cuda)")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)

    split_dir = (os.path.join(args.splits_dir, cfg.eval_split)
                 if args.splits_dir else None)
    models = load_models(cfg, check_device(args.device))
    before = trace.counter("launch.sweep_warp_corr")
    results = evaluate(models, cfg, cfg.data_path, split_dir,
                       gt_path=args.gt_path, batch_size=cfg.batch_size,
                       limit=args.limit, device=args.device,
                       num_workers=cfg.num_workers)
    print("kernel launches: " + json.dumps(
        {"sweep_warp_corr": trace.counter("launch.sweep_warp_corr")
         - before}), flush=True)
    return results


if __name__ == "__main__":
    main()

"""Training entry point of the port (port of movedepth_tpu/cli/train.py).

  python -m movedepth_tpu_torch.cli.train --data_path /path/to/kitti_raw \\
      --log_dir log/exp --model_name mdp --split eigen_zhou --png \\
      --splits_dir /path/to/splits [--kernel_l1] [--device cuda]

Every Config field is a flag, as in the JAX package's CLI. ``--device``
(default ``cuda``) picks the device; ``cpu`` trains on the CPU with the
kernels' plain versions. One process trains on one device: ``--multichip``
with more than one card is refused (distributed training is ROADMAP Queue 1
item 17). ``--profile_steps N`` writes a ``torch.profiler`` trace of steps
[2, 2+N) to ``<log_dir>/<model_name>/profile/trace.json``. At the end the
CLI prints one line with the kernel launches of the run.
"""

from __future__ import annotations

import argparse
import json

import torch

from movedepth_tpu_torch.cli.options import add_config_args, config_from_args
from movedepth_tpu_torch.ops import image_warp, sweep_warp
from movedepth_tpu_torch.train.trainer import Trainer


def kernel_launches() -> dict:
    """The CUDA kernel launches of this process so far, by kernel."""
    return {"sweep_warp": sweep_warp.warp_launches,
            "sweep_warp_bwd": sweep_warp.warp_bwd_launches,
            "warp_images_border": image_warp.launches,
            "warp_images_border_coord_bwd": image_warp.bwd_launches,
            "warp_images_border_l1": image_warp.l1_launches,
            "warp_images_border_l1_coord_bwd": image_warp.l1_bwd_launches}


def main(argv=None):
    parser = argparse.ArgumentParser(description="MoveDepth training "
                                                 "(PyTorch port)")
    add_config_args(parser)
    parser.add_argument("--splits_dir", type=str, default=None,
                        help="directory containing <split>/train_files.txt")
    parser.add_argument("--multichip", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="accepted for the JAX CLI's sake; more than "
                             "one card is refused (no DDP yet)")
    parser.add_argument("--profile_steps", type=int, default=0,
                        help="write a torch.profiler trace of N early steps")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default cuda)")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    if (args.multichip and args.device.startswith("cuda")
            and torch.cuda.device_count() > 1):
        raise SystemExit(
            f"{torch.cuda.device_count()} CUDA devices: multi-card training "
            "(DDP) is not ported yet (ROADMAP Queue 1 item 17); pass "
            "--no-multichip to train on one card")
    split_dir = (f"{args.splits_dir}/{cfg.split}" if args.splits_dir
                 else None)
    trainer = Trainer(cfg, split_dir=split_dir, device=args.device,
                      profile_steps=args.profile_steps)
    trainer.train()
    print("kernel launches: " + json.dumps(kernel_launches()), flush=True)
    return trainer


if __name__ == "__main__":
    main()

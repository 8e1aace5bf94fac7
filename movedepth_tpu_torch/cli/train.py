"""Training entry point of the port (port of movedepth_tpu/cli/train.py).

  python -m movedepth_tpu_torch.cli.train --data_path /path/to/kitti_raw \\
      --log_dir log/exp --model_name mdp --split eigen_zhou --png \\
      --splits_dir /path/to/splits [--kernel_l1] [--device cuda]

Every Config field is a flag, as in the JAX package's CLI. ``--device``
(default ``cuda``) picks the device; ``cpu`` trains on the CPU with the
kernels' plain versions. Data-parallel training on N cards runs one
process per card:

  torchrun --nproc_per_node N -m movedepth_tpu_torch.cli.train ...

Under torchrun (``WORLD_SIZE`` set) each process joins the process group
(``nccl`` on cards, ``gloo`` with ``--device cpu``), trains on
``cuda:LOCAL_RANK`` and prints ``dist: backend <b>, rank <r> of <w>,
device <d>``; ``--batch_size`` is per process. Without torchrun one
process trains on one device, and ``--multichip`` with more than one card
is refused. ``--profile_steps N`` writes a ``torch.profiler`` trace of
rank 0's steps [2, 2+N) to ``<log_dir>/<model_name>/profile/trace.json``
and turns the port's tracer (``movedepth_tpu_torch/trace.py``) on for the
same steps: beside the trace, ``spans.json`` holds per span (``train.step``,
``train.forward``, ``train.losses``, ``train.backward``,
``train.optimizer``, ``trainer.data_wait``, ``trainer.put``,
``trainer.log``, ``trainer.validate``, ...) its calls, host ms mean and
max, self host ms and device ms mean, and how much each counter grew
(kernel launches, ``h2d_bytes``); the ten spans with the most self time
are printed. In the trace each span is a ``movedepth.<name>`` range. At
the end each process prints one line with its kernel launches.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from movedepth_tpu_torch.cli.options import add_config_args, config_from_args
from movedepth_tpu_torch.ops import kernel_launches
from movedepth_tpu_torch.parallel import dist as D
from movedepth_tpu_torch.train.trainer import Trainer


def main(argv=None):
    parser = argparse.ArgumentParser(description="MoveDepth training "
                                                 "(PyTorch port)")
    add_config_args(parser)
    parser.add_argument("--splits_dir", type=str, default=None,
                        help="directory containing <split>/train_files.txt")
    parser.add_argument("--multichip", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="train on every card: launch one process per "
                             "card with torchrun (--batch_size is per "
                             "process); without torchrun, more than one "
                             "visible card is refused unless "
                             "--no-multichip")
    parser.add_argument("--profile_steps", type=int, default=0,
                        help="write a torch.profiler trace and the "
                             "tracer's spans.json of N early steps")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default cuda)")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    split_dir = (f"{args.splits_dir}/{cfg.split}" if args.splits_dir
                 else None)
    rank, world, device, group = 0, 1, args.device, None
    if "WORLD_SIZE" in os.environ:  # under torchrun
        rank, world, device = D.initialize_distributed(args.device)
        group = D.default_group()
        print(f"dist: backend {torch.distributed.get_backend(group)}, rank "
              f"{rank} of {world}, device {device}", flush=True)
    elif (args.multichip and args.device.startswith("cuda")
            and torch.cuda.device_count() > 1):
        cards = torch.cuda.device_count()
        raise SystemExit(
            f"{cards} CUDA devices: train on all of them with one process "
            f"per card, `torchrun --nproc_per_node {cards} -m "
            "movedepth_tpu_torch.cli.train ...`, or on one card with "
            "--no-multichip")
    trainer = Trainer(cfg, split_dir=split_dir, device=device,
                      profile_steps=args.profile_steps, rank=rank,
                      world_size=world, group=group)
    trainer.train()
    print("kernel launches: " + json.dumps(kernel_launches()), flush=True)
    if group is not None:
        torch.distributed.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()

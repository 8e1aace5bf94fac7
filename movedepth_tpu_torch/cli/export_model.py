"""Export the serving forward as a ``torch.export`` program (port of
movedepth_tpu/cli/export_model.py).

Writes the full MVS forward (``pipeline.forward_infer``), or the mono one
with ``--mono``, at a fixed batch and the config's size, with the weights
of a reference ``.pth`` folder baked in as the program's parameters and
buffers (``torch.export.save``). The program is tied to the device it was
exported on (``--device``, the card unless the caller asks for the CPU);
with ``compute_dtype`` bfloat16 on the card its autocast regions are part
of the program. It calls the port's kernels as the ``torch.library`` ops
``movedepth::...``, so unlike the JAX package's StableHLO artifact it is
not free of the port's code: the loading process imports
``movedepth_tpu_torch.ops`` first, which registers them:

  import torch
  import movedepth_tpu_torch.ops  # registers the movedepth:: ops
  prog = torch.export.load("movedepth.pt2").module()
  with torch.no_grad():  # the baked-in weights are parameters
      out = prog(color, K, inv_K)  # (disp_mono, disp_mvs, depth_mvs);
                                   # mono: (disp_mono, depth_mono)

``color`` is (B, F, H, W, 3) float32 (F = len(matching_ids), 1 with
``--mono``), ``K`` and ``inv_K`` (B, 4, 4) float32, on the export's device;
each output is (B, H, W) float32.

Usage:
  python -m movedepth_tpu_torch.cli.export_model \\
      --load_weights_folder log/exp/models/last \\
      --out movedepth.pt2 [--mono] [--batch 1] [--device cuda] [--check]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from movedepth_tpu_torch import pipeline as P
from movedepth_tpu_torch.cli.infer import _normalized_kitti_K, load_models
from movedepth_tpu_torch.cli.options import add_config_args, config_from_args
from movedepth_tpu_torch.config import Config
from movedepth_tpu_torch.eval.evaluate import check_device


# the program's outputs, in the JAX export's order: MVS, then mono
OUTPUTS = {False: ("disp_mono", "disp_mvs", "depth_mvs"),
           True: ("disp_mono", "depth_mono")}


class ServingForward(torch.nn.Module):
    """``forward(color, K, inv_K)``: the outputs ``OUTPUTS[mono]`` of
    ``forward_infer`` (or ``forward_mono_infer``), as a tuple."""

    def __init__(self, models, cfg: Config, mono: bool):
        super().__init__()
        self.models = torch.nn.ModuleDict(models)
        self.cfg, self.mono = cfg, mono

    def forward(self, color, K, inv_K):
        batch = {"color": color, "K": K, "inv_K": inv_K}
        fn = P.forward_mono_infer if self.mono else P.forward_infer
        out = fn(self.models, batch, self.cfg)
        return tuple(out[k] for k in OUTPUTS[self.mono])


def example_inputs(cfg: Config, mono: bool, batch: int, device, seed=0):
    """(color, K, inv_K) as the JAX CLI's ``--check`` makes them: colors
    uniform in [0, 1) from ``np.random.default_rng(seed)``, the normalized
    KITTI K at the config's size, its float32 inverse."""
    h, w = cfg.height, cfg.width
    nf = 1 if mono else len(cfg.matching_ids)
    rng = np.random.default_rng(seed)
    color = rng.uniform(0, 1, (batch, nf, h, w, 3)).astype(np.float32)
    K = np.tile(_normalized_kitti_K(h, w), (batch, 1, 1))
    inv_K = np.linalg.inv(K).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (color, K, inv_K))


def build_export(cfg: Config, models, mono: bool, batch: int, device):
    """The ``torch.export.ExportedProgram`` of the serving forward on
    ``device`` at batch ``batch`` (non-strict export under no_grad; the
    models in eval mode), without example inputs. Inputs: color (batch,
    F, H, W, 3), K and inv_K (batch, 4, 4), float32."""
    if cfg.load_pose:
        raise ValueError("the export takes (color, K, inv_K): its poses come "
                         "from PoseNet, not load_pose")
    device = torch.device(device)
    module = ServingForward(models, cfg, mono).to(device).eval()
    with torch.no_grad():
        program = torch.export.export(
            module, example_inputs(cfg, mono, batch, device), strict=False)
    # the program would carry the tracing inputs into its file (377 MB at
    # batch 128); its input specs keep the shapes
    program.example_inputs = None
    return program


def main(argv=None):
    parser = argparse.ArgumentParser(description="MoveDepth export "
                                                 "(PyTorch port)")
    add_config_args(parser)
    parser.add_argument("--out", type=str, default="movedepth.pt2")
    parser.add_argument("--mono", action="store_true")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the program runs on (default "
                             "cuda)")
    parser.add_argument("--check", action="store_true",
                        help="load the program and run it once on random "
                             "input")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    device = check_device(args.device)

    models = load_models(cfg, device)
    program = build_export(cfg, models, args.mono, args.batch, device)
    torch.export.save(program, args.out)
    print(f"wrote {args.out}: {os.path.getsize(args.out) / 1e6:.1f} MB, "
          f"device={device}", flush=True)

    if args.check:
        loaded = torch.export.load(args.out).module()
        with torch.no_grad():
            out = loaded(*example_inputs(cfg, args.mono, args.batch, device))
        shapes = [tuple(o.shape) for o in out]
        print(f"roundtrip ok: outputs {shapes}", flush=True)


if __name__ == "__main__":
    main()

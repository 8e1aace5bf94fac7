"""Training observability of the port (a copy of
``movedepth_tpu/train/logging.py``): tensorboard scalars and image panels,
the terminal line with examples/s and ETA, written by rank 0 alone (any
other data-parallel rank opens no writer and prints nothing). Without
tensorboardX the scalars go to
``<log>/metrics.jsonl``. Tensors are read with ``.detach().float().cpu()``.
Disparity panels use the port's own plasma table (``ops/colormap.py``), so
no matplotlib is needed.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np

from movedepth_tpu_torch.ops.colormap import colormap


def _host(x) -> np.ndarray:
    """A tensor (or array) as a float32 numpy array on the host."""
    if hasattr(x, "detach"):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def sec_to_hm_str(t: float) -> str:
    t = int(t)
    s, t = t % 60, t // 60
    m, h = t % 60, t // 60
    return f"{h:02d}h{m:02d}m{s:02d}s"


class MetricsLogger:
    """Tensorboard (train/val writers) + terminal logger, rank 0 only."""

    def __init__(self, log_path: str, rank: int = 0, batch_size: int = 12,
                 num_total_steps: int = 1):
        self.rank = rank
        self.batch_size = batch_size
        self.num_total_steps = max(1, num_total_steps)
        self.start_time = time.time()
        self.writers: Dict[str, object] = {}
        self._jsonl = None
        if rank != 0:
            return
        os.makedirs(log_path, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter

            for mode in ("train", "val"):
                self.writers[mode] = SummaryWriter(
                    os.path.join(log_path, mode))
        except ImportError:
            self._jsonl = open(os.path.join(log_path, "metrics.jsonl"), "a")

    def log_time(self, epoch: int, batch_idx: int, step: int,
                 duration: float, loss: float):
        """examples/s and the time left."""
        if self.rank != 0:
            return
        sps = self.batch_size / max(duration, 1e-9)
        elapsed = time.time() - self.start_time
        left = ((self.num_total_steps / max(step, 1) - 1.0) * elapsed
                if step > 0 else 0)
        print(f"epoch {epoch:>3} | batch {batch_idx:>6} | "
              f"examples/s: {sps:5.1f} | loss: {loss:.5f} | "
              f"time elapsed: {sec_to_hm_str(elapsed)} | "
              f"time left: {sec_to_hm_str(left)}", flush=True)

    def log_scalars(self, mode: str, losses: Dict, step: int):
        scalars = {k: float(v) for k, v in losses.items()
                   if np.ndim(v) == 0}
        if mode in self.writers:
            for k, v in scalars.items():
                self.writers[mode].add_scalar(k, v, step)
        elif self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {"mode": mode, "step": step, **scalars}) + "\n")
            self._jsonl.flush()

    def log_images(self, mode: str, batch, outputs, step: int,
                   max_images: int = 4):
        """Input frames, warped predictions, mono and MVS disparity
        panels."""
        if mode not in self.writers:
            return
        w = self.writers[mode]
        color = _host(batch["color"])
        n = min(max_images, color.shape[0])
        warped = {f: _host(img) for f, img in outputs.get("warped",
                                                          {}).items()}
        disp = _host(outputs["disp_0"])
        depth_mvs = _host(outputs["depth_mvs"])
        for j in range(n):
            for fi in range(color.shape[1]):
                w.add_image(f"color_{fi}_0/{j}",
                            color[j, fi].transpose(2, 0, 1), step)
            for f, img in warped.items():
                w.add_image(f"color_pred_{f}_0/{j}",
                            img[j].transpose(2, 0, 1), step)
            w.add_image(f"disp_mono/{j}", colormap(disp[j]), step)
            w.add_image(f"disp_mvs/{j}", colormap(1.0 / depth_mvs[j]), step)

    def close(self):
        for w in self.writers.values():
            w.close()
        if self._jsonl is not None:
            self._jsonl.close()

"""Modulated deformable convolution (DCNv2) in plain PyTorch (port of
movedepth_tpu/ops/deform.py).

The JAX function is plain JAX, not a Pallas kernel: each of the K*K
deformed taps is a bilinear sample and one contraction over (tap, channel)
follows. Here the K*K taps are one ``F.grid_sample`` (zeros padding,
``align_corners=True``, the JAX ``_sample_one(..., "zeros", True)`` rule)
over a grid stacked along the rows, and the contraction one ``einsum``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def deform_conv2d(x, offsets, modulation, weight, bias=None, kernel_size=3):
    """Modulated deformable conv, stride 1, 'same' padding, NCHW.

    x:          (B, Cin, H, W)
    offsets:    (B, 2*K*K, H, W), channel 2t the row (dy) and 2t+1 the
                column (dx) displacement of tap t = i*K + j
    modulation: (B, K*K, H, W) per-tap gates (None for DCNv1)
    weight:     (Cout, Cin, K, K), torch's conv layout
    Returns (B, Cout, H, W). The sampling grid and the taps are float32
    whatever the input's type; outside autocast so is the weight (a
    bfloat16-stored one is cast here), under it ``einsum`` takes
    autocast's type.
    """
    b, cin, h, w = x.shape
    k = kernel_size
    pad = (k - 1) // 2
    dev = x.device
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    tap = torch.arange(k * k, device=dev)
    dy = (tap // k - pad).to(torch.float32)[:, None, None]  # (KK, 1, 1)
    dx = (tap % k - pad).to(torch.float32)[:, None, None]
    off = offsets.float().view(b, k * k, 2, h, w)
    sy = ys + dy + off[:, :, 0]  # (B, KK, H, W)
    sx = xs + dx + off[:, :, 1]
    grid = torch.stack([sx / (w - 1) * 2.0 - 1.0,
                        sy / (h - 1) * 2.0 - 1.0], dim=-1)
    taps = F.grid_sample(x.float(), grid.view(b, k * k * h, w, 2),
                         mode="bilinear", padding_mode="zeros",
                         align_corners=True).view(b, cin, k * k, h, w)
    if modulation is not None:
        taps = taps * modulation.float()[:, None]
    wk = weight.reshape(weight.shape[0], cin, k * k)
    if not torch.is_autocast_enabled(dev.type):  # autocast casts it itself
        wk = wk.float()
    out = torch.einsum("bcthw,oct->bohw", taps, wk)
    if bias is not None:
        out = out + bias.view(1, -1, 1, 1)
    return out

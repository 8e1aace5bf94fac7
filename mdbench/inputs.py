"""Inputs of a run, made from its seed on the device: the weights, the
frames of synthetic drives, the host batches and the training draws.

The same seed gives the same tensors. Weights follow torch's default
initialization of each convolution (uniform in +-1/sqrt(fan_in)), drawn
in one call for all of them; BatchNorms start as the identity. Frames are
smooth random textures seen by a camera that pans a few pixels a frame,
so consecutive frames overlap as a moving camera's do. Batches leave the
device once, in set-up, as the float32 NumPy arrays a data loader yields.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

PAN = 4  # pixels the camera pans between consecutive frames
TEXTURE = 8  # the textures' cell size in pixels


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for one purpose (``stream``) of a seed."""
    return torch.Generator(device).manual_seed(
        (int(seed) * 1000003 + stream) % (2 ** 63))


def make_weights(ref_models, seed, device, scale):
    """{model: state dict} for the reference's module tree: every conv
    weight and bias uniform in +-1/sqrt(fan_in) from one draw, BatchNorms
    the identity, then each tensor named in ``scale`` ("model.key" ->
    factor) times its factor."""
    convs, out = [], {}
    for name, model in ref_models.items():
        sd = {}
        for mod_name, m in model.named_modules():
            prefix = f"{mod_name}." if mod_name else ""
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
                fan_in = m.weight.shape[1] * math.prod(m.weight.shape[2:])
                for key in ("weight", "bias"):
                    t = getattr(m, key)
                    if t is not None:
                        convs.append((name, prefix + key, tuple(t.shape),
                                      1.0 / math.sqrt(fan_in)))
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                c = m.num_features
                sd[prefix + "weight"] = torch.ones(c, device=device)
                sd[prefix + "bias"] = torch.zeros(c, device=device)
                sd[prefix + "running_mean"] = torch.zeros(c, device=device)
                sd[prefix + "running_var"] = torch.ones(c, device=device)
                sd[prefix + "num_batches_tracked"] = torch.zeros(
                    (), dtype=torch.long, device=device)
        out[name] = sd
    total = sum(math.prod(shape) for _, _, shape, _ in convs)
    flat = torch.rand(total, generator=generator(seed, device, 1),
                      device=device).mul_(2.0).sub_(1.0)
    at = 0
    for name, key, shape, bound in convs:
        n = math.prod(shape)
        out[name][key] = flat[at:at + n].view(shape) * bound
        at += n
    for name, factor in scale.items():
        model, key = name.split(".", 1)
        out[model][key] = out[model][key] * factor
    return out


def load_weights(models, weights):
    """Copy ``weights`` into ``models`` (keys and shapes must match)."""
    for name, model in models.items():
        model.load_state_dict(weights[name], strict=True)


def kitti_K(h, w):
    """The normalized KITTI intrinsics at (h, w), 4x4 float32."""
    return np.array([[0.58 * w, 0, 0.5 * w, 0], [0, 1.92 * h, 0.5 * h, 0],
                     [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)


def drives(n, frames, h, w, gen, device):
    """``n`` synthetic drives of ``frames`` frames each, (n, frames, h, w, 3)
    float32 in [0, 1] on ``device``: a smooth texture panned PAN pixels a
    frame."""
    wide = w + PAN * (frames - 1)
    cells = torch.rand((n, 3, h // TEXTURE + 2, wide // TEXTURE + 2),
                       generator=gen, device=device)
    tex = F.interpolate(cells, size=(h, wide), mode="bilinear",
                        align_corners=True)  # (n, 3, h, wide)
    out = torch.stack([tex[..., PAN * t:PAN * t + w] for t in range(frames)],
                      dim=1)
    return out.permute(0, 1, 3, 4, 2).contiguous()


def _to_host(batch):
    return {k: v.contiguous().cpu().numpy() for k, v in batch.items()}


def infer_batch(batch, h, w, gen, device):
    """One eval batch as the eval loader yields it: frames 0 and -1
    (batch, 2, h, w, 3), K and inv_K (batch, 4, 4), float32 on the host."""
    frames = drives(batch, 2, h, w, gen, device).flip(1)  # (0, -1)
    K = torch.from_numpy(kitti_K(h, w)).to(device)
    return _to_host({"color": frames, "K": K.expand(batch, 4, 4),
                     "inv_K": torch.linalg.inv(K).expand(batch, 4, 4)})


def train_batch(batch, h, w, gen, device):
    """One training batch with every key of the train loader's: frames
    (0, -1, 1), their jittered copy, the pyramid of frame 0, K, inv_K."""
    d = drives(batch, 3, h, w, gen, device)  # frames -1, 0, 1
    color = d[:, [1, 0, 2]]
    noise = torch.randn(color.shape, generator=gen, device=device)
    out = {"color": color,
           "color_aug": (color + 0.01 * noise).clamp(0.0, 1.0)}
    for s in range(1, 4):
        out[f"color_pyr_{s}"] = color[:, 0, ::2 ** s, ::2 ** s].contiguous()
    K = torch.from_numpy(kitti_K(h, w)).to(device)
    out["K"] = K.expand(batch, 4, 4)
    out["inv_K"] = torch.linalg.inv(K).expand(batch, 4, 4)
    return _to_host(out)


def draws(batch, h, w, scales, gen, device):
    """A training forward's draws, in ``pipeline.sample_draws``' shapes:
    the box (x0, y0) of the masked augmentation and one standard normal
    automask tiebreak (batch, h, w, 1) per scale."""
    x0 = torch.randint(0, w - w // 3, (), generator=gen, device=device)
    y0 = torch.randint(0, h - h // 3, (), generator=gen, device=device)
    noise = torch.randn((scales, batch, h, w, 1), generator=gen,
                        device=device)
    return {"box": (x0, y0), "noise": list(noise)}

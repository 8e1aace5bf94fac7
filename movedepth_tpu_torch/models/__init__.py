"""Model zoo and factory of the port (port of movedepth_tpu/models)."""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

from movedepth_tpu_torch.config import Config
from movedepth_tpu_torch.models.decoders_extra import (
    ContextAdjustmentLayer, DepthDecoder3D, DepthDecoder3Head,
    DepthDecoderBin, MPMDecoder, ResBlockWDSR)
from movedepth_tpu_torch.models.depth_decoder import DepthDecoder, UncertNet
from movedepth_tpu_torch.models.fpn import (FPN4, ConvexUpsampleHead,
                                            DCNConv2d, FPN3cas, Reg2D, Reg3D)
from movedepth_tpu_torch.models.pose_decoder import PoseCNN, PoseDecoder
from movedepth_tpu_torch.models.resnet import (ContextEncoder, ResNetEncoder,
                                               encoder_channels)
from movedepth_tpu_torch.models.storage import param_dtype, store_parameters

__all__ = ["ResNetEncoder", "ContextEncoder", "encoder_channels",
           "DepthDecoder", "UncertNet", "PoseDecoder", "PoseCNN", "FPN4",
           "FPN3cas", "Reg3D", "Reg2D", "DCNConv2d", "ConvexUpsampleHead",
           "MPMDecoder", "DepthDecoder3D", "DepthDecoderBin",
           "DepthDecoder3Head", "ContextAdjustmentLayer", "ResBlockWDSR",
           "build_models"]


def _init_weights(module: nn.Module, generator: torch.Generator):
    """Draw every conv weight and bias from ``generator`` with torch's
    default initialization; BatchNorm starts as the identity."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5),
                                     generator=generator)
            if m.bias is not None:
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
    for m in module.modules():  # after its conv_offset's draws above
        if isinstance(m, DCNConv2d):
            m.reset_parameters(generator)


def build_models(cfg: Config, device="cuda",
                 generator: torch.Generator = None) -> Dict[str, nn.Module]:
    """The shipped pipeline's models, in eval mode on ``device`` (the card
    unless the caller asks for the CPU; without a card it raises, as torch
    does).

    Mono encoder/decoder, pose encoder/decoder (unless ``load_pose``), the
    FPN matching encoder (with the deformable head when ``dcn``), the cost
    regularizer (Reg3D for 8 bins or more, else Reg2D, as the JAX package
    picks), the uncertainty head and (with ``convex_up``) the
    convex-upsampling head. Weights are drawn on the CPU from
    ``generator`` (default: seeded with ``cfg.seed``), so a seed gives the
    same weights on every device, then stored as ``cfg.param_dtype`` (the
    BatchNorm running statistics stay float32; ``models.storage``).
    """
    dtype = param_dtype(cfg)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    ch_enc = encoder_channels(cfg.res_arch)
    with torch.device("meta"):  # no allocation, no draw from the global RNG
        models = {
            "mono_encoder": ResNetEncoder(cfg.res_arch),
            "mono_depth": DepthDecoder(ch_enc, scales=cfg.scales),
            "mask_cnn": UncertNet(),
            "mvs_encoder": FPN4(base_channels=8, scale=cfg.prior_scale,
                                dcn=cfg.dcn),
            "reg3d": (Reg3D if cfg.num_depth_bins >= 8 else Reg2D)(
                base_channels=cfg.reg3d_c),
        }
        if not cfg.load_pose:
            models["pose_encoder"] = ResNetEncoder(cfg.res_arch,
                                                   num_input_images=2)
            models["pose"] = PoseDecoder(ch_enc, num_frames_to_predict_for=2)
        if cfg.convex_up:
            models["up"] = ConvexUpsampleHead(
                feature_dim=8 * 2 ** cfg.prior_scale, scale=cfg.prior_scale)
    for m in models.values():
        m.to_empty(device="cpu")
        _init_weights(m, generator)
    store_parameters(models, dtype)
    return {name: m.to(device).eval() for name, m in models.items()}

"""Plane-sweep cost volume: warp, correlate and group-mean in one kernel.

Port of the TPU kernel ``movedepth_tpu/ops/pallas/sweep_warp.py::
sweep_warp_corr``. On CUDA tensors :func:`sweep_warp_corr` launches the
hand-written Hopper kernel ``csrc/sweep_warp_corr.cu``; on CPU tensors it
runs the plain PyTorch version :func:`sweep_warp_corr_reference`, which is
also the kernel's oracle on the card.

The TPU kernel's dispatch machinery has no counterpart here: the row and
column windows, the rung ladder and its coverage checks, and the transposed
source layout exist because a TPU cannot gather. The card gathers natively,
so the kernel reads the NHWC features as they are, at any coordinates.
"""

from __future__ import annotations

import ctypes

import torch

from movedepth_tpu_torch import native

# Kernel launches in this process. Only the CUDA path counts; a caller that
# wants the launches of one run sets it to 0 first.
launches = 0

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def grid_to_pixel(grid, height, width):
    """Normalized [-1,1] grid (align_corners=True) -> pixel coords."""
    sx = (grid[..., 0] + 1.0) * 0.5 * (width - 1)
    sy = (grid[..., 1] + 1.0) * 0.5 * (height - 1)
    return sx, sy


def sweep_warp_corr_reference(src_feat, ref_feat, sx, sy, groups: int):
    """Plain PyTorch version of :func:`sweep_warp_corr`.

    The bilinear warp of ``F.grid_sample`` (zeros padding, align_corners
    =True) written out in pixel space: four gathered taps, each weighted in
    float32 and zeroed outside the frame; then times the reference feature
    and the mean over k of channels k*G+g. Computed in float32 and rounded
    once to the input dtype, as the kernel does. It samples at the pixel
    coordinates themselves: calling ``F.grid_sample`` would first normalize
    them to [-1, 1] and back, and that float32 round trip alone moves the
    result by ~2e-5 of its range at W=160, more than the kernel's
    float32 tolerance.
    """
    b, r, w, c = src_feat.shape
    _, d, h, wo = sx.shape
    src = src_feat.float().reshape(b, r * w, c)
    x = sx.clamp(-2.0, w + 1.0)
    y = sy.clamp(-2.0, r + 1.0)
    x0f, y0f = torch.floor(x), torch.floor(y)
    ax, ay = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()
    rows = torch.arange(b, device=src.device)[:, None]
    warped = 0.0
    for dy, dx, weight in ((0, 0, (1.0 - ax) * (1.0 - ay)),
                           (0, 1, ax * (1.0 - ay)),
                           (1, 0, (1.0 - ax) * ay),
                           (1, 1, ax * ay)):
        xi, yi = x0 + dx, y0 + dy
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < r)
        idx = yi.clamp(0, r - 1) * w + xi.clamp(0, w - 1)
        tap = src[rows, idx.reshape(b, -1)]  # (B, D*H*W, C)
        warped = warped + (weight * inside).reshape(b, -1, 1) * tap
    cost = warped.view(b, d, h, wo, c) * ref_feat.float()[:, None]
    cost = cost.view(b, d, h, wo, c // groups, groups).mean(-2)
    return cost.to(src_feat.dtype)


def kernel_library():
    """The kernel's shared library (compiled at the first call), typed."""
    lib = native.load_library("sweep_warp_corr")
    for fn in (lib.sweep_warp_corr_f32, lib.sweep_warp_corr_bf16):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    lib.sweep_warp_corr_supported.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.sweep_warp_corr_supported.restype = ctypes.c_int
    return lib


def sweep_warp_corr(src_feat, ref_feat, sx, sy, groups: int):
    """Plane-sweep cost volume: (B, D, H, W, G) in the features' dtype.

    src_feat: (B, R, W, C) NHWC source features; ref_feat: (B, H, W, C)
    reference features; sx, sy: (B, D, H, W) float32 pixel coordinates into
    src (align_corners=True pixel space). float32 or bfloat16 features.
    Group g is the mean over k of channel k*G+g of ``warp(src) * ref``;
    taps outside the source frame contribute 0. Inference only.
    """
    if src_feat.dim() != 4 or sx.dim() != 4 or sx.shape != sy.shape:
        raise ValueError("expected src (B,R,W,C) and sx, sy (B,D,H,W); got "
                         f"{tuple(src_feat.shape)}, {tuple(sx.shape)}, "
                         f"{tuple(sy.shape)}")
    b, r, w, c = src_feat.shape
    _, d, h, wo = sx.shape
    if sx.shape[0] != b or wo != w or ref_feat.shape != (b, h, w, c):
        raise ValueError(f"shape mismatch: src {tuple(src_feat.shape)}, ref "
                         f"{tuple(ref_feat.shape)}, coords {tuple(sx.shape)}")
    if src_feat.dtype not in _DTYPES or ref_feat.dtype != src_feat.dtype:
        raise TypeError("features must share a dtype of float32 or bfloat16; "
                        f"got {src_feat.dtype}, {ref_feat.dtype}")
    if sx.dtype != torch.float32 or sy.dtype != torch.float32:
        raise TypeError(f"coordinates must be float32; got {sx.dtype}, "
                        f"{sy.dtype}")
    if c % groups:
        raise ValueError(f"groups={groups} does not divide C={c}")
    tensors = (src_feat, ref_feat, sx, sy)
    device = src_feat.device
    if any(t.device != device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if device.type == "cpu":
        return sweep_warp_corr_reference(src_feat, ref_feat, sx, sy, groups)
    if device.type != "cuda":
        raise ValueError(f"no sweep_warp_corr for device {device}")

    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("the kernel needs contiguous, 16-byte aligned inputs")
    lib = kernel_library()
    if not lib.sweep_warp_corr_supported(c, groups):
        raise ValueError(f"the kernel is not built for C={c}, G={groups}")
    out = torch.empty((b, d, h, w, groups), dtype=src_feat.dtype,
                      device=device)
    fn = (lib.sweep_warp_corr_bf16 if src_feat.dtype == torch.bfloat16
          else lib.sweep_warp_corr_f32)
    with torch.cuda.device(device):
        err = fn(src_feat.data_ptr(), ref_feat.data_ptr(), sx.data_ptr(),
                 sy.data_ptr(), out.data_ptr(), b, r, w, d, h, c, groups,
                 torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"sweep_warp_corr launch failed: CUDA error {err}")
    global launches
    launches += 1
    return out

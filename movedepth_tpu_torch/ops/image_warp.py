"""Full-resolution photometric image warp, border mode, differentiable with
respect to the coordinates, with an optional photometric L1 epilogue.

Port of the TPU kernels ``movedepth_tpu/ops/pallas/image_warp.py::
warp_images_border``, its coordinate VJP (``_coord_bwd_cw_call``) and its
L1 epilogue (``_warp_cw_l1_cdiff``, reached with ``target=``). On CUDA
tensors :func:`warp_images_border` runs the forward and backward kernels
of ``csrc/image_warp.cu``, which clamp the coordinates themselves, through
:class:`WarpImagesBorder`, or with a target :class:`WarpImagesBorderL1`; on
CPU tensors it runs the plain PyTorch versions
:func:`warp_images_border_reference` and
:func:`warp_images_border_l1_reference`, which are also the kernels'
oracles on the card.

Border padding is a clamp of the coordinates into [0, W-1] x [0, R-1]
before sampling. The clamp is ``torch.minimum(torch.maximum(x, lo), hi)``,
whose gradient at an exact bound is 1/2, as JAX's ``jnp.clip`` has
(``torch.clamp`` gives 1 there and ``F.grid_sample``'s border gradient 0),
and 1/4 where lo = hi (a 1-pixel-wide or -tall image); the kernels apply
the same factors on the device.
Projections that leave the frame land exactly on a bound, so the rule
shows in the gradient. The taps are those of the JAX package's gather path
(``ops/sampling.py::_sample_one``): a tap past the last column or row
reads 0, with weight 0 in the forward pass but a part in the coordinate
derivative at x = W-1 and y = R-1. The images are data and get no
gradient. The TPU kernel's one-hot contractions, bf16 hi/lo split, planar
layout and window ladder have no counterpart: the card gathers natively.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from movedepth_tpu_torch import native

# Kernel launches in this process; only the CUDA path counts.
launches = 0  # forward
bwd_launches = 0  # coordinate backward
l1_launches = 0  # forward with the L1 epilogue
l1_bwd_launches = 0  # coordinate backward with the L1 cotangent


# the C functions' (argtypes, restype), set once when the library loads:
# the pointers, then B, R, W, K, C, ``aligned`` and the stream
_SIGNATURES = {
    name: ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 6
           + [ctypes.c_void_p], ctypes.c_int)
    for name, pointers in (("warp_images_border_fwd", 4),
                           ("warp_images_border_bwd", 6),
                           ("warp_images_border_l1_fwd", 6),
                           ("warp_images_border_l1_bwd", 8))}


def clamp_coords(sx, sy, height, width):
    """Border mode: coordinates into [0, W-1] x [0, R-1], gradient 1/2 at
    an exact bound (see the module docstring)."""
    zero = sx.new_zeros(())
    return (torch.minimum(torch.maximum(sx, zero), zero + (width - 1.0)),
            torch.minimum(torch.maximum(sy, zero), zero + (height - 1.0)))


def warp_images_border_reference(src, sx, sy):
    """Plain PyTorch version of :func:`warp_images_border`.

    The JAX package's border-mode gather in pixel space: clamp, floor, four
    taps from the image zero-padded by one row and column at the end, and
    ``v00*w00 + v01*w01 + v10*w10 + v11*w11`` in float32. Differentiable
    with respect to sx and sy through autograd (src too, unlike the
    kernels; the callers pass data).
    """
    x, y = clamp_coords(sx, sy, src.shape[1], src.shape[2])
    return sample_in_frame_reference(src, x, y)


def sample_in_frame_reference(src, x, y):
    """:func:`warp_images_border_reference` without its clamp: the sample
    at coordinates already inside the frame, and its derivative there."""
    b, r, w, c = src.shape
    _, k, h, wo = x.shape
    x0f, y0f = torch.floor(x).detach(), torch.floor(y).detach()
    fx, fy = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()
    table = F.pad(src.float(), (0, 0, 0, 1, 0, 1)).reshape(b, -1, c)
    rows = torch.arange(b, device=src.device)[:, None]
    base = (y0 * (w + 1) + x0).reshape(b, -1)
    out = 0.0
    for offset, weight in ((0, (1 - fx) * (1 - fy)), (1, fx * (1 - fy)),
                           (w + 1, (1 - fx) * fy), (w + 2, fx * fy)):
        tap = table[rows, base + offset]  # (B, K*H*W, C)
        out = out + tap * weight.reshape(b, -1, 1)
    return out.view(b, k, h, wo, c)


def warp_images_border_l1_reference(src, sx, sy, target):
    """Plain PyTorch version of :func:`warp_images_border` with a target:
    the warp of :func:`warp_images_border_reference`, then the L1 tail
    ``mean_c |warped - target|`` (B, K, R, W) in torch. Autograd gives the
    coordinates ``sign(w_c - t_c) * g_l1 / C`` from the L1 (sign(0) = 0)."""
    warped = warp_images_border_reference(src, sx, sy)
    return warped, torch.mean(torch.abs(warped - target[:, None]), dim=-1)


def kernel_library():
    """The image-warp kernels' library (compiled at first call), typed."""
    return native.load_library("image_warp", _SIGNATURES)


def aligned(*tensors):
    """1 if every tensor's data starts on a 16-byte boundary, else 0: the
    kernels then move the streams (every tensor but the images) in 16-byte
    vectors."""
    return int(all(t.data_ptr() % 16 == 0 for t in tensors))


def _launch(fn, src, *streams, shape):
    """Launch ``fn`` on the images ``src`` and the other tensors
    ``streams``; only the streams' alignment decides the 16-byte path, as
    the kernels read the images tap by tap."""
    if not all(t.is_contiguous() for t in (src, *streams)):
        raise ValueError("the kernel needs contiguous inputs")
    b, r, w, k, c = shape
    if r * w * max(c, 4) >= 2 ** 31:
        raise ValueError(f"an image plane of {r}x{w}x{c} needs 64-bit "
                         "offsets; the kernels take 32-bit ones")
    device = src.device
    with torch.cuda.device(device):
        err = fn(src.data_ptr(), *(t.data_ptr() for t in streams), *shape,
                 aligned(*streams),
                 torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"warp_images_border launch failed: CUDA error "
                           f"{err}")


class WarpImagesBorder(torch.autograd.Function):
    """The CUDA border-mode warp; the kernels clamp the coordinates, and
    the backward applies the clamp's derivative. Differentiable with
    respect to the coordinates only (one backward launch gives dsx and
    dsy)."""

    @staticmethod
    def forward(ctx, src, sx, sy):
        global launches
        src, sx, sy = (t.contiguous() for t in (src, sx, sy))
        b, r, w, c = src.shape
        k = sx.shape[1]
        out = torch.empty((b, k, r, w, c), dtype=torch.float32,
                          device=src.device)
        _launch(kernel_library().warp_images_border_fwd, src, sx, sy, out,
                shape=(b, r, w, k, c))
        launches += 1
        ctx.save_for_backward(src, sx, sy)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        global bwd_launches
        src, sx, sy = ctx.saved_tensors
        if not (ctx.needs_input_grad[1] or ctx.needs_input_grad[2]):
            return None, None, None
        b, r, w, c = src.shape
        dsx = torch.empty_like(sx)
        dsy = torch.empty_like(sy)
        _launch(kernel_library().warp_images_border_bwd, src, sx, sy,
                grad.float().contiguous(), dsx, dsy,
                shape=(b, r, w, sx.shape[1], c))
        bwd_launches += 1
        return None, dsx, dsy


class WarpImagesBorderL1(torch.autograd.Function):
    """The CUDA border-mode warp with the photometric L1 epilogue, on raw
    coordinates as :class:`WarpImagesBorder`: (warped, l1), l1 =
    mean_c |warped - target| from the values the forward kernel computed.
    The backward folds the L1 cotangent into the coordinate gradient in one
    launch; it recomputes the samples from their taps, so only the inputs
    are saved (not the (B, K, R, W, C) warped stack). Differentiable with
    respect to the coordinates only."""

    @staticmethod
    def forward(ctx, src, target, sx, sy):
        global l1_launches
        src, target, sx, sy = (t.contiguous() for t in (src, target, sx, sy))
        b, r, w, c = src.shape
        k = sx.shape[1]
        out = torch.empty((b, k, r, w, c), dtype=torch.float32,
                          device=src.device)
        l1 = torch.empty((b, k, r, w), dtype=torch.float32, device=src.device)
        _launch(kernel_library().warp_images_border_l1_fwd, src, target, sx,
                sy, out, l1, shape=(b, r, w, k, c))
        l1_launches += 1
        ctx.save_for_backward(src, target, sx, sy)
        return out, l1

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad, grad_l1):
        global l1_bwd_launches
        src, target, sx, sy = ctx.saved_tensors
        if not (ctx.needs_input_grad[2] or ctx.needs_input_grad[3]):
            return None, None, None, None
        b, r, w, c = src.shape
        dsx = torch.empty_like(sx)
        dsy = torch.empty_like(sy)
        _launch(kernel_library().warp_images_border_l1_bwd, src, target, sx,
                sy, grad.float().contiguous(), grad_l1.float().contiguous(),
                dsx, dsy, shape=(b, r, w, sx.shape[1], c))
        l1_bwd_launches += 1
        return None, None, dsx, dsy


def warp_images_border(src, sx, sy, target=None):
    """Border-mode bilinear warp of images over K coordinate maps.

    src: (B, R, W, C) float32 images; sx, sy: (B, K, R, W) float32 pixel
    coordinates (align_corners=True pixel space). Returns (B, K, R, W, C)
    float32, ``grid_sample(padding='border', align_corners=True)`` on the
    same coordinates. Differentiable with respect to sx and sy; src carries
    no gradient on the card. CPU tensors take
    :func:`warp_images_border_reference`.

    ``target`` (B, R, W, C) float32, the frame the warps are compared with,
    switches on the L1 epilogue: the return becomes ``(warped, l1)`` with
    l1 (B, K, R, W) float32 = ``mean_c |warped - target|``, computed inside
    the forward kernel on the card (:class:`WarpImagesBorderL1`) and by
    :func:`warp_images_border_l1_reference` on the CPU. The target is data:
    one that requires a gradient raises.
    """
    if src.dim() != 4 or sx.dim() != 4 or sx.shape != sy.shape:
        raise ValueError("expected src (B,R,W,C) and sx, sy (B,K,R,W); got "
                         f"{tuple(src.shape)}, {tuple(sx.shape)}, "
                         f"{tuple(sy.shape)}")
    b, r, w, _ = src.shape
    if sx.shape[0] != b or sx.shape[2:] != (r, w):
        raise ValueError(f"full-resolution warp: coords {tuple(sx.shape)} "
                         f"do not match images {tuple(src.shape)}")
    if any(t.dtype != torch.float32 for t in (src, sx, sy)):
        raise TypeError("images and coordinates must be float32; got "
                        f"{src.dtype}, {sx.dtype}, {sy.dtype}")
    device = src.device
    if sx.device != device or sy.device != device:
        raise ValueError("all inputs must be on one device")
    if target is not None:
        if target.shape != src.shape or target.dtype != torch.float32:
            raise ValueError(f"target {tuple(target.shape)} {target.dtype} "
                             f"must match images {tuple(src.shape)} float32")
        if target.device != device:
            raise ValueError("all inputs must be on one device")
        if target.requires_grad:
            raise ValueError("the L1 target is data and gets no gradient; "
                             "pass target.detach()")
    if device.type == "cpu":
        if target is None:
            return warp_images_border_reference(src, sx, sy)
        return warp_images_border_l1_reference(src, sx, sy, target)
    if device.type != "cuda":
        raise ValueError(f"no warp_images_border for device {device}")
    if target is None:
        return WarpImagesBorder.apply(src.detach(), sx, sy)
    return WarpImagesBorderL1.apply(src.detach(), target, sx, sy)

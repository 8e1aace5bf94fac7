"""Full-resolution photometric image warp, border mode, differentiable with
respect to the coordinates, with an optional photometric L1 epilogue.

Port of the TPU kernels ``movedepth_tpu/ops/pallas/image_warp.py::
warp_images_border``, its coordinate VJP (``_coord_bwd_cw_call``) and its
L1 epilogue (``_warp_cw_l1_cdiff``, reached with ``target=``). On CUDA
tensors :func:`warp_images_border` runs the forward and backward kernels
of ``csrc/image_warp.cu``, which clamp the coordinates themselves, through
the ``torch.library`` ops ``movedepth::warp_images_border_fwd`` and
``_bwd``, or with a target ``movedepth::warp_images_border_l1_fwd`` and
``_l1_bwd``; on CPU tensors the same ops run the plain PyTorch versions
:func:`warp_images_border_reference`,
:func:`warp_images_border_l1_reference` and their coordinate backwards
written out (``*_bwd_reference``), which are also the kernels' oracles on
the card.

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

from movedepth_tpu_torch import native, trace


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


def _clamp_slope(s, hi):
    """d clamp_coords / d s: 1 inside (0, hi), 1/2 at an exact bound, 1/4
    where 0 = hi = s, 0 outside (``torch.maximum``/``minimum``'s rule)."""
    lo_part = torch.where(s > 0, 1.0, torch.where(s == 0, 0.5, 0.0))
    x = torch.clamp_min(s, 0.0)
    return lo_part * torch.where(x < hi, 1.0, torch.where(x == hi, 0.5, 0.0))


def warp_images_border_bwd_reference(src, sx, sy, grad):
    """Plain PyTorch version of the border warp's coordinate backward:
    (dsx, dsy) (B, K, R, W) of the cotangent ``grad`` (B, K, R, W, C) of
    :func:`warp_images_border_reference`, written out: the bilinear
    sample's derivatives along x and y from the four taps of the padded
    image (a tap past the last column or row reads 0), summed over the
    channels against ``grad``, times the clamp's slope."""
    b, r, w, c = src.shape
    _, k, h, wo = sx.shape
    x, y = clamp_coords(sx, sy, r, w)
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx = (x - x0f).reshape(b, -1, 1)
    fy = (y - y0f).reshape(b, -1, 1)
    table = F.pad(src.float(), (0, 0, 0, 1, 0, 1)).reshape(b, -1, c)
    rows = torch.arange(b, device=src.device)[:, None]
    base = (y0f.long() * (w + 1) + x0f.long()).reshape(b, -1)
    v00, v01, v10, v11 = (table[rows, base + offset]
                          for offset in (0, 1, w + 1, w + 2))
    g = grad.float().reshape(b, -1, c)
    dx = torch.sum(g * ((v01 - v00) * (1 - fy) + (v11 - v10) * fy), dim=-1)
    dy = torch.sum(g * ((v10 - v00) * (1 - fx) + (v11 - v01) * fx), dim=-1)
    return (dx.view(sx.shape) * _clamp_slope(sx, w - 1.0),
            dy.view(sy.shape) * _clamp_slope(sy, r - 1.0))


def warp_images_border_l1_bwd_reference(src, target, sx, sy, grad, grad_l1):
    """Plain PyTorch version of the L1 epilogue's coordinate backward:
    the L1 cotangent folded into the warp's, ``grad + (g_l1 / C) *
    sign(warped - target)`` (sign(0) = 0, as autograd of the L1 tail
    gives), then :func:`warp_images_border_bwd_reference`."""
    warped = warp_images_border_reference(src, sx, sy)
    c = src.shape[-1]
    fold = grad.float() + (grad_l1.float()[..., None] / c) * torch.sign(
        warped - target[:, None])
    return warp_images_border_bwd_reference(src, sx, sy, fold)


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


# The kernels as torch.library ops of the ``movedepth`` namespace: the CPU
# implementation is the plain version, the CUDA one the launch, the fake
# one shapes and dtypes alone, so that torch.export traces them and a CUDA
# graph captures them.

@torch.library.custom_op("movedepth::warp_images_border_fwd",
                         mutates_args=(), device_types="cpu")
def _border_fwd(src: torch.Tensor, sx: torch.Tensor,
                sy: torch.Tensor) -> torch.Tensor:
    return warp_images_border_reference(src, sx, sy)


@_border_fwd.register_kernel("cuda")
def _border_fwd_cuda(src, sx, sy):
    src, sx, sy = (t.contiguous() for t in (src, sx, sy))
    b, r, w, c = src.shape
    k = sx.shape[1]
    out = torch.empty((b, k, r, w, c), dtype=torch.float32,
                      device=src.device)
    _launch(kernel_library().warp_images_border_fwd, src, sx, sy, out,
            shape=(b, r, w, k, c))
    trace.count("launch.warp_images_border")
    return out


@_border_fwd.register_fake
def _border_fwd_fake(src, sx, sy):
    return src.new_empty(tuple(sx.shape) + (src.shape[-1],),
                         dtype=torch.float32)


@torch.library.custom_op("movedepth::warp_images_border_bwd",
                         mutates_args=(), device_types="cpu")
def _border_bwd(src: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
                grad: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return warp_images_border_bwd_reference(src, sx, sy, grad)


@_border_bwd.register_kernel("cuda")
def _border_bwd_cuda(src, sx, sy, grad):
    src, sx, sy = (t.contiguous() for t in (src, sx, sy))
    b, r, w, c = src.shape
    dsx = torch.empty_like(sx)
    dsy = torch.empty_like(sy)
    _launch(kernel_library().warp_images_border_bwd, src, sx, sy,
            grad.float().contiguous(), dsx, dsy,
            shape=(b, r, w, sx.shape[1], c))
    trace.count("launch.warp_images_border_coord_bwd")
    return dsx, dsy


@_border_bwd.register_fake
def _border_bwd_fake(src, sx, sy, grad):
    return torch.empty_like(sx), torch.empty_like(sy)


def _border_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _border_backward(ctx, grad):
    """The kernels clamp the coordinates, and the backward applies the
    clamp's derivative; one launch gives dsx and dsy."""
    if not (ctx.needs_input_grad[1] or ctx.needs_input_grad[2]):
        return None, None, None
    dsx, dsy = _border_bwd(*ctx.saved_tensors, grad)
    return None, dsx, dsy


_border_fwd.register_autograd(_border_backward, setup_context=_border_setup)


@torch.library.custom_op("movedepth::warp_images_border_l1_fwd",
                         mutates_args=(), device_types="cpu")
def _l1_fwd(src: torch.Tensor, target: torch.Tensor, sx: torch.Tensor,
            sy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return warp_images_border_l1_reference(src, sx, sy, target)


@_l1_fwd.register_kernel("cuda")
def _l1_fwd_cuda(src, target, sx, sy):
    src, target, sx, sy = (t.contiguous() for t in (src, target, sx, sy))
    b, r, w, c = src.shape
    k = sx.shape[1]
    out = torch.empty((b, k, r, w, c), dtype=torch.float32,
                      device=src.device)
    l1 = torch.empty((b, k, r, w), dtype=torch.float32, device=src.device)
    _launch(kernel_library().warp_images_border_l1_fwd, src, target, sx, sy,
            out, l1, shape=(b, r, w, k, c))
    trace.count("launch.warp_images_border_l1")
    return out, l1


@_l1_fwd.register_fake
def _l1_fwd_fake(src, target, sx, sy):
    return (src.new_empty(tuple(sx.shape) + (src.shape[-1],),
                          dtype=torch.float32),
            src.new_empty(sx.shape, dtype=torch.float32))


@torch.library.custom_op("movedepth::warp_images_border_l1_bwd",
                         mutates_args=(), device_types="cpu")
def _l1_bwd(src: torch.Tensor, target: torch.Tensor, sx: torch.Tensor,
            sy: torch.Tensor, grad: torch.Tensor,
            grad_l1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return warp_images_border_l1_bwd_reference(src, target, sx, sy, grad,
                                               grad_l1)


@_l1_bwd.register_kernel("cuda")
def _l1_bwd_cuda(src, target, sx, sy, grad, grad_l1):
    src, target, sx, sy = (t.contiguous() for t in (src, target, sx, sy))
    b, r, w, c = src.shape
    dsx = torch.empty_like(sx)
    dsy = torch.empty_like(sy)
    _launch(kernel_library().warp_images_border_l1_bwd, src, target, sx, sy,
            grad.float().contiguous(), grad_l1.float().contiguous(), dsx,
            dsy, shape=(b, r, w, sx.shape[1], c))
    trace.count("launch.warp_images_border_l1_coord_bwd")
    return dsx, dsy


@_l1_bwd.register_fake
def _l1_bwd_fake(src, target, sx, sy, grad, grad_l1):
    return torch.empty_like(sx), torch.empty_like(sy)


def _l1_backward(ctx, grad, grad_l1):
    """Folds the L1 cotangent into the coordinate gradient in one launch;
    the kernel recomputes the samples from their taps, so only the inputs
    are saved (not the (B, K, R, W, C) warped stack)."""
    if not (ctx.needs_input_grad[2] or ctx.needs_input_grad[3]):
        return None, None, None, None
    dsx, dsy = _l1_bwd(*ctx.saved_tensors, grad, grad_l1)
    return None, None, dsx, dsy


_l1_fwd.register_autograd(_l1_backward, setup_context=_border_setup)


def warp_images_border(src, sx, sy, target=None):
    """Border-mode bilinear warp of images over K coordinate maps.

    src: (B, R, W, C) float32 images; sx, sy: (B, K, R, W) float32 pixel
    coordinates (align_corners=True pixel space). Returns (B, K, R, W, C)
    float32, ``grid_sample(padding='border', align_corners=True)`` on the
    same coordinates. Differentiable with respect to sx and sy; src carries
    no gradient. The op ``movedepth::warp_images_border_fwd`` runs
    :func:`warp_images_border_reference` on CPU tensors and the kernel on
    CUDA ones; its gradient is ``movedepth::warp_images_border_bwd``.

    ``target`` (B, R, W, C) float32, the frame the warps are compared with,
    switches on the L1 epilogue: the return becomes ``(warped, l1)`` with
    l1 (B, K, R, W) float32 = ``mean_c |warped - target|``, computed inside
    the forward kernel on the card and by
    :func:`warp_images_border_l1_reference` on the CPU (the ops
    ``movedepth::warp_images_border_l1_fwd`` and ``_l1_bwd``). The target
    is data: one that requires a gradient raises.
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
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no warp_images_border for device {device}")
    if target is None:
        return _border_fwd(src.detach(), sx, sy)
    return _l1_fwd(src.detach(), target, sx, sy)

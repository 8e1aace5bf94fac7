"""Plane-sweep warps of source features over depth hypotheses.

Port of the TPU kernels ``movedepth_tpu/ops/pallas/sweep_warp.py::
sweep_warp_corr`` (inference: warp, correlate and group-mean in one kernel)
and ``sweep_warp`` (training: the warp alone, with a source-feature
gradient). Each kernel entry point is a ``torch.library`` op:
``movedepth::sweep_warp_corr`` launches ``csrc/sweep_warp_corr.cu``,
``movedepth::sweep_warp_fwd`` and ``sweep_warp_bwd`` the forward and
backward kernels of ``csrc/sweep_warp.cu``, on CUDA tensors; on CPU tensors
the same ops run the plain PyTorch versions
:func:`sweep_warp_corr_reference`, :func:`sweep_warp_reference` and its
transpose :func:`sweep_warp_bwd_reference`, which are also the kernels'
oracles on the card. Each op has a fake implementation (shapes and
dtypes), so that ``torch.export`` traces it, and a CUDA graph captures its
launch.

The TPU kernels' dispatch machinery has no counterpart here: the row and
column windows, the rung ladder and its coverage checks, and the transposed
source layout exist because a TPU cannot gather. The card gathers natively,
so the kernels read the NHWC features as they are, at any coordinates.
"""

from __future__ import annotations

import ctypes

import torch

from movedepth_tpu_torch import native, trace

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_WARP_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# the C functions' (argtypes, restype), set once when a library loads
_SIGNATURES = {
    "sweep_warp_corr_f32": (_ARGTYPES, ctypes.c_int),
    "sweep_warp_corr_bf16": (_ARGTYPES, ctypes.c_int),
    "sweep_warp_corr_supported": ([ctypes.c_int] * 2, ctypes.c_int)}
_WARP_SIGNATURES = {f"sweep_warp_{d}_{t}": (_WARP_ARGTYPES, ctypes.c_int)
                    for d in ("fwd", "bwd") for t in ("f32", "bf16")}


def grid_to_pixel(grid, height, width):
    """Normalized [-1,1] grid (align_corners=True) -> pixel coords."""
    sx = (grid[..., 0] + 1.0) * 0.5 * (width - 1)
    sy = (grid[..., 1] + 1.0) * 0.5 * (height - 1)
    return sx, sy


def _taps(sx, sy, rows, width):
    """The four bilinear taps of the sweep warp at coordinates (B, D, H, W)
    into a (rows, width) plane: (flat index (B, N), weight (B, N, 1)) each,
    the weight float32 and 0 outside the frame. Coordinates are clamped to
    [-2, W+1] / [-2, R+1] first, as the kernels do, and carry no gradient.
    """
    b = sx.shape[0]
    x = sx.detach().clamp(-2.0, width + 1.0)
    y = sy.detach().clamp(-2.0, rows + 1.0)
    x0f, y0f = torch.floor(x), torch.floor(y)
    ax, ay = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()
    for dy, dx, weight in ((0, 0, (1.0 - ax) * (1.0 - ay)),
                           (0, 1, ax * (1.0 - ay)),
                           (1, 0, (1.0 - ax) * ay),
                           (1, 1, ax * ay)):
        xi, yi = x0 + dx, y0 + dy
        inside = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < rows)
        idx = yi.clamp(0, rows - 1) * width + xi.clamp(0, width - 1)
        yield idx.reshape(b, -1), (weight * inside).reshape(b, -1, 1)


def sweep_warp_reference(src_feat, sx, sy):
    """Plain PyTorch version of :func:`sweep_warp`: (B, D, H, W, C) in
    src's dtype, computed in float32 and rounded once.

    The bilinear warp of ``F.grid_sample`` (zeros padding, align_corners
    =True) written out in pixel space: four gathered taps (``_taps``), each
    weighted in float32 and zeroed outside the frame; src gets a gradient
    through autograd, the coordinates none. It samples at the pixel
    coordinates themselves: calling ``F.grid_sample`` would first
    normalize them to [-1, 1] and back, and that float32 round trip alone
    moves the result by ~2e-5 of its range at W=160, more than the
    kernels' float32 tolerance.
    """
    b, r, w, c = src_feat.shape
    _, d, h, wo = sx.shape
    src = src_feat.float().reshape(b, r * w, c)
    rows = torch.arange(b, device=src.device)[:, None]
    warped = 0.0
    for idx, weight in _taps(sx, sy, r, w):
        warped = warped + weight * src[rows, idx]  # (B, D*H*W, C)
    return warped.view(b, d, h, wo, c).to(src_feat.dtype)


def sweep_warp_bwd_reference(grad, sx, sy, rows: int):
    """Plain PyTorch version of the sweep warp's backward: the transpose of
    :func:`sweep_warp_reference`, the source gradient (B, rows, W, C) of
    the cotangent ``grad`` (B, D, H, W, C), each tap's weighted cotangent
    scatter-added into a float32 plane, rounded once to grad's dtype."""
    b, _, _, w, c = grad.shape
    g = grad.float().reshape(b, -1, c)
    dsrc = g.new_zeros((b, rows * w, c))
    for idx, weight in _taps(sx, sy, rows, w):
        dsrc.scatter_add_(1, idx[..., None].expand(-1, -1, c), weight * g)
    return dsrc.view(b, rows, w, c).to(grad.dtype)


def sweep_warp_corr_reference(src_feat, ref_feat, sx, sy, groups: int):
    """Plain PyTorch version of :func:`sweep_warp_corr`: the float32
    :func:`sweep_warp_reference` times the reference feature, then the
    mean over k of channels k*G+g, rounded once to the input dtype, as the
    kernel does."""
    b, h, w, c = ref_feat.shape
    warped = sweep_warp_reference(src_feat.float(), sx, sy)
    cost = warped * ref_feat.float()[:, None]
    cost = cost.view(b, -1, h, w, c // groups, groups).mean(-2)
    return cost.to(src_feat.dtype)


def _check_inputs(src_feat, sx, sy):
    """Shapes, dtypes and device of a sweep's inputs; returns the device."""
    if src_feat.dim() != 4 or sx.dim() != 4 or sx.shape != sy.shape:
        raise ValueError("expected src (B,R,W,C) and sx, sy (B,D,H,W); got "
                         f"{tuple(src_feat.shape)}, {tuple(sx.shape)}, "
                         f"{tuple(sy.shape)}")
    if sx.shape[0] != src_feat.shape[0] or sx.shape[3] != src_feat.shape[2]:
        raise ValueError(f"shape mismatch: src {tuple(src_feat.shape)}, "
                         f"coords {tuple(sx.shape)}")
    if src_feat.dtype not in _DTYPES:
        raise TypeError("features must be float32 or bfloat16; got "
                        f"{src_feat.dtype}")
    if sx.dtype != torch.float32 or sy.dtype != torch.float32:
        raise TypeError(f"coordinates must be float32; got {sx.dtype}, "
                        f"{sy.dtype}")
    device = src_feat.device
    if sx.device != device or sy.device != device:
        raise ValueError("all inputs must be on one device")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no plane-sweep warp for device {device}")
    return device


def _check_kernel_inputs(*tensors):
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("the kernel needs contiguous, 16-byte aligned inputs")


def kernel_library():
    """The sweep_warp_corr kernel's library (compiled at first call), typed."""
    return native.load_library("sweep_warp_corr", _SIGNATURES)


def warp_library():
    """The sweep_warp kernels' library (compiled at first call), typed."""
    return native.load_library("sweep_warp", _WARP_SIGNATURES)


def sweep_warp_corr(src_feat, ref_feat, sx, sy, groups: int):
    """Plane-sweep cost volume: (B, D, H, W, G) in the features' dtype.

    src_feat: (B, R, W, C) NHWC source features; ref_feat: (B, H, W, C)
    reference features; sx, sy: (B, D, H, W) float32 pixel coordinates into
    src (align_corners=True pixel space). float32 or bfloat16 features.
    Group g is the mean over k of channel k*G+g of ``warp(src) * ref``;
    taps outside the source frame contribute 0. Inference only: the op
    ``movedepth::sweep_warp_corr`` has no gradient.
    """
    device = _check_inputs(src_feat, sx, sy)
    b, r, w, c = src_feat.shape
    _, d, h, _ = sx.shape
    if ref_feat.shape != (b, h, w, c):
        raise ValueError(f"shape mismatch: src {tuple(src_feat.shape)}, ref "
                         f"{tuple(ref_feat.shape)}, coords {tuple(sx.shape)}")
    if ref_feat.dtype != src_feat.dtype:
        raise TypeError("features must share a dtype of float32 or bfloat16; "
                        f"got {src_feat.dtype}, {ref_feat.dtype}")
    if ref_feat.device != device:
        raise ValueError("all inputs must be on one device")
    if c % groups:
        raise ValueError(f"groups={groups} does not divide C={c}")
    return _corr_op(src_feat, ref_feat, sx, sy, groups)


# The kernels as torch.library ops of the ``movedepth`` namespace, so that
# torch.export traces them (a fake tensor has no data_ptr) and a CUDA graph
# captures them: the CPU implementation is the plain version, the CUDA one
# the launch, the fake one shapes and dtypes alone.

@torch.library.custom_op("movedepth::sweep_warp_corr", mutates_args=(),
                         device_types="cpu")
def _corr_op(src_feat: torch.Tensor, ref_feat: torch.Tensor,
             sx: torch.Tensor, sy: torch.Tensor,
             groups: int) -> torch.Tensor:
    return sweep_warp_corr_reference(src_feat, ref_feat, sx, sy, groups)


@_corr_op.register_kernel("cuda")
def _corr_cuda(src_feat, ref_feat, sx, sy, groups):
    _check_kernel_inputs(src_feat, ref_feat, sx, sy)
    b, r, w, c = src_feat.shape
    _, d, h, _ = sx.shape
    lib = kernel_library()
    if not lib.sweep_warp_corr_supported(c, groups):
        raise ValueError(
            f"the kernel is built for C in {{8, 16, 32, 64}} channels and G "
            f"groups that divide C with C/G a power of two; got C={c}, "
            f"G={groups}")
    out = torch.empty((b, d, h, w, groups), dtype=src_feat.dtype,
                      device=src_feat.device)
    fn = (lib.sweep_warp_corr_bf16 if src_feat.dtype == torch.bfloat16
          else lib.sweep_warp_corr_f32)
    with torch.cuda.device(src_feat.device):
        err = fn(src_feat.data_ptr(), ref_feat.data_ptr(), sx.data_ptr(),
                 sy.data_ptr(), out.data_ptr(), b, r, w, d, h, c, groups,
                 torch.cuda.current_stream(src_feat.device).cuda_stream)
    if err:
        raise RuntimeError(f"sweep_warp_corr launch failed: CUDA error {err}")
    trace.count("launch.sweep_warp_corr")
    return out


@_corr_op.register_fake
def _corr_fake(src_feat, ref_feat, sx, sy, groups):
    b, d, h, w = sx.shape
    return src_feat.new_empty((b, d, h, w, groups))


def _warp_kernel(direction, x, sx, sy, out):
    """Launch sweep_warp's forward ("fwd": x is src, out the warp) or
    backward ("bwd": x is the warp's gradient, out the zeroed float32
    source gradient) kernel on CUDA tensors."""
    _check_kernel_inputs(x, sx, sy, out)
    dt = "bf16" if x.dtype == torch.bfloat16 else "f32"
    fn = getattr(warp_library(), f"sweep_warp_{direction}_{dt}")
    b, d, h, w = sx.shape
    _, r, _, c = out.shape if direction == "bwd" else x.shape
    if c % (16 // x.element_size()):
        raise ValueError(f"the kernel needs C={c} to fill 16-byte vectors")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), sx.data_ptr(), sy.data_ptr(), out.data_ptr(),
                 b, r, w, d, h, c,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"sweep_warp {direction} launch failed: CUDA "
                           f"error {err}")


@torch.library.custom_op("movedepth::sweep_warp_fwd", mutates_args=(),
                         device_types="cpu")
def _warp_fwd(src_feat: torch.Tensor, sx: torch.Tensor,
              sy: torch.Tensor) -> torch.Tensor:
    return sweep_warp_reference(src_feat, sx, sy)


@_warp_fwd.register_kernel("cuda")
def _warp_fwd_cuda(src_feat, sx, sy):
    src_feat, sx, sy = (t.contiguous() for t in (src_feat, sx, sy))
    b, d, h, w = sx.shape
    out = torch.empty((b, d, h, w, src_feat.shape[-1]), dtype=src_feat.dtype,
                      device=src_feat.device)
    _warp_kernel("fwd", src_feat, sx, sy, out)
    trace.count("launch.sweep_warp")
    return out


@_warp_fwd.register_fake
def _warp_fwd_fake(src_feat, sx, sy):
    return src_feat.new_empty(tuple(sx.shape) + (src_feat.shape[-1],))


@torch.library.custom_op("movedepth::sweep_warp_bwd", mutates_args=(),
                         device_types="cpu")
def _warp_bwd(grad: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
              rows: int) -> torch.Tensor:
    return sweep_warp_bwd_reference(grad, sx, sy, rows)


@_warp_bwd.register_kernel("cuda")
def _warp_bwd_cuda(grad, sx, sy, rows):
    b, _, _, w, c = grad.shape
    dsrc = torch.zeros((b, rows, w, c), dtype=torch.float32,
                       device=grad.device)
    _warp_kernel("bwd", grad.contiguous(), sx.contiguous(), sy.contiguous(),
                 dsrc)
    trace.count("launch.sweep_warp_bwd")
    return dsrc.to(grad.dtype)


@_warp_bwd.register_fake
def _warp_bwd_fake(grad, sx, sy, rows):
    b, _, _, w, c = grad.shape
    return grad.new_empty((b, rows, w, c))


def _warp_setup(ctx, inputs, output):
    src_feat, sx, sy = inputs
    ctx.save_for_backward(sx, sy)
    ctx.rows, ctx.src_dtype = src_feat.shape[1], src_feat.dtype


def _warp_backward(ctx, grad):
    """dsrc (accumulated in float32 on the card, in src's dtype); the
    coordinates get no gradient, as in the TPU kernel's VJP."""
    if not ctx.needs_input_grad[0]:
        return None, None, None
    sx, sy = ctx.saved_tensors
    return (_warp_bwd(grad.to(ctx.src_dtype).contiguous(), sx, sy,
                      ctx.rows), None, None)


_warp_fwd.register_autograd(_warp_backward, setup_context=_warp_setup)


def sweep_warp(src_feat, sx, sy):
    """Warp source features over all depth hypotheses, zeros padding:
    (B, D, H, W, C) in src's dtype.

    src_feat: (B, R, W, C) NHWC float32 or bfloat16 features; sx, sy:
    (B, D, H, W) float32 pixel coordinates into src (align_corners=True
    pixel space). Differentiable with respect to src_feat; the coordinates
    carry no gradient. The op ``movedepth::sweep_warp_fwd`` runs
    :func:`sweep_warp_reference` on CPU tensors and the kernel on CUDA
    ones; its gradient is ``movedepth::sweep_warp_bwd``.
    """
    _check_inputs(src_feat, sx, sy)
    return _warp_fwd(src_feat, sx.detach(), sy.detach())

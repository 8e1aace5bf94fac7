"""Tests of the PyTorch port that need an NVIDIA GPU (marker ``cuda``).

Each skips where no CUDA device is present. The GPU machine has no JAX,
so this file imports none and takes no fixture from tests/conftest.py
(which imports JAX). On the card, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import copy

import numpy as np
import pytest
import torch

from movedepth_tpu_torch import Config
from movedepth_tpu_torch import pipeline as P
from movedepth_tpu_torch import trace
from movedepth_tpu_torch.models import build_models
from movedepth_tpu_torch.ops import sweep_warp as SW
from movedepth_tpu_torch.ops.costvolume import schedule_depth_bins, sweep_grid
from movedepth_tpu_torch.ops.geometry import transformation_from_parameters

pytestmark = pytest.mark.cuda


SWEEP = ("sweep_warp", "sweep_warp_bwd")
BORDER = ("warp_images_border", "warp_images_border_coord_bwd")
L1 = ("warp_images_border_l1", "warp_images_border_l1_coord_bwd")


def _launches(*kernels):
    """The launches the tracer's counters hold: an int for one kernel, a
    tuple for several."""
    n = tuple(trace.counter(f"launch.{k}") for k in kernels)
    return n[0] if len(n) == 1 else n


def _grown(before, *kernels):
    """The launches of ``kernels`` since ``before`` (their counts then)."""
    return tuple(a - b for a, b in zip(_launches(*kernels), before))

@pytest.fixture
def device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    # float32 results are compared: keep cuDNN and cuBLAS out of TF32
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _sweep_inputs(b=2, d=16, h=48, w=160, c=32, motion=1.0):
    """Features and sweep coordinates at a KITTI-like motion (``motion``
    10: ~1 m between frames, KITTI speed)."""
    g = torch.Generator().manual_seed(0)
    src = torch.randn(b, h, w, c, generator=g)
    ref = torch.randn(b, h, w, c, generator=g)
    K = torch.tensor([[0.58 * w, 0, 0.5 * w, 0], [0, 1.92 * h, 0.5 * h, 0],
                      [0, 0, 1, 0], [0, 0, 0, 1]]).repeat(b, 1, 1)
    bins = schedule_depth_bins(torch.rand(b, h, w, generator=g) * 55 + 5, d,
                               0.3)
    T = transformation_from_parameters(
        torch.randn(b, 3, generator=g) * 5e-3,
        torch.tensor([[0.3, 0.02, -0.1]]).repeat(b, 1) * motion)
    sx, sy = SW.grid_to_pixel(sweep_grid(bins, K, torch.linalg.inv(K), T),
                              h, w)
    return src, ref, sx.contiguous(), sy.contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(device, dtype):
    """float32 within 1e-5 of the volume's range; bf16 within one bf16 ulp
    of the float32 result on the same inputs (plus that float32 bound)."""
    src, ref, sx, sy = (t.to(device) for t in _sweep_inputs())
    src, ref = src.to(dtype), ref.to(dtype)
    before = _launches("sweep_warp_corr")
    got = SW.sweep_warp_corr(src, ref, sx, sy, 16)
    assert _launches("sweep_warp_corr") == before + 1
    want = SW.sweep_warp_corr_reference(src.float(), ref.float(), sx, sy, 16)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    tol = 1e-5 * want.abs().max()
    if dtype == torch.bfloat16:
        tol = tol + torch.exp2(torch.floor(torch.log2(
            want.abs().clamp_min(1e-30))) - 7)
    assert torch.all((got.float() - want).abs() <= tol)


# every pair the JAX package fuses at the FPN's widths: G | C, C/G a power
# of two
_SWC_PAIRS = [(c, c >> k) for c in (8, 16, 32, 64)
              for k in range(c.bit_length())]


def _bf16_ulp(x):
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


@pytest.mark.parametrize("c,groups", _SWC_PAIRS)
def test_kernel_every_channel_group_pair(device, c, groups):
    """Every (C, G) pair the kernel is built for, in both dtypes, at batch 2
    and batch 1: within 1e-5 of the volume's range (plus one bf16 ulp of
    the float32 result in bfloat16)."""
    src, ref, sx, sy = (t.to(device) for t in _sweep_inputs(h=16, w=40,
                                                            c=c))
    for dtype in (torch.float32, torch.bfloat16):
        for b in (2, 1):
            args = [t[:b].contiguous() for t in (src.to(dtype), ref.to(dtype),
                                                 sx, sy)]
            got = SW.sweep_warp_corr(*args, groups)
            want = SW.sweep_warp_corr_reference(
                args[0].float(), args[1].float(), *args[2:], groups)
            torch.cuda.synchronize()
            tol = 1e-5 * want.abs().max()
            if dtype == torch.bfloat16:
                tol = tol + _bf16_ulp(want)
            assert got.dtype == dtype and got.shape == want.shape
            assert torch.all((got.float() - want).abs() <= tol), (dtype, b)


@pytest.mark.parametrize("c,groups", [(24, 8), (32, 3), (128, 16), (4, 4)])
def test_kernel_refuses_pairs_outside_the_rule(device, c, groups):
    """C/G not a power of two, G not dividing C, or C not built: a
    ValueError that states the rule, and no launch."""
    src, ref, sx, sy = (t.to(device) for t in _sweep_inputs(h=8, w=16, c=c,
                                                            d=8))
    before = _launches("sweep_warp_corr")
    with pytest.raises(ValueError, match="divide"):
        SW.sweep_warp_corr(src, ref, sx, sy, groups)
    assert _launches("sweep_warp_corr") == before


def test_kernel_out_of_frame_gives_exact_zeros(device):
    src, ref, sx, sy = (t.to(device) for t in _sweep_inputs())
    got = SW.sweep_warp_corr(src, ref, sx + 1000.0, sy, 16)
    assert torch.count_nonzero(got).item() == 0


def _warp_coords(sx, sy, w, h):
    """Sweep coordinates with a few exact-bound and out-of-frame points."""
    sx, sy = sx.clone(), sy.clone()
    sx[:, 0, 0, :8] = torch.tensor([0.0, w - 1.0, -0.5, w - 0.5, -3.0,
                                    w + 4.0, 0.0, w - 1.0])
    sy[:, 0, 0, :8] = torch.tensor([0.0, h - 1.0, 3.0, 2.0, h - 0.5,
                                    -0.5, h - 1.0, 0.0])
    return sx, sy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sweep_warp_kernels_match_plain_version(device, dtype):
    """Forward within 1e-5 of the range (plus one bf16 ulp in bfloat16),
    dsrc within 1e-5 of its range against the plain version's autograd."""
    src, _, sx, sy = _sweep_inputs()
    sx, sy = _warp_coords(sx, sy, src.shape[2], src.shape[1])
    src, sx, sy = (t.to(device) for t in (src.to(dtype), sx, sy))
    g = torch.randn(sx.shape + src.shape[-1:],
                    generator=torch.Generator().manual_seed(1)).to(device)
    before = _launches(*SWEEP)
    leaf = src.clone().requires_grad_()
    got = SW.sweep_warp(leaf, sx, sy)
    (got.float() * g).sum().backward()
    assert _grown(before, *SWEEP) == (1, 1)
    ref_leaf = src.float().clone().requires_grad_()
    want = SW.sweep_warp_reference(ref_leaf, sx, sy)
    (want * g.to(dtype).float()).sum().backward()
    torch.cuda.synchronize()
    assert got.dtype == dtype and leaf.grad.dtype == dtype
    tol = 1e-5 * want.abs().max()
    dtol = 1e-5 * ref_leaf.grad.abs().max()
    if dtype == torch.bfloat16:
        tol = tol + torch.exp2(torch.floor(torch.log2(
            want.abs().clamp_min(1e-30))) - 7)
        dtol = dtol + torch.exp2(torch.floor(torch.log2(
            ref_leaf.grad.abs().clamp_min(1e-30))) - 7)
    assert torch.all((got.float() - want).abs() <= tol)
    assert torch.all((leaf.grad.float() - ref_leaf.grad).abs() <= dtol)


def _check_dsrc(src, sx, sy, seed=1):
    """The sweep warp's source gradient through its op's backward against
    the plain version's autograd in float32 on the same (rounded) inputs:
    within 1e-5 of dsrc's range, plus one bf16 ulp in bfloat16. Returns
    the backward kernel's launches."""
    g = torch.randn(sx.shape + src.shape[-1:],
                    generator=torch.Generator().manual_seed(seed))
    g = g.to(src.device, src.dtype)
    before = _launches("sweep_warp_bwd")
    leaf = src.clone().requires_grad_()
    got = torch.autograd.grad(SW.sweep_warp(leaf, sx, sy), leaf, g)[0]
    launched = _launches("sweep_warp_bwd") - before
    ref = src.float().requires_grad_()
    want = torch.autograd.grad(SW.sweep_warp_reference(ref, sx, sy), ref,
                               g.float())[0]
    torch.cuda.synchronize()
    assert got.dtype == src.dtype and got.shape == src.shape
    tol = 1e-5 * want.abs().max()
    if src.dtype == torch.bfloat16:
        tol = tol + _bf16_ulp(want)
    assert torch.all((got.float() - want).abs() <= tol)
    return launched


# (C, dtype) of the source gradient's card tests: the FPN's widths in both
# dtypes, and widths that fill 16-byte vectors but no larger power of two
_BWD_WIDTHS = [(c, dt) for c in (8, 16, 32, 64)
               for dt in (torch.float32, torch.bfloat16)] + [
    (4, torch.float32), (12, torch.float32), (24, torch.bfloat16)]


@pytest.mark.parametrize("c,dtype", _BWD_WIDTHS)
def test_sweep_warp_bwd_widths(device, c, dtype):
    """The source-gradient kernel at every channel width, exact-bound and
    out-of-frame taps included: one launch."""
    src, _, sx, sy = _sweep_inputs(c=c)
    sx, sy = _warp_coords(sx, sy, src.shape[2], src.shape[1])
    src, sx, sy = (t.to(device) for t in (src.to(dtype), sx, sy))
    assert _check_dsrc(src, sx, sy) == 1


@pytest.mark.parametrize("c,dtype", _BWD_WIDTHS)
def test_sweep_warp_fwd_widths(device, c, dtype):
    """The forward kernel at every channel width: exact-bound and
    out-of-frame points, a 157-pixel row (no multiple of any x-tile), 10
    planes (no multiple of the planes a thread walks), batch 2 and 1; one
    launch each, within 1e-5 of the range (plus one bf16 ulp in bfloat16)
    of the plain version."""
    h, w = 24, 157
    src, _, sx, sy = _sweep_inputs(d=10, h=h, w=w, c=c)
    sx, sy = _warp_coords(sx, sy, w, h)
    for b in (2, 1):
        args = [t[:b].contiguous().to(device) for t in (src.to(dtype), sx,
                                                        sy)]
        before = _launches("sweep_warp")
        got = SW.sweep_warp(*args)
        assert _launches("sweep_warp") == before + 1
        want = SW.sweep_warp_reference(args[0].float(), *args[1:])
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == want.shape
        tol = 1e-5 * want.abs().max()
        if dtype == torch.bfloat16:
            tol = tol + _bf16_ulp(want)
        assert torch.all((got.float() - want).abs() <= tol), b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sweep_warp_bwd_kitti_speed(device, dtype):
    """~1 m between frames: epipolar segments of 10-20 pixels, so the tap
    base of a pixel changes from plane to plane and runs are short."""
    src, _, sx, sy = _sweep_inputs(motion=10.0)
    src, sx, sy = (t.to(device) for t in (src.to(dtype), sx, sy))
    assert _check_dsrc(src, sx, sy) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("where", [(37.25, 20.5), (40.0, 24.0),
                                   (159.0, 47.0)])
def test_sweep_warp_bwd_every_point_on_one_pixel(device, dtype, where):
    """The worst contention: every point of every plane samples one place
    (inside, on a pixel, on the last pixel), so all adds land on the same
    four source pixels, and each pixel's D planes merge into one run."""
    src, _, sx, sy = _sweep_inputs()
    sx, sy = torch.full_like(sx, where[0]), torch.full_like(sy, where[1])
    src, sx, sy = (t.to(device) for t in (src.to(dtype), sx, sy))
    assert _check_dsrc(src, sx, sy) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sweep_warp_bwd_large_plane(device, dtype):
    """A wide plane with few reference rows (64x2048 source, 8 rows, 2
    planes) at coordinates scattered over and past the frame: runs of one
    plane, taps everywhere."""
    b, r, w, d, h, c = 1, 64, 2048, 2, 8, 8
    gen = torch.Generator().manual_seed(4)
    src = torch.randn(b, r, w, c, generator=gen)
    sx = torch.rand(b, d, h, w, generator=gen) * (w + 6.0) - 3.0
    sy = torch.rand(b, d, h, w, generator=gen) * (r + 6.0) - 3.0
    src, sx, sy = (t.to(device) for t in (src.to(dtype), sx, sy))
    assert _check_dsrc(src, sx, sy) == 1


def _image_inputs(b=2, k=6, h=48, w=96):
    g = torch.Generator().manual_seed(2)
    src = torch.rand(b, h, w, 3, generator=g)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32),
                            indexing="ij")
    shift = torch.randn(b, k, 1, 1, generator=g) * 2.0
    sx = (xs + shift + 0.3 * torch.randn(b, k, h, w, generator=g)).contiguous()
    sy = (ys - shift + 0.3 * torch.randn(b, k, h, w, generator=g)).contiguous()
    sx[:, :, 0, :6] = torch.tensor([0.0, w - 1.0, -2.0, w + 3.0, 0.0, w - 1.0])
    sy[:, :, 0, :6] = torch.tensor([h - 1.0, 0.0, h - 1.0, -1.0, 0.0, h - 1.0])
    return src, sx, sy


def test_image_warp_kernels_match_plain_version(device):
    """Border-mode forward and dsx/dsy within 1e-5 of their range against
    the plain version (and its autograd), exact bounds and out-of-frame
    coordinates included."""
    from movedepth_tpu_torch.ops import image_warp as IW
    src, sx, sy = (t.to(device) for t in _image_inputs())
    g = torch.randn(sx.shape + (3,),
                    generator=torch.Generator().manual_seed(3)).to(device)
    before = _launches(*BORDER)
    x, y = sx.clone().requires_grad_(), sy.clone().requires_grad_()
    got = IW.warp_images_border(src, x, y)
    (got * g).sum().backward()
    assert _grown(before, *BORDER) == (1, 1)
    xr, yr = sx.clone().requires_grad_(), sy.clone().requires_grad_()
    want = IW.warp_images_border_reference(src, xr, yr)
    (want * g).sum().backward()
    torch.cuda.synchronize()
    for a, b in ((got, want), (x.grad, xr.grad), (y.grad, yr.grad)):
        assert torch.all((a - b).abs() <= 1e-5 * b.abs().max())


def test_image_warp_l1_kernels_match_plain_version(device):
    """The L1 epilogue: warped stack, L1 map and dsx/dsy with both
    cotangents nonzero within 1e-5 of their range against the plain
    version's autograd; exact ties (rows on the pixel grid, the target the
    image there) give an L1 of exactly 0."""
    from movedepth_tpu_torch.ops import image_warp as IW
    src, sx, sy = _image_inputs()
    h, w = src.shape[1:3]
    sx[:, :, 10] = torch.arange(w, dtype=torch.float32)
    sy[:, :, 10] = 10.0
    g = torch.Generator().manual_seed(5)
    tgt = torch.rand(src.shape, generator=g)
    tgt[:, 10] = src[:, 10]
    gi = torch.randn(sx.shape + (3,), generator=g)
    gl = torch.randn(sx.shape, generator=g)
    src, sx, sy, tgt, gi, gl = (t.to(device) for t in
                                (src, sx, sy, tgt, gi, gl))
    before = _launches(*L1)
    x, y = sx.clone().requires_grad_(), sy.clone().requires_grad_()
    got, got_l1 = IW.warp_images_border(src, x, y, target=tgt)
    torch.autograd.backward((got, got_l1), (gi, gl))
    assert _grown(before, *L1) == (1, 1)
    xr, yr = sx.clone().requires_grad_(), sy.clone().requires_grad_()
    want, want_l1 = IW.warp_images_border_l1_reference(src, xr, yr, tgt)
    torch.autograd.backward((want, want_l1), (gi, gl))
    torch.cuda.synchronize()
    for a, b in ((got, want), (got_l1, want_l1), (x.grad, xr.grad),
                 (y.grad, yr.grad)):
        assert torch.all((a - b).abs() <= 1e-5 * b.abs().max())
    assert torch.count_nonzero(got_l1[:, :, 10]).item() == 0


def _view_at(t, offset):
    """t's values in a contiguous view that starts ``offset`` floats into
    its storage (offset 1: not 16-byte aligned)."""
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    return flat[offset:].view(t.shape).copy_(t)


# (B, K, R, W, C, storage offset of the images, of every other input)
_WARP_CASES = {"c3": (2, 3, 32, 64, 3, 0, 0),
               "ragged": (2, 3, 5, 7, 3, 0, 0),
               "unaligned": (2, 3, 16, 24, 3, 1, 1),
               "unaligned_images": (2, 3, 16, 24, 3, 1, 0),
               "w1": (2, 2, 16, 1, 3, 0, 0), "r1": (2, 2, 1, 64, 3, 0, 0),
               "c1": (2, 3, 16, 24, 1, 0, 0)}


def _warp_case(b, k, r, w, c):
    """Images, target, coordinates and cotangents: pixel grids shifted and
    jittered, the first pixels of every map on exact bounds (0, W-1, R-1)
    and out of frame, the last ones on their own pixel with the target
    equal to the image there (|warped - target| = 0: L1 ties)."""
    g = torch.Generator().manual_seed(7)
    src = torch.rand(b, r, w, c, generator=g)
    tgt = src + torch.rand(src.shape, generator=g) * 0.2 - 0.1
    ys, xs = torch.meshgrid(torch.arange(r, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32),
                            indexing="ij")
    sx = xs + torch.randn(b, k, 1, 1, generator=g) * 1.5 \
        + 0.3 * torch.randn(b, k, r, w, generator=g)
    sy = ys + torch.randn(b, k, 1, 1, generator=g) * 1.5 \
        + 0.3 * torch.randn(b, k, r, w, generator=g)
    fx, fy = sx.view(b, k, -1), sy.view(b, k, -1)
    special = torch.tensor([[0.0, w - 1.0, -2.0, w + 3.0, 0.0, w - 1.0],
                            [r - 1.0, 0.0, r - 1.0, -1.0, 0.0, r - 1.0]])
    n = min(6, r * w)
    fx[:, :, :n], fy[:, :, :n] = special[0, :n], special[1, :n]
    ties = slice(max(n, r * w - 8), r * w)
    fx[:, :, ties] = xs.flatten()[ties]
    fy[:, :, ties] = ys.flatten()[ties]
    tgt.view(b, r * w, c)[:, ties] = src.view(b, r * w, c)[:, ties]
    gi = torch.randn((b, k, r, w, c), generator=g)
    gl = torch.randn((b, k, r, w), generator=g)
    return src, tgt, sx, sy, gi, gl


@pytest.mark.parametrize("case", sorted(_WARP_CASES))
def test_image_warp_kernels_edge_shapes(device, case):
    """The redesigned border-warp kernels, with and without the L1
    epilogue, on a ragged R*W, views that are not 16-byte aligned (every
    input, or the images alone, which keep the 16-byte path), W = 1, R = 1,
    C = 1 and C = 3: the warped stack equals the plain version bit
    for bit; the L1 map, dsx and dsy lie within 1e-5 of their range of its
    autograd, exact bounds, out-of-frame points and exact L1 ties
    included."""
    from movedepth_tpu_torch.ops import image_warp as IW
    b, k, r, w, c, src_offset, offset = _WARP_CASES[case]
    src, tgt, sx, sy, gi, gl = (
        _view_at(t.to(device), src_offset if i == 0 else offset)
        for i, t in enumerate(_warp_case(b, k, r, w, c)))
    assert IW.aligned(src) == int(src_offset == 0)
    assert IW.aligned(tgt, sx, sy, gi, gl) == int(offset == 0)
    for target in (None, tgt):
        x, y = sx.clone().requires_grad_(), sy.clone().requires_grad_()
        xr, yr = sx.clone().requires_grad_(), sy.clone().requires_grad_()
        kernels = BORDER if target is None else L1
        before = _launches(*kernels)
        if target is None:
            got = (IW.warp_images_border(src, _view_at(x, offset),
                                         _view_at(y, offset)),)
            want = (IW.warp_images_border_reference(src, xr, yr),)
            cot = (gi,)
        else:
            got = IW.warp_images_border(src, _view_at(x, offset),
                                        _view_at(y, offset), target=target)
            want = IW.warp_images_border_l1_reference(src, xr, yr, target)
            cot = (gi, gl)
        torch.autograd.backward(got, cot)
        torch.autograd.backward(want, cot)
        grown = _grown(before, *kernels)
        torch.cuda.synchronize()
        assert grown == (1, 1)
        assert torch.equal(got[0], want[0])
        pairs = [(x.grad, xr.grad), (y.grad, yr.grad)]
        if target is not None:
            pairs.append((got[1], want[1]))
            ties = slice(max(min(6, r * w), r * w - 8), r * w)
            assert torch.count_nonzero(
                got[1].view(b, k, -1)[:, :, ties]).item() == 0
        for a, want_a in pairs:
            assert torch.all((a - want_a).abs()
                             <= 1e-5 * want_a.abs().max()), case


def test_kernel_variants_full_is_the_shipped_kernel(device):
    """The stage ablations build and run; ``full`` equals sweep_warp_corr
    bit for bit, and the others differ from it (wrong by design)."""
    from movedepth_tpu_torch import profile_kernel_variants as PKV
    inputs = PKV.shipped_inputs(batch=2)
    shipped = SW.sweep_warp_corr(*inputs, 16)
    outs = {name: PKV.run_variant(name, *inputs) for name in PKV.VARIANTS}
    torch.cuda.synchronize()
    assert torch.equal(outs["full"], shipped)
    for name, out in outs.items():
        assert torch.isfinite(out.float()).all(), name
        assert name == "full" or not torch.equal(out, shipped), name


def test_train_step_kernel_l1_card_matches_cpu(device):
    """kernel_l1 on the card: the L1 epilogue kernel runs (2 forward and 2
    backward launches, the plain border warp none) and the losses equal
    the CPU step's within 1e-3 and the card's kernel_l1=False step's
    within 1e-5."""
    from movedepth_tpu_torch.train import state as S
    cfg = Config(height=64, width=96, compute_dtype="float32",
                 kernel_l1=True)
    models = build_models(cfg, "cpu")
    with torch.no_grad():
        for p in models["pose"].net[3].parameters():
            p.mul_(40.0)
    batch = P.synthetic_batch(cfg, 2, seed=11, device="cpu")
    draws = P.sample_draws(cfg, 2, torch.Generator().manual_seed(5),
                           device="cpu")
    gpu_batch = {k: v.to(device) for k, v in batch.items()}
    gpu_draws = {"box": draws["box"],
                 "noise": [n.to(device) for n in draws["noise"]]}

    def step(step_cfg, step_models, step_batch, step_draws):
        opt, sched = S.create_optimizer(step_models, step_cfg)
        return S.train_step(step_models, opt, sched, step_batch, step_cfg,
                            False, step_draws)[0]

    want = step(cfg, copy.deepcopy(models), batch, draws)
    counts = _launches(*BORDER, *L1)
    got = step(cfg, {k: copy.deepcopy(m).to(device)
                     for k, m in models.items()}, gpu_batch, gpu_draws)
    assert _grown(counts, *BORDER, *L1) == (0, 0, 2, 2)
    off = step(cfg.replace(kernel_l1=False),
               {k: copy.deepcopy(m).to(device) for k, m in models.items()},
               gpu_batch, gpu_draws)
    for k in want:
        np.testing.assert_allclose(got[k].item(), want[k].item(), rtol=1e-3,
                                   err_msg=k)
        np.testing.assert_allclose(got[k].item(), off[k].item(), rtol=1e-5,
                                   err_msg=k)


def _grad_rel(models, ref_models):
    """Per model: relative L2 distance of the parameters' .grad."""
    out = {}
    for name, ref in ref_models.items():
        pairs = [(a.grad.cpu(), b.grad) for a, b in
                 zip(models[name].parameters(), ref.parameters())]
        num = sum(float((a - b).norm() ** 2) for a, b in pairs)
        den = sum(float(b.norm() ** 2) for _, b in pairs)
        out[name] = (num / den) ** 0.5
    return out


def test_train_step_card_matches_cpu(device):
    """One train step of the port on the card (through the kernels) against
    the same step on the CPU (through the plain versions), float32, 64x96:
    the kernel launches of one step, every loss within 1e-3, and every
    model's gradient within 5e-3 or twice the spread the CPU shows between
    1 thread and all of them, whichever is larger (a float32 gradient of
    this step is fixed only up to the order of its sums)."""
    from movedepth_tpu_torch.train import state as S
    cfg = Config(height=64, width=96, compute_dtype="float32")
    models = build_models(cfg, "cpu")
    with torch.no_grad():  # a few-pixel motion: no automask near-ties
        for p in models["pose"].net[3].parameters():
            p.mul_(40.0)
    batch = P.synthetic_batch(cfg, 2, seed=11, device="cpu")
    draws = P.sample_draws(cfg, 2, torch.Generator().manual_seed(5),
                           device="cpu")
    gpu_models = {k: copy.deepcopy(m).to(device) for k, m in models.items()}
    one_thread = {k: copy.deepcopy(m) for k, m in models.items()}

    def step(step_models, step_batch, step_draws):
        opt, sched = S.create_optimizer(step_models, cfg)
        return S.train_step(step_models, opt, sched, step_batch, cfg, False,
                            step_draws)[0]

    want = step(models, batch, draws)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        step(one_thread, batch, draws)
    finally:
        torch.set_num_threads(threads)
    counts = _launches(*SWEEP, *BORDER)
    got = step(gpu_models, {k: v.to(device) for k, v in batch.items()},
               {"box": draws["box"],
                "noise": [n.to(device) for n in draws["noise"]]})
    assert _grown(counts, *SWEEP, *BORDER) == (1, 1, 2, 2)
    for k in want:
        np.testing.assert_allclose(got[k].item(), want[k].item(), rtol=1e-3,
                                   err_msg=k)
    spreads = _grad_rel(one_thread, models)
    for name, gap in _grad_rel(gpu_models, models).items():
        assert gap <= max(5e-3, 2.0 * spreads[name]), (name, gap, spreads)


def test_forward_infer_fused_card_matches_cpu(device):
    """The main path on the card (through the kernel) against the same
    port on the CPU (through the plain version), float32, 64x96."""
    cfg = Config(height=64, width=96, compute_dtype="float32")
    models = build_models(cfg, "cpu")
    batch = P.synthetic_batch(cfg, 2, seed=11, device="cpu")
    want = P.forward_infer_fused(models, batch, cfg)
    models = {k: m.to(device) for k, m in models.items()}
    before = _launches("sweep_warp_corr")
    got = P.forward_infer_fused(
        models, {k: v.to(device) for k, v in batch.items()}, cfg)
    assert _launches("sweep_warp_corr") == before + 1
    for key in ("disp_mono", "cost_prob", "trust_mono"):
        np.testing.assert_allclose(got[key].cpu().numpy(),
                                   want[key].numpy(), rtol=1e-4, atol=1e-5)
    rel = ((got["depth_mvs"].cpu() - want["depth_mvs"]).abs()
           / want["depth_mvs"].abs())
    assert rel.mean().item() <= 6e-3


@pytest.mark.parametrize("prior_scale,groups", [(2, 2), (3, 64)])
def test_forward_infer_fused_card_matches_cpu_group_configs(device,
                                                            prior_scale,
                                                            groups):
    """The main path at reg3d_c = 2 (C = 32) and at prior_scale = 3 with
    reg3d_c = 64 (C = 64), batch 1, 8 bins: the card against the CPU."""
    cfg = Config(height=64, width=128, compute_dtype="float32",
                 prior_scale=prior_scale, reg3d_c=groups, num_depth_bins=8)
    models = build_models(cfg, "cpu")
    batch = P.synthetic_batch(cfg, 1, seed=11, device="cpu")
    want = P.forward_infer_fused(models, batch, cfg)
    models = {k: m.to(device) for k, m in models.items()}
    before = _launches("sweep_warp_corr")
    got = P.forward_infer_fused(
        models, {k: v.to(device) for k, v in batch.items()}, cfg)
    assert _launches("sweep_warp_corr") == before + 1
    for key in ("disp_mono", "cost_prob", "trust_mono"):
        np.testing.assert_allclose(got[key].cpu().numpy(),
                                   want[key].numpy(), rtol=1e-4, atol=1e-5)
    rel = ((got["depth_mvs"].cpu() - want["depth_mvs"]).abs()
           / want["depth_mvs"].abs())
    assert rel.mean().item() <= 6e-3


def _eval_tree(root, lines=3):
    """4 frames of one drive and an eigen test list of frames 1..lines,
    each with its previous frame."""
    from PIL import Image
    drive = "2011_09_26/2011_09_26_drive_0002_sync"
    img_dir = root / drive / "image_02" / "data"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(1)
    for i in range(lines + 1):
        small = rng.uniform(0, 255, (8, 12, 3))
        Image.fromarray(np.repeat(np.repeat(small, 8, 0), 8, 1)
                        .astype(np.uint8)).save(img_dir / f"{i:010d}.jpg")
    split_dir = root / "eigen"
    split_dir.mkdir()
    (split_dir / "test_files.txt").write_text(
        "\n".join(f"{drive} {i} l" for i in range(1, lines + 1)))
    return str(root), str(split_dir)


def test_predict_disparities_card_matches_cpu(device, tmp_path):
    """The evaluation's forwards at batch 2 with the flipped second pass
    (3 lines: a full batch and a partial one), float32, 64x96: the card
    against the CPU, and 2 kernel launches per batch."""
    from movedepth_tpu_torch.eval import evaluate as E
    data, split_dir = _eval_tree(tmp_path)
    cfg = Config(height=64, width=96, num_depth_bins=8,
                 compute_dtype="float32", post_process=True)
    models = build_models(cfg, "cpu")
    want = E.predict_disparities(models, cfg, data, split_dir, 2,
                                 num_workers=2, device="cpu")
    models = {k: m.to(device) for k, m in models.items()}
    before = _launches("sweep_warp_corr")
    got = E.predict_disparities(models, cfg, data, split_dir, 2,
                                num_workers=2, device=device)
    assert _launches("sweep_warp_corr") - before == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape == (3, 64, 96)
    # the gates of test_forward_infer_fused_card_matches_cpu
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-5)
    for g, w, name in zip(got[1:], want[1:], ("mvs", "fused")):
        assert (np.abs(g - w) / np.abs(w)).mean() <= 6e-3, name


def test_cli_evaluate_launches_on_card(device, tmp_path, capsys):
    """One run of the evaluation CLI on the card at batch 1: one kernel
    launch per line, printed by the CLI, and four finite tables."""
    import re
    from movedepth_tpu_torch.cli import evaluate as cli
    data, split_dir = _eval_tree(tmp_path)
    gt = np.empty(3, dtype=object)
    for i in range(3):
        gt[i] = np.random.default_rng(i).uniform(5, 60, (96, 320)).astype(
            np.float32)
    np.savez_compressed(tmp_path / "eigen" / "gt_depths.npz", data=gt)
    cfg = Config(height=64, width=96, num_depth_bins=8)
    weights = tmp_path / "weights"
    weights.mkdir()
    for name, m in build_models(cfg, "cpu").items():
        torch.save(m.state_dict(), weights / f"{name}.pth")
    before = _launches("sweep_warp_corr")
    results = cli.main(["--data_path", data, "--load_weights_folder",
                        str(weights), "--splits_dir", str(tmp_path),
                        "--height", "64", "--width", "96",
                        "--num_depth_bins", "8", "--batch_size", "1",
                        "--num_workers", "2"])
    out = capsys.readouterr().out
    assert _launches("sweep_warp_corr") - before == 3
    assert 'kernel launches: {"sweep_warp_corr": 3}' in out
    assert re.findall(r"(\w+) results:", out) == ["mono", "mvs", "fused",
                                                  "upbound"]
    for name, row in results.items():
        assert np.isfinite(row).all(), name


@pytest.fixture
def gloo_group(device, tmp_path, monkeypatch):
    """A world-1 gloo process group holding CUDA tensors (file://
    rendezvous), left again after the test."""
    from movedepth_tpu_torch.parallel import dist as D
    for key, value in (("RANK", "0"), ("WORLD_SIZE", "1"),
                       ("LOCAL_RANK", "0")):
        monkeypatch.setenv(key, value)
    D.initialize_distributed("cuda", backend="gloo",
                             init_method=f"file://{tmp_path / 'rdzv'}")
    yield D.default_group()
    torch.distributed.destroy_process_group()


def test_sync_batchnorm_bf16_autocast_matches_batchnorm(gloo_group):
    """Under bfloat16 autocast at world 1 the synchronized BatchNorm
    returns bfloat16, as nn.BatchNorm does there, and agrees with it in
    output within a bf16 step (1e-2), in the input gradient (through a
    bf16 conv) and the weight and bias gradients within 1e-2 relative L2
    (nn.BatchNorm's bf16 backward rounds to bf16 inside: its weight
    gradient lay 2.7e-3 from the float32 one on the card), and in the
    running statistics within 1e-5."""
    from movedepth_tpu_torch.parallel.sync_bn import (SyncBatchNorm,
                                                      convert_sync_batchnorm)
    gen = torch.Generator("cuda").manual_seed(0)
    conv = torch.nn.Conv2d(8, 16, 3, padding=1).cuda()
    x = torch.randn(4, 8, 24, 32, device="cuda", generator=gen) * 2 + 1
    g = torch.randn(4, 16, 24, 32, device="cuda", generator=gen)
    plain = torch.nn.BatchNorm2d(16).cuda()
    synced = convert_sync_batchnorm(
        {"m": torch.nn.Sequential(copy.deepcopy(plain))}, gloo_group)["m"]
    assert isinstance(synced[0], SyncBatchNorm)
    out = []
    for bn in (plain, synced):
        xin = x.clone().requires_grad_(True)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            y = bn(conv(xin))
        assert y.dtype == torch.bfloat16
        (y.float() * g).sum().backward()
        out.append((y.float(), xin.grad))
    (ya, dxa), (yb, dxb) = out
    torch.testing.assert_close(yb, ya, rtol=1e-2, atol=1e-2)
    assert float((dxb - dxa).norm() / dxa.norm()) <= 1e-2
    sb = synced[0]
    for a, b in ((plain.weight.grad, sb.weight.grad),
                 (plain.bias.grad, sb.bias.grad)):
        assert float((a - b).norm() / a.norm()) <= 1e-2
    torch.testing.assert_close(sb.running_mean, plain.running_mean,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sb.running_var, plain.running_var,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dim", [2, 3])
def test_sync_batchnorm_float32_matches_batchnorm(gloo_group, dim):
    """In float32 at world 1 the synchronized BatchNorm's card kernels
    (batch_norm_stats, _elemt and the backward's _reduce and _elemt)
    agree with nn.BatchNorm within 1e-5 in output, input, weight and bias
    gradients and running statistics, for 4D and 5D inputs."""
    from movedepth_tpu_torch.parallel.sync_bn import convert_sync_batchnorm
    gen = torch.Generator("cuda").manual_seed(dim)
    shape = (4, 16, 12, 20) + (6,) * (dim - 2)
    x = torch.randn(shape, device="cuda", generator=gen) * 3 + 2
    g = torch.randn(shape, device="cuda", generator=gen)
    plain = (torch.nn.BatchNorm2d if dim == 2 else torch.nn.BatchNorm3d)(
        16).cuda()
    with torch.no_grad():
        plain.weight.uniform_(0.5, 1.5, generator=gen)
        plain.bias.uniform_(-1, 1, generator=gen)
    synced = convert_sync_batchnorm(
        {"m": torch.nn.Sequential(copy.deepcopy(plain))}, gloo_group)["m"]
    out = []
    for bn in (plain, synced):
        xin = x.clone().requires_grad_(True)
        y = bn(xin)
        (y * g).sum().backward()
        out.append((y, xin.grad))
    sb = synced[0]
    for got, want in ((out[1][0], out[0][0]), (out[1][1], out[0][1]),
                      (sb.weight.grad, plain.weight.grad),
                      (sb.bias.grad, plain.bias.grad),
                      (sb.running_mean, plain.running_mean),
                      (sb.running_var, plain.running_var)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_all_reduce_grads_on_the_card(gloo_group):
    """The gradient all-reduce and the broadcast on CUDA tensors at world
    1: gradients unchanged (averaged over one rank), a missing gradient
    left None, parameters unchanged."""
    from movedepth_tpu_torch.parallel import dist as D
    gen = torch.Generator("cuda").manual_seed(1)
    models = {"a": torch.nn.Linear(5, 3).cuda(),
              "b": torch.nn.Linear(3, 2).cuda()}
    before = {k: [p.detach().clone() for p in m.parameters()]
              for k, m in models.items()}
    models["a"](torch.randn(7, 5, device="cuda", generator=gen)).sum() \
        .backward()
    grads = [p.grad.clone() for p in models["a"].parameters()]
    D.broadcast_models(models, gloo_group)
    D.all_reduce_grads(models, gloo_group)
    assert all(torch.equal(p.grad, g)
               for p, g in zip(models["a"].parameters(), grads))
    assert all(p.grad is None for p in models["b"].parameters())
    for k, m in models.items():
        assert all(torch.equal(p, q) for p, q in zip(m.parameters(),
                                                     before[k]))


def _multistep_setup(device, **kw):
    cfg = Config(height=64, width=96, num_depth_bins=8,
                 compute_dtype="float32", kernel_l1=True, **kw)
    models = build_models(cfg, "cpu", torch.Generator().manual_seed(0))
    with torch.no_grad():  # a few-pixel motion: no automask near-ties
        for p in models["pose"].net[3].parameters():
            p.mul_(40.0)
    gen = torch.Generator(device).manual_seed(0)
    batches = [P.synthetic_batch(cfg, 2, seed=s, device=device)
               for s in (1, 2)]
    draws = [P.sample_draws(cfg, 2, gen, device) for _ in batches]
    return cfg, models, batches, draws


def test_multistep_graph_matches_eager_steps(device):
    """steps_per_dispatch on the card: one dispatch of 2 replays of the
    captured step against 2 eager train_steps from one state (float32,
    64x96, 8 bins, kernel_l1): step 1's losses within 1e-5 relative, step
    2's total loss within 5e-3 and the parameters after both within rtol
    5e-2 / atol 1e-3 (the JAX test's loose tier: row 3's atomics sum in
    another order on every run); Adam is capturable; a second dispatch
    counts its launches per replay (the wrappers' counters do not run in
    a replay); the gradients left in .grad are the graph's."""
    from movedepth_tpu_torch.train import state as S
    cfg, cpu_models, batches, draws = _multistep_setup(device)
    runs = {}
    for graphed in (False, True):
        models = {k: copy.deepcopy(m).to(device)
                  for k, m in cpu_models.items()}
        opt, sched = S.create_optimizer(models, cfg)
        assert all(g["capturable"] for g in opt.param_groups)
        if graphed:
            multi = S.make_train_multistep(models, opt, sched, cfg)
            losses = multi(batches, draws, True)
        else:
            steps = [S.train_step(models, opt, sched, b, cfg, True, d)[0]
                     for b, d in zip(batches, draws)]
            losses = {k: torch.stack([s[k] for s in steps])
                      for k in steps[0]}
        assert sched.last_epoch == 2
        runs[graphed] = (losses, models)
    (want, eager), (got, models) = runs[False], runs[True]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k][0].item(), want[k][0].item(),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["loss"][1].item(), want["loss"][1].item(),
                               rtol=5e-3)
    for name in eager:
        for a, b in zip(models[name].parameters(),
                        eager[name].parameters()):
            torch.testing.assert_close(a, b, rtol=5e-2, atol=1e-3)
    counts = _launches(*SWEEP, *L1)
    graph = multi.graphs[True]
    multi(batches, draws, True)
    torch.cuda.synchronize()
    assert _grown(counts, *SWEEP, *L1) == (2, 2, 4, 4)
    assert all(p.grad is g for p, g in zip(graph.params, graph.grads))


@pytest.mark.parametrize("written", ["cpu", "cuda"])
def test_multistep_resumes_from_either_device(device, written, tmp_path):
    """A resume on the card from an ``adam.pth`` written by a step on the
    CPU (groups not capturable, the step counts on the host) or on the
    card, then a dispatch of 2 graphed steps against 2 eager steps from
    the same resume: Adam is capturable again with its step counts on the
    card, step 1's losses within 1e-5 relative, step 2's total loss within
    5e-3 (the tiers of test_multistep_graph_matches_eager_steps)."""
    from movedepth_tpu_torch.train import checkpoints as C
    from movedepth_tpu_torch.train import state as S
    cfg, cpu_models, batches, draws = _multistep_setup(device)
    models = {k: copy.deepcopy(m).to(written) for k, m in cpu_models.items()}
    opt, sched = S.create_optimizer(models, cfg)
    draw = {"box": tuple(t.to(written) for t in draws[0]["box"]),
            "noise": [n.to(written) for n in draws[0]["noise"]]}
    S.train_step(models, opt, sched, {k: v.to(written) for k, v in
                                      batches[0].items()}, cfg, True, draw)
    folder = C.save_checkpoint(str(tmp_path), models, opt, sched, 1, cfg,
                               last=True)
    runs = {}
    for graphed in (False, True):
        resumed = {k: copy.deepcopy(m).to(device) for k, m in models.items()}
        ropt, rsched = S.create_optimizer(resumed, cfg)
        rsched.set_step(C.load_optimizer(folder, ropt, device))
        assert all(g["capturable"] for g in ropt.param_groups)
        assert all(s["step"].device.type == "cuda"
                   for s in ropt.state.values())
        if graphed:
            runs[graphed] = S.make_train_multistep(resumed, ropt, rsched,
                                                   cfg)(batches, draws, True)
        else:
            steps = [S.train_step(resumed, ropt, rsched, b, cfg, True, d)[0]
                     for b, d in zip(batches, draws)]
            runs[graphed] = {k: torch.stack([s[k] for s in steps])
                             for k in steps[0]}
        assert rsched.last_epoch == 3
    got, want = runs[True], runs[False]
    for k in want:
        np.testing.assert_allclose(got[k][0].item(), want[k][0].item(),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["loss"][1].item(), want["loss"][1].item(),
                               rtol=5e-3)


def test_capturable_adam_matches_float_adam(device):
    """The card's Adam (capturable, a tensor rate a group written in place
    by the schedule) against torch's default Adam with float rates under
    MultiStepLR, across two milestones: the same rates, and parameters
    within float32 rounding of the bias corrections."""
    from movedepth_tpu_torch.train import state as S
    cfg = Config(num_epochs=6, scheduler_step_size=2, lr_fac=0.5)
    gen = torch.Generator().manual_seed(0)
    models = {"mono_encoder": torch.nn.Linear(5, 3).to(device),
              "reg3d": torch.nn.Linear(5, 3).to(device)}
    ref = copy.deepcopy(models)
    opt, sched = S.create_optimizer(models, cfg, steps_per_epoch=3)
    ref_opt = torch.optim.Adam(
        [{"params": list(ref["mono_encoder"].parameters()),
          "lr": cfg.learning_rate},
         {"params": list(ref["reg3d"].parameters()),
          "lr": cfg.learning_rate * cfg.lr_fac}], eps=1e-8)
    ref_sched = torch.optim.lr_scheduler.MultiStepLR(
        ref_opt, S.lr_milestones(cfg, 3), gamma=0.1)
    for _ in range(14):
        x = torch.randn(4, 5, generator=gen).to(device)
        for ms, o in ((models, opt), (ref, ref_opt)):
            o.zero_grad()
            sum(m(x).square().sum() for m in ms.values()).backward()
            o.step()
        sched.step()
        ref_sched.step()
        np.testing.assert_allclose(
            [float(g["lr"]) for g in opt.param_groups],
            ref_sched.get_last_lr(), rtol=1e-6)
        for a, b in zip(models.values(), ref.values()):
            for p, q in zip(a.parameters(), b.parameters()):
                torch.testing.assert_close(p, q, rtol=1e-5, atol=1e-7)


def test_multistep_refuses_gloo_on_the_card(gloo_group):
    """gloo collectives cannot be captured: steps_per_dispatch > 1 with a
    gloo group on the card raises, rather than taking eager steps."""
    from movedepth_tpu_torch.train import state as S
    cfg, cpu_models, _, _ = _multistep_setup("cuda")
    models = {k: m.cuda() for k, m in cpu_models.items()}
    opt, sched = S.create_optimizer(models, cfg)
    with pytest.raises(ValueError, match="nccl"):
        S.make_train_multistep(models, opt, sched, cfg, gloo_group)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_on_the_card_matches_live_forward(device, dtype, tmp_path):
    """cli/export_model on the card (64x96, 8 bins): the saved and loaded
    MVS program launches the cost-volume kernel once a call and gives the
    live forward's outputs (bfloat16: its autocast regions are part of
    the program)."""
    from movedepth_tpu_torch.cli import export_model as EM
    cfg = Config(height=64, width=96, num_depth_bins=8, compute_dtype=dtype)
    models = build_models(cfg, device)
    program = EM.build_export(cfg, models, False, 2, device)
    torch.export.save(program, tmp_path / "p.pt2")
    loaded = torch.export.load(tmp_path / "p.pt2").module()
    inputs = EM.example_inputs(cfg, False, 2, device)
    with torch.no_grad():
        before = _launches("sweep_warp_corr")
        got = loaded(*inputs)
        torch.cuda.synchronize()
        assert _launches("sweep_warp_corr") == before + 1
        want = EM.ServingForward(models, cfg, False)(*inputs)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 64, 96)
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
